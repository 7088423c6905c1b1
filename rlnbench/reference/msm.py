"""Multi-scalar multiplication over BN254 G1 and G2 in plain Python integers.

The bucket method (Pippenger) in Jacobian coordinates: for each window of c
bits, from the top, the accumulator is doubled c times, every affine base
whose digit is nonzero is added into its bucket (mixed addition), and the
buckets are summed as sum_d d * bucket[d] by a running sum. Both curves
have a = 0. Affine points are (x, y) with None for infinity; G2
coordinates are pairs (c0, c1) over Fq2 = Fq[u]/(u^2 + 1).

`scalar_mask` keeps only the scalar bits it names. The benchmark's control
passes (1 << 248) - 1: the proof with each scalar's top byte dropped.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .constants import Q, R

P = Q
SCALAR_BITS = 254
INF1 = (0, 1, 0)
INF2 = ((0, 0), (1, 0), (0, 0))


# -- G1 ---------------------------------------------------------------------


def g1_dbl(X1, Y1, Z1):
    if Z1 == 0:
        return INF1
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) ** 2 - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return X3, Y3, Z3


def g1_madd(X1, Y1, Z1, x2, y2):
    """Jacobian + affine (madd-2007-bl)."""
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 % P * Z1Z1 % P
    H = (U2 - X1) % P
    rr = 2 * (S2 - Y1) % P
    if H == 0:
        return g1_dbl(X1, Y1, Z1) if rr == 0 else INF1
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) ** 2 - Z1Z1 - HH) % P
    return X3, Y3, Z3


def g1_add(X1, Y1, Z1, X2, Y2, Z2):
    """Jacobian + Jacobian (add-2007-bl)."""
    if Z1 == 0:
        return X2, Y2, Z2
    if Z2 == 0:
        return X1, Y1, Z1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    H = (U2 - U1) % P
    rr = 2 * (S2 - S1) % P
    if H == 0:
        return g1_dbl(X1, Y1, Z1) if rr == 0 else INF1
    I = (2 * H) ** 2 % P
    J = H * I % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) ** 2 - Z1Z1 - Z2Z2) * H % P
    return X3, Y3, Z3


def g1_affine(pt):
    X, Y, Z = pt
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


# -- G2 ---------------------------------------------------------------------


def _m(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def _s(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def _add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _k(a, k):
    return (a[0] * k % P, a[1] * k % P)


def _zero(a):
    return a[0] == 0 and a[1] == 0


def g2_dbl(X1, Y1, Z1):
    if _zero(Z1):
        return INF2
    A = _s(X1)
    B = _s(Y1)
    C = _s(B)
    D = _k(_sub(_sub(_s(_add(X1, B)), A), C), 2)
    E = _k(A, 3)
    F = _s(E)
    X3 = _sub(F, _k(D, 2))
    Y3 = _sub(_m(E, _sub(D, X3)), _k(C, 8))
    Z3 = _k(_m(Y1, Z1), 2)
    return X3, Y3, Z3


def g2_madd(X1, Y1, Z1, x2, y2):
    if _zero(Z1):
        return x2, y2, (1, 0)
    Z1Z1 = _s(Z1)
    U2 = _m(x2, Z1Z1)
    S2 = _m(_m(y2, Z1), Z1Z1)
    H = _sub(U2, X1)
    rr = _k(_sub(S2, Y1), 2)
    if _zero(H):
        return g2_dbl(X1, Y1, Z1) if _zero(rr) else INF2
    HH = _s(H)
    I = _k(HH, 4)
    J = _m(H, I)
    V = _m(X1, I)
    X3 = _sub(_sub(_s(rr), J), _k(V, 2))
    Y3 = _sub(_m(rr, _sub(V, X3)), _k(_m(Y1, J), 2))
    Z3 = _sub(_sub(_s(_add(Z1, H)), Z1Z1), HH)
    return X3, Y3, Z3


def g2_add(X1, Y1, Z1, X2, Y2, Z2):
    if _zero(Z1):
        return X2, Y2, Z2
    if _zero(Z2):
        return X1, Y1, Z1
    Z1Z1 = _s(Z1)
    Z2Z2 = _s(Z2)
    U1 = _m(X1, Z2Z2)
    U2 = _m(X2, Z1Z1)
    S1 = _m(_m(Y1, Z2), Z2Z2)
    S2 = _m(_m(Y2, Z1), Z1Z1)
    H = _sub(U2, U1)
    rr = _k(_sub(S2, S1), 2)
    if _zero(H):
        return g2_dbl(X1, Y1, Z1) if _zero(rr) else INF2
    I = _s(_k(H, 2))
    J = _m(H, I)
    V = _m(U1, I)
    X3 = _sub(_sub(_s(rr), J), _k(V, 2))
    Y3 = _sub(_m(rr, _sub(V, X3)), _k(_m(S1, J), 2))
    Z3 = _m(_sub(_sub(_s(_add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return X3, Y3, Z3


def g2_affine(pt):
    X, Y, Z = pt
    if _zero(Z):
        return None
    norm = (Z[0] * Z[0] + Z[1] * Z[1]) % P
    ninv = pow(norm, -1, P)
    zi = (Z[0] * ninv % P, (-Z[1]) * ninv % P)
    zi2 = _s(zi)
    return (_m(X, zi2), _m(_m(Y, zi2), zi))


# -- the bucket method --------------------------------------------------------

_G1 = (INF1, g1_dbl, g1_madd, g1_add, g1_affine)
_G2 = (INF2, g2_dbl, g2_madd, g2_add, g2_affine)


def msm(points: Sequence, scalars: Sequence[int], g2: bool = False, c: int = 9,
        scalar_mask: Optional[int] = None):
    """sum_i scalars[i] * points[i] as an affine point (None for infinity)."""
    inf, dbl, madd, add, affine = _G2 if g2 else _G1
    pairs = []
    for pt, k in zip(points, scalars):
        k %= R
        if scalar_mask is not None:
            k &= scalar_mask
        if pt is not None and k:
            pairs.append((pt[0], pt[1], k))
    mask = (1 << c) - 1
    total = inf
    for w in range((SCALAR_BITS + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            total = dbl(*total)
        buckets = [inf] * (mask + 1)
        shift = w * c
        for x, y, k in pairs:
            d = (k >> shift) & mask
            if d:
                buckets[d] = madd(*buckets[d], x, y)
        running = inf
        acc = inf
        for d in range(mask, 0, -1):
            running = add(*running, *buckets[d])
            acc = add(*acc, *running)
        total = add(*total, *acc)
    return affine(total)


def mul(point, k: int, g2: bool = False):
    """k * point for one affine point."""
    return msm([point], [k], g2=g2, c=4)


def sum_points(points: Sequence, g2: bool = False):
    """The sum of affine points (None entries are infinity)."""
    inf, _, madd, _, affine = _G2 if g2 else _G1
    acc = inf
    for pt in points:
        if pt is not None:
            acc = madd(*acc, *pt)
    return affine(acc)
