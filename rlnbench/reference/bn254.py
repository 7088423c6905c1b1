"""Self-contained BN254 (alt_bn128) host-side math: Fq/Fq2/Fq12, G1/G2, ate pairing.

This module is the framework's host-side verification backbone. The reference
delegates all of this to arkworks (ark-bn254 / ark-ec); here it is implemented
from the published curve parameters in plain Python integers. It is used for:
  * Groth16 proof verification (pairing check) — reference behavior:
    rln/src/protocol/proof.rs:856-894 via ark-groth16 verify_proof,
  * parity-testing the TPU limb kernels against an independent implementation,
  * loading/serializing curve points (see arkserde.py).

Not a hot path: batched proving runs on TPU; this is correctness-critical glue.
"""

from __future__ import annotations

from .constants import B_G2, BN_X, G1_GEN, G2_GEN_X, G2_GEN_Y, Q, R

# ---------------------------------------------------------------------------
# Fq and Fq2 arithmetic (plain ints / pairs of ints)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, -1, Q)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_mul_scalar(a, k: int):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = fq_inv(norm)
    return ((a[0] * ninv) % Q, ((-a[1]) * ninv) % Q)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)


# ---------------------------------------------------------------------------
# Curve groups. Affine points are (x, y) with None = point at infinity.
# G1 coordinates are ints; G2 coordinates are Fq2 pairs.
# ---------------------------------------------------------------------------


class _CurveOps:
    """Generic short-Weierstrass affine group law parameterized by field ops."""

    def __init__(self, add, sub, mul, sqr, inv, neg, scalar_mul, zero, b):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.fsqr, self.finv, self.fneg = sqr, inv, neg
        self.fscalar = scalar_mul
        self.fzero = zero
        self.b = b

    def is_on_curve(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        lhs = self.fsqr(y)
        rhs = self.fadd(self.fmul(self.fsqr(x), x), self.b)
        return lhs == rhs

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.fneg(p[1]))

    def double(self, p):
        if p is None:
            return None
        x, y = p
        if y == self.fzero:
            return None
        m = self.fmul(self.fscalar(self.fsqr(x), 3), self.finv(self.fscalar(y, 2)))
        nx = self.fsub(self.fsqr(m), self.fscalar(x, 2))
        ny = self.fsub(self.fmul(m, self.fsub(x, nx)), y)
        return (nx, ny)

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if y1 == y2:
                return self.double(p)
            return None
        m = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        nx = self.fsub(self.fsqr(m), self.fadd(x1, x2))
        ny = self.fsub(self.fmul(m, self.fsub(x1, nx)), y1)
        return (nx, ny)

    def mul(self, p, k: int):
        k %= R
        acc = None
        base = p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.double(base)
            k >>= 1
        return acc

    def msm(self, points, scalars):
        acc = None
        for pt, s in zip(points, scalars):
            acc = self.add(acc, self.mul(pt, s))
        return acc


def _int_ops():
    return _CurveOps(
        add=lambda a, b: (a + b) % Q,
        sub=lambda a, b: (a - b) % Q,
        mul=lambda a, b: (a * b) % Q,
        sqr=lambda a: (a * a) % Q,
        inv=fq_inv,
        neg=lambda a: (-a) % Q,
        scalar_mul=lambda a, k: (a * k) % Q,
        zero=0,
        b=3,
    )


def _fq2_ops():
    return _CurveOps(
        add=fq2_add,
        sub=fq2_sub,
        mul=fq2_mul,
        sqr=fq2_sqr,
        inv=fq2_inv,
        neg=fq2_neg,
        scalar_mul=fq2_mul_scalar,
        zero=FQ2_ZERO,
        b=B_G2,
    )


G1 = _int_ops()
G2 = _fq2_ops()

G1_GENERATOR = G1_GEN
G2_GENERATOR = (G2_GEN_X, G2_GEN_Y)


# ---------------------------------------------------------------------------
# Fq12 as Fq[w] / (w^12 - 18 w^6 + 82), following the standard BN254 tower
# flattening (xi = 9 + u, u = w^6 - 9). Elements are 12-tuples of ints.
# ---------------------------------------------------------------------------

FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12
# w^12 = 18 w^6 - 82
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


def fq12_mul(a, b):
    prod = [0] * 23
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            prod[i + j] += ai * bj
    # reduce degrees 22..12
    for deg in range(22, 11, -1):
        c = prod[deg]
        if c == 0:
            continue
        prod[deg] = 0
        base = deg - 12
        # w^deg = w^base * (18 w^6 - 82)
        prod[base + 6] += 18 * c
        prod[base] -= 82 * c
    return tuple(c % Q for c in prod[:12])


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_scalar(a, k):
    return tuple((c * k) % Q for c in a)


def fq12_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def fq12_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def fq12_neg(a):
    return tuple((-x) % Q for x in a)


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def _poly_degree(p):
    for i in range(len(p) - 1, -1, -1):
        if p[i] % Q:
            return i
    return -1


def fq12_inv(a):
    """Inverse via extended Euclid over Fq[w] against the modulus polynomial."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [c % Q for c in _MOD_COEFFS] + [1]
    while _poly_degree(low) > 0:
        dl, dh = _poly_degree(low), _poly_degree(high)
        if dl > dh:
            low, high = high, low
            lm, hm = hm, lm
            continue
        # high -= (high_lead / low_lead) * w^(dh-dl) * low
        factor = high[dh] * pow(low[dl], -1, Q) % Q
        shift = dh - dl
        for i in range(dl + 1):
            high[i + shift] = (high[i + shift] - factor * low[i]) % Q
        for i in range(len(lm) - shift):
            hm[i + shift] = (hm[i + shift] - factor * lm[i]) % Q
        low, high = high, low
        lm, hm = hm, lm
    # low is now a constant
    inv_const = pow(low[0], -1, Q)
    return tuple(c * inv_const % Q for c in lm[:12])


def fq12_div(a, b):
    return fq12_mul(a, fq12_inv(b))


# ---------------------------------------------------------------------------
# Ate pairing (py_ecc-style formulation: twist G2 into E(Fq12), affine Miller
# loop with line functions over Fq12, one shared final exponentiation).
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = 6 * BN_X + 2
# Miller loop starts below the MSB: the top bit is implicit in R = Q, f = 1.
_LOG_ATE = ATE_LOOP_COUNT.bit_length() - 2

# w and powers used by the twist embedding
_W2 = tuple(1 if i == 2 else 0 for i in range(12))
_W3 = tuple(1 if i == 3 else 0 for i in range(12))


def _twist(pt):
    """Embed a G2 point (over Fq2) into E(Fq12)."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    nx = [0] * 12
    nx[0] = (x0 - 9 * x1) % Q
    nx[6] = x1
    ny = [0] * 12
    ny[0] = (y0 - 9 * y1) % Q
    ny[6] = y1
    return (fq12_mul(tuple(nx), _W2), fq12_mul(tuple(ny), _W3))


def _cast_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (
        tuple(x if i == 0 else 0 for i in range(12)),
        tuple(y if i == 0 else 0 for i in range(12)),
    )


def _f12_double(p):
    x, y = p
    m = fq12_div(fq12_scalar(fq12_sqr(x), 3), fq12_scalar(y, 2))
    nx = fq12_sub(fq12_sqr(m), fq12_scalar(x, 2))
    ny = fq12_sub(fq12_mul(m, fq12_sub(x, nx)), y)
    return (nx, ny)


def _f12_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        return _f12_double(p)
    if x1 == x2:
        return None
    m = fq12_div(fq12_sub(y2, y1), fq12_sub(x2, x1))
    nx = fq12_sub(fq12_sqr(m), fq12_add(x1, x2))
    ny = fq12_sub(fq12_mul(m, fq12_sub(x1, nx)), y1)
    return (nx, ny)


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_div(fq12_sub(y2, y1), fq12_sub(x2, x1))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_div(fq12_scalar(fq12_sqr(x1), 3), fq12_scalar(y1, 2))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def miller_loop(q_pt, p_pt):
    """Miller loop (no final exponentiation). q_pt in G2 (Fq2), p_pt in G1."""
    if q_pt is None or p_pt is None:
        return FQ12_ONE
    qt = _twist(q_pt)
    pt = _cast_g1(p_pt)
    r_pt = qt
    f = FQ12_ONE
    for i in range(_LOG_ATE, -1, -1):
        f = fq12_mul(fq12_sqr(f), _linefunc(r_pt, r_pt, pt))
        r_pt = _f12_double(r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = fq12_mul(f, _linefunc(r_pt, qt, pt))
            r_pt = _f12_add(r_pt, qt)
    q1 = (fq12_pow(qt[0], Q), fq12_pow(qt[1], Q))
    nq2 = (fq12_pow(q1[0], Q), fq12_neg(fq12_pow(q1[1], Q)))
    f = fq12_mul(f, _linefunc(r_pt, q1, pt))
    r_pt = _f12_add(r_pt, q1)
    f = fq12_mul(f, _linefunc(r_pt, nq2, pt))
    return f


_FINAL_EXP = (Q**12 - 1) // R

# -- Frobenius maps on the flattened tower ----------------------------------
# f^(q^k) is Fq-linear: (sum c_i w^i)^(q^k) = sum c_i (w^(q^k))^i, so each
# power reduces to a 12x12 matrix-vector product over Fq. The w^(q^k) bases
# are built once by iterating the k=1 map on w.

import functools as _functools

_W1 = tuple(1 if i == 1 else 0 for i in range(12))


@_functools.lru_cache(maxsize=None)
def _frob_basis(k: int):
    """Tuple of 12 Fq12 elements: (w^(q^k))^i for i = 0..11."""
    if k == 1:
        wq = fq12_pow(_W1, Q)
    else:
        wq = fq12_frobenius(_frob_basis(1)[1], k - 1)
    pows = [FQ12_ONE]
    for _ in range(11):
        pows.append(fq12_mul(pows[-1], wq))
    return tuple(pows)


def fq12_frobenius(f, k: int = 1):
    """f^(q^k) via the precomputed basis (k reduced mod 12)."""
    k %= 12
    if k == 0:
        return f
    basis = _frob_basis(k)
    out = [0] * 12
    for i, c in enumerate(f):
        if c == 0:
            continue
        bi = basis[i]
        for j in range(12):
            if bi[j]:
                out[j] += c * bi[j]
    return tuple(c % Q for c in out)


def _cyclo_conj(f):
    """Inverse in the cyclotomic subgroup: f^(q^6) (valid after easy part)."""
    return fq12_frobenius(f, 6)


def final_exponentiation(f):
    """f^((q^12-1)/r) via easy part (conjugate / inverse / Frobenius) and the
    Scott et al. hard-part addition chain for BN curves (y0..y6 decomposition
    of (q^4 - q^2 + 1)/r in base q with x-power chains). ~20x fewer Fq12
    multiplications than square-and-multiply on the 4500-bit exponent.
    Replaces the arkworks final_exponentiation the reference inherits."""
    # easy part: f^((q^6 - 1)(q^2 + 1))
    f = fq12_mul(fq12_frobenius(f, 6), fq12_inv(f))  # f^(q^6 - 1)
    f = fq12_mul(fq12_frobenius(f, 2), f)  # ^(q^2 + 1); now cyclotomic
    m = f
    # hard part: m^((q^4 - q^2 + 1)/r) = y0 y1^2 y2^6 y3^12 y4^18 y5^30 y6^36
    mx = fq12_pow(m, BN_X)
    mx2 = fq12_pow(mx, BN_X)
    mx3 = fq12_pow(mx2, BN_X)
    y0 = fq12_mul(
        fq12_mul(fq12_frobenius(m, 1), fq12_frobenius(m, 2)), fq12_frobenius(m, 3)
    )
    y1 = _cyclo_conj(m)
    y2 = fq12_frobenius(mx2, 2)
    y3 = _cyclo_conj(fq12_frobenius(mx, 1))
    y4 = _cyclo_conj(fq12_mul(mx, fq12_frobenius(mx2, 1)))
    y5 = _cyclo_conj(mx2)
    y6 = _cyclo_conj(fq12_mul(mx3, fq12_frobenius(mx3, 1)))
    t0 = fq12_sqr(y6)
    t0 = fq12_mul(t0, y4)
    t0 = fq12_mul(t0, y5)
    t1 = fq12_mul(y3, y5)
    t1 = fq12_mul(t1, t0)
    t0 = fq12_mul(t0, y2)
    t1 = fq12_sqr(t1)
    t1 = fq12_mul(t1, t0)
    t1 = fq12_sqr(t1)
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    t0 = fq12_sqr(t0)
    return fq12_mul(t0, t1)


def pairing(q_pt, p_pt):
    """Full ate pairing e(P, Q) with P in G1, Q in G2."""
    return final_exponentiation(miller_loop(q_pt, p_pt))


def multi_pairing_is_one(pairs) -> bool:
    """Checks prod e(P_i, Q_i) == 1 with a single final exponentiation.

    `pairs` is an iterable of (g1_point, g2_point).
    """
    acc = FQ12_ONE
    for p_pt, q_pt in pairs:
        if p_pt is None or q_pt is None:
            continue
        acc = fq12_mul(acc, miller_loop(q_pt, p_pt))
    return final_exponentiation(acc) == FQ12_ONE
