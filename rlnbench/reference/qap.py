"""The CircomReduction witness map in plain Python integers.

For the assignment z: a and b are the A and B constraint rows evaluated on
z, a takes the public inputs z[0..num_inputs) on the rows after the
constraints, c = a * b row by row, and on the size-n domain (n the power of
two at or above the rows)

    h = coset(a) * coset(b) - coset(c),  coset(x) = fft(distribute_powers(ifft(x), w_2n))

with w_2n the generator of the size-2n domain: the evaluations on the odd
coset that circom's h query is built for (ark-circom CircomReduction,
ark-poly Radix2EvaluationDomain).
"""

from __future__ import annotations

from typing import List, Sequence

from .constants import FR_TWO_ADICITY, FR_TWO_ADIC_ROOT, R


def domain_size(rows: int) -> int:
    n = 1
    while n < rows:
        n *= 2
    return n


def domain_generator(n: int) -> int:
    log_n = n.bit_length() - 1
    return pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), R)


def _ntt(values: Sequence[int], omega: int) -> List[int]:
    """Evaluations of the polynomial with these coefficients at omega^0..n-1:
    bit-reversal, then radix-2 decimation-in-time stages."""
    n = len(values)
    log_n = n.bit_length() - 1
    a = [0] * n
    for i, v in enumerate(values):
        a[int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0] = v
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), R)
        tw = [1] * m
        for j in range(1, m):
            tw[j] = tw[j - 1] * w_m % R
        for k in range(0, n, 2 * m):
            for j in range(m):
                t = tw[j] * a[k + j + m] % R
                u = a[k + j]
                a[k + j] = (u + t) % R
                a[k + j + m] = (u - t) % R
        m *= 2
    return a


def fft(values: Sequence[int]) -> List[int]:
    return _ntt(values, domain_generator(len(values)))


def ifft(values: Sequence[int]) -> List[int]:
    n = len(values)
    n_inv = pow(n, -1, R)
    return [v * n_inv % R for v in _ntt(values, pow(domain_generator(n), -1, R))]


def coset(values: Sequence[int], root: int) -> List[int]:
    coeffs = ifft(values)
    acc = 1
    for i in range(len(coeffs)):
        coeffs[i] = coeffs[i] * acc % R
        acc = acc * root % R
    return fft(coeffs)


def _rows(matrix, z: Sequence[int], n: int) -> List[int]:
    out = [0] * n
    for i, row in enumerate(matrix):
        out[i] = sum(coeff * z[wire] for coeff, wire in row) % R
    return out


def witness_map(matrices, z: Sequence[int]) -> List[int]:
    """h, the scalars of the h query, for the full assignment z."""
    n_cons = matrices.num_constraints
    n_inputs = matrices.num_instance_variables
    n = domain_size(n_cons + n_inputs)
    a = _rows(matrices.a, z, n)
    b = _rows(matrices.b, z, n)
    for j in range(n_inputs):
        a[n_cons + j] = z[j] % R
    c = [x * y % R for x, y in zip(a, b)]
    root = domain_generator(2 * n)
    ca, cb, cc = coset(a, root), coset(b, root), coset(c, root)
    return [(x * y - w) % R for x, y, w in zip(ca, cb, cc)]
