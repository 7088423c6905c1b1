"""Radix-2 NTT host tables over BN254 Fr, and the plain coset lift.

Counterpart of zerokit_tpu/groth16/ntt.py (ark-poly Radix2EvaluationDomain
semantics as used by the CircomReduction witness map, rln/src/circuit/
qap.rs:69-90). The tables are numpy uint32 limb arrays, shared with the
kernels of ff/ntt_kernels.py. coset_lift here is the plain torch version on
the (16, n, *batch) layout; the witness map runs ff/ntt_kernels.coset_lift_bn
on the (16, B, n) layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import FR_TWO_ADICITY, FR_TWO_ADIC_ROOT, R
from ..ff.field import FR, FrPlain


class DomainError(ValueError):
    pass


def domain_size_for(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


@functools.lru_cache(maxsize=None)
def domain_generator(n: int) -> int:
    """Generator of the order-n subgroup (ark Radix2EvaluationDomain::new)."""
    if n & (n - 1):
        raise DomainError("domain size must be a power of two")
    log_n = n.bit_length() - 1
    if log_n > FR_TWO_ADICITY:
        raise DomainError(f"domain 2^{log_n} exceeds two-adicity {FR_TWO_ADICITY}")
    return pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), R)


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    rev = np.zeros(n, dtype=np.int32)
    for i in range(n):
        rev[i] = int(f"{i:0{log_n}b}"[::-1], 2) if log_n else 0
    return rev


def _encode_np(vals) -> np.ndarray:
    return FR.encode(vals).numpy().astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n: int, inverse: bool):
    """Per-stage constant twiddle tables: list over s = 1..log2(n) of
    (16, 2^(s-1)) uint32 Montgomery arrays (w_m^j for j < m, m = 2^(s-1))."""
    g = domain_generator(n)
    if inverse:
        g = pow(g, -1, R)
    out = []
    for s in range(1, n.bit_length()):
        m = 1 << (s - 1)
        w_m = pow(g, n >> s, R)
        tws, acc = [], 1
        for _ in range(m):
            tws.append(acc)
            acc = acc * w_m % R
        out.append(_encode_np(tws))
    return out


@functools.lru_cache(maxsize=None)
def _coset_table_brev(n: int, root: int) -> np.ndarray:
    """(16, n) Montgomery table t[pos] = (1/n) * root^bitrev(pos) — the coset
    shift as seen on a bit-reversal-ordered coefficient array, with the
    iNTT's 1/n scale folded in."""
    n_inv = pow(n, -1, R)
    acc, powers = n_inv, []
    for _ in range(n):
        powers.append(acc)
        acc = acc * root % R
    rev = _bitrev(n)
    return _encode_np([powers[rev[i]] for i in range(n)])


def coset_root_2n(n: int) -> int:
    """element(1) of the size-2n domain (qap.rs:72-77)."""
    return domain_generator(2 * n)


def _table(arr: np.ndarray, like: torch.Tensor, shape) -> torch.Tensor:
    t = torch.from_numpy(arr.astype(np.int32)).to(like.device)
    return t.reshape(shape).expand(like.shape)


def _dit(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """Decimation-in-time stages: bit-reversed input -> natural-order DFT."""
    tables = _stage_twiddles(n, inverse)
    batch = tuple(x.shape[2:])
    for s in range(1, n.bit_length()):
        m = 1 << (s - 1)
        t = x.reshape((16, n // (2 * m), 2, m) + batch)
        lo, hi = t[:, :, 0], t[:, :, 1]
        tw = _table(tables[s - 1], hi, (16, 1, m) + (1,) * len(batch))
        hi_t = FrPlain.mul(hi, tw)
        t = torch.stack([FrPlain.add(lo, hi_t), FrPlain.sub(lo, hi_t)], dim=2)
        x = t.reshape((16, n) + batch)
    return x


def _dif(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """Decimation-in-frequency stages: natural input -> bit-reversed DFT."""
    tables = _stage_twiddles(n, inverse)
    batch = tuple(x.shape[2:])
    for s in range(n.bit_length() - 1, 0, -1):
        m = 1 << (s - 1)
        t = x.reshape((16, n // (2 * m), 2, m) + batch)
        lo, hi = t[:, :, 0], t[:, :, 1]
        tw = _table(tables[s - 1], hi, (16, 1, m) + (1,) * len(batch))
        diff = FrPlain.sub(lo, hi)
        t = torch.stack([FrPlain.add(lo, hi), FrPlain.mul(diff, tw)], dim=2)
        x = t.reshape((16, n) + batch)
    return x


def coset_lift(evals: torch.Tensor, root: int) -> torch.Tensor:
    """fft(distribute_powers(ifft(evals), root)) on (16, n, *batch) in one
    gather-free chain: DIF stages (natural -> bitrev), one pointwise multiply
    by the permuted coset table (1/n folded in), DIT stages (bitrev ->
    natural). Plain torch; the QAP witness map's h-polynomial lift."""
    n = evals.shape[1]
    if n == 1:
        return evals
    batch = tuple(evals.shape[2:])
    x = _dif(evals, n, True)
    x = FrPlain.mul(x, _table(_coset_table_brev(n, root), x, (16, n) + (1,) * len(batch)))
    return _dit(x, n, False)
