"""Radix-2 NTT host tables over BN254 Fr, the plain coset lift, and fft / ifft.

Counterpart of zerokit_tpu/groth16/ntt.py (ark-poly Radix2EvaluationDomain
semantics as used by the CircomReduction witness map, rln/src/circuit/
qap.rs:69-90). The tables are numpy uint32 limb arrays, shared with the
kernels of ff/ntt_kernels.py. coset_lift here is the plain torch version on
the (16, n, *batch) layout; the witness map runs ff/ntt_kernels.coset_lift_bn
on the (16, B, n) layout.

fft / ifft / distribute_powers are the natural-order transforms on the
kernels' (16, B, n) layout: natural_ntt, a DIF pass (K4 + K5,
ff/ntt_kernels.dif; a scale such as the inverse's 1/n fused into K5 as a
constant table) and a bit-reversal gather. natural_ntt_plain is its plain
version by the other route (bit-reversal gather, then plain DIT stages),
which launches no kernel: the oracle of the card's checks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import FR_TWO_ADICITY, FR_TWO_ADIC_ROOT, R
from ..ff.field import FR, FrField, FrPlain


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


# ---------------------------------------------------------------------------
# Natural-order transforms on the kernels' (16, B, n) layout
# ---------------------------------------------------------------------------


def _mont_limbs(value: int) -> np.ndarray:
    return FR.encode([value]).numpy().reshape(-1)


@functools.lru_cache(maxsize=None)
def _constant_table(n: int, value: int) -> np.ndarray:
    return _encode_np([value] * n)


@functools.lru_cache(maxsize=None)
def power_table(n: int, root: int) -> np.ndarray:
    """(16, n) Montgomery table root^i."""
    acc, powers = 1, []
    for _ in range(n):
        powers.append(acc)
        acc = acc * root % R
    return _encode_np(powers)


def _device_table(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32)).to(like.device)


def _bitrev_index(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_bitrev(n).astype(np.int64)).to(like.device)


def natural_ntt(x: torch.Tensor, inverse: bool, scale: int = 1) -> torch.Tensor:
    """The (i)NTT of x (16, B, n) over its last axis in natural order, times
    scale: one DIF pass with a constant table of `scale` fused into its tail
    (none for 1), then the bit-reversal gather."""
    from ..ff import ntt_kernels

    n = x.shape[2]
    if n == 1:
        return x if scale == 1 else FrField.mul(x, FrField.const(_mont_limbs(scale), x))
    table = None if scale == 1 else _device_table(_constant_table(n, scale), x)
    y = ntt_kernels.dif(x.contiguous(), inverse, table)
    return y.index_select(2, _bitrev_index(n, y))


def fft(x: torch.Tensor) -> torch.Tensor:
    """Evaluations at g^0..g^(n-1) from coefficients, on (16, B, n)."""
    return natural_ntt(x, False)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Coefficients from evaluations at g^0..g^(n-1), on (16, B, n)."""
    return natural_ntt(x, True, pow(x.shape[2], -1, R))


def distribute_powers(x: torch.Tensor, root: int) -> torch.Tensor:
    """x[..., i] *= root^i on (16, B, n) (ark distribute_powers, const 1)."""
    n = x.shape[2]
    tw = _device_table(power_table(n, root), x)[:, None, :].expand(x.shape)
    return FrField.mul(x, tw)


def natural_ntt_plain(x: torch.Tensor, inverse: bool, scale: int = 1) -> torch.Tensor:
    """Plain version of natural_ntt, by the other route: the bit-reversal
    gather first, then plain DIT stages, then the product by scale."""
    n = x.shape[2]
    y = x.transpose(1, 2).index_select(1, _bitrev_index(n, x))
    y = _dit(y, n, inverse).transpose(1, 2)
    if scale != 1:
        y = FrPlain.mul(y, FrPlain.const(_mont_limbs(scale), y))
    return y.contiguous()
