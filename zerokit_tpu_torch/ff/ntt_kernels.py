"""Wrappers of the NTT stage kernels (K4, K5), with their plain versions.

Counterpart of zerokit_tpu/ff/pallas_ntt.py on the same (16, B, n) layout
(batch second-minor, domain minor) and with the same stage order, so the
results equal groth16/ntt.py's:

  * ntt_stage (K4, csrc/ntt_kernels.cu `ntt_stage<Dir>`): one radix-2 stage
    at half-size m. DIF (lo+hi, (lo-hi)*w); DIT (lo+w*hi, lo-w*hi).
  * ntt_tail (K5, `ntt_tail<Dir,FuseTable>`): every stage m < P inside
    P-point chunks, P = min(n, p) for a chunk p of 2 .. 2048 (TAIL by
    default), optionally fused with a pointwise table multiply after the DIF
    stages or before the DIT stages.
  * dif / dit / coset_lift_bn: the full passes built from them: the stages
    m >= P run as K4, the rest in one K5 call.

The chunk is an argument of every wrapper so that tests and chip_smoke.py
can run each chunk size; the proving path uses TAIL.

Every power-of-two n and every B are taken. A CUDA tensor launches the
kernels (or raises); a CPU tensor takes the `*_plain` versions, which run
on any device and launch no kernel. `launches` counts kernel launches per
wrapper.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..constants import NUM_LIMBS
from . import _cuda
from .field import FrPlain
from .field_kernels import check_limbs, on_cuda

L = NUM_LIMBS
TAIL = 1024  # the tail's chunk: the fastest lift of 512, 1024, 2048 on the H100 (PERF.md)
MAX_TAIL = 2048  # the largest chunk the tail kernel takes (csrc kMaxTail)
TAIL_LR = 2  # log2 of the values a tail thread holds (csrc kLR: radix-4 groups)
launches = {"ntt_stage": 0, "ntt_tail": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def tail_size(n: int, p: int = TAIL) -> int:
    """The tail's chunk at domain size n for a chunk of p points."""
    if p < 2 or p > MAX_TAIL or p & (p - 1):
        raise ValueError(f"tail chunk must be a power of two in [2, {MAX_TAIL}], got {p}")
    return min(n, p)


@functools.lru_cache(maxsize=None)
def _stage_tw(n: int, m: int, inverse: bool, device: str) -> torch.Tensor:
    """(16, m) twiddles w_m^j of the stage with half-size m."""
    from ..groth16.ntt import _stage_twiddles

    tw = _stage_twiddles(n, inverse)[m.bit_length() - 1]
    return torch.from_numpy(tw.astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _tail_tw(n: int, inverse: bool, device: str, p: int = TAIL) -> torch.Tensor:
    """(16, P) concatenated tail twiddles, P = tail_size(n, p): slot [m, 2m)
    holds stage m's."""
    from ..groth16.ntt import _stage_twiddles

    p = tail_size(n, p)
    tables = _stage_twiddles(n, inverse)
    out = np.zeros((L, p), dtype=np.int32)
    m = 1
    while m < p:
        out[:, m : 2 * m] = tables[m.bit_length() - 1][:, :m]
        m *= 2
    return torch.from_numpy(out).to(device)


def _check_x(x: torch.Tensor) -> None:
    if x.ndim != 3 or x.shape[0] != L:
        raise ValueError(f"expected (16, B, n) limbs, got {tuple(x.shape)}")
    n = x.shape[2]
    if n < 2 or n & (n - 1):
        raise ValueError(f"domain size must be a power of two >= 2, got {n}")


# ---------------------------------------------------------------------------
# K4: one cross stage
# ---------------------------------------------------------------------------


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, m: int, direction: str) -> torch.Tensor:
    """One butterfly stage of half-size m on x (16, B, n); tw (16, m)."""
    _check_x(x)
    if direction not in ("dif", "dit") or m < 1 or 2 * m > x.shape[2]:
        raise ValueError(f"bad stage {direction} m={m} for n={x.shape[2]}")
    if tuple(tw.shape) != (L, m):
        raise ValueError(f"twiddles must be (16, {m}), got {tuple(tw.shape)}")
    if not on_cuda(x, tw):
        return ntt_stage_plain(x, tw, m, direction)
    check_limbs(x, "x")
    check_limbs(tw, "tw")
    _, b, n = x.shape
    out = torch.empty_like(x)
    _cuda.launch("zk_ntt_stage", int(direction == "dif"), x, tw, out, b, n, m)
    launches["ntt_stage"] += 1
    return out


def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, m: int, direction: str) -> torch.Tensor:
    _, b, n = x.shape
    t = x.reshape(L, b, n // (2 * m), 2, m)
    lo = t[:, :, :, 0].contiguous()
    hi = t[:, :, :, 1].contiguous()
    w = tw.reshape(L, 1, 1, m).expand(lo.shape)
    if direction == "dif":
        s = FrPlain.add(lo, hi)
        d = FrPlain.mul(FrPlain.sub(lo, hi), w)
    else:
        wh = FrPlain.mul(hi, w)
        s = FrPlain.add(lo, wh)
        d = FrPlain.sub(lo, wh)
    return torch.stack([s, d], dim=3).reshape(L, b, n)


# ---------------------------------------------------------------------------
# K5: the in-chunk tail stages (+ fused table multiply)
# ---------------------------------------------------------------------------


def ntt_tail(
    x: torch.Tensor, tail_tw: torch.Tensor, table: Optional[torch.Tensor], direction: str,
    p: int = TAIL,
) -> torch.Tensor:
    """All stages m = 1 .. P/2 (P = tail_size(n, p)) of x (16, B, n) in
    P-point chunks; DIF runs them descending, then multiplies by table
    (16, n); DIT multiplies first, then runs them ascending."""
    _check_x(x)
    _, b, n = x.shape
    size = tail_size(n, p)
    if direction not in ("dif", "dit"):
        raise ValueError(f"bad direction {direction!r}")
    if tuple(tail_tw.shape) != (L, size):
        raise ValueError(f"tail twiddles must be (16, {size}), got {tuple(tail_tw.shape)}")
    if table is not None and tuple(table.shape) != (L, n):
        raise ValueError(f"table must be (16, {n}), got {tuple(table.shape)}")
    tensors = (x, tail_tw) if table is None else (x, tail_tw, table)
    if not on_cuda(*tensors):
        return ntt_tail_plain(x, tail_tw, table, direction, p)
    for t, name in zip(tensors, ("x", "tail_tw", "table")):
        check_limbs(t, name)
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the tail kernel's grid")
    out = torch.empty_like(x)
    if size >= 8 and any(t.data_ptr() % 16 for t in (x, out) + tensors[2:]):
        raise ValueError("ntt_tail: x and table must be 16-byte aligned")
    _cuda.launch("zk_ntt_tail", int(direction == "dif"), x, tail_tw, table, out, b, n, size)
    launches["ntt_tail"] += 1
    return out


def ntt_tail_plain(x, tail_tw, table, direction: str, p: int = TAIL) -> torch.Tensor:
    """The tail one stage at a time (the kernel's groups and its skipped
    multiplies by 1 give the same integers)."""
    size = tail_size(x.shape[2], p)
    ms = [1 << s for s in range(size.bit_length() - 1)]
    if direction == "dif":
        ms = ms[::-1]
    if table is not None and direction == "dit":
        x = FrPlain.mul(x, table[:, None, :].expand(x.shape))
    for m in ms:
        x = ntt_stage_plain(x, tail_tw[:, m : 2 * m], m, direction)
    if table is not None and direction == "dif":
        x = FrPlain.mul(x, table[:, None, :].expand(x.shape))
    return x


# ---------------------------------------------------------------------------
# Full passes
# ---------------------------------------------------------------------------


def dif(x: torch.Tensor, inverse: bool, table: Optional[torch.Tensor] = None,
        p: int = TAIL) -> torch.Tensor:
    """Full DIF pass on (16, B, n): natural -> bit-reversed order, then an
    optional pointwise multiply by table (16, n); tail chunk p."""
    n = x.shape[2]
    dev = str(x.device)
    m = n // 2
    while m >= tail_size(n, p):
        x = ntt_stage(x, _stage_tw(n, m, inverse, dev), m, "dif")
        m //= 2
    return ntt_tail(x, _tail_tw(n, inverse, dev, p), table, "dif", p)


def dit(x: torch.Tensor, inverse: bool, table: Optional[torch.Tensor] = None,
        p: int = TAIL) -> torch.Tensor:
    """Full DIT pass on (16, B, n): optional pointwise multiply by table,
    then bit-reversed -> natural order; tail chunk p."""
    n = x.shape[2]
    dev = str(x.device)
    x = ntt_tail(x, _tail_tw(n, inverse, dev, p), table, "dit", p)
    m = tail_size(n, p)
    while m <= n // 2:
        x = ntt_stage(x, _stage_tw(n, m, inverse, dev), m, "dit")
        m *= 2
    return x


@functools.lru_cache(maxsize=None)
def _coset_table(n: int, root: int, device: str) -> torch.Tensor:
    from ..groth16.ntt import _coset_table_brev

    return torch.from_numpy(_coset_table_brev(n, root).astype(np.int32)).to(device)


def coset_lift_bn(evals_bn: torch.Tensor, root: int, p: int = TAIL) -> torch.Tensor:
    """fft(distribute_powers(ifft(evals), root)) on (16, B, n): DIF with
    inverse twiddles and the bit-reversed coset table (1/n folded in) fused
    into its tail, then DIT with forward twiddles; tail chunk p."""
    n = evals_bn.shape[2]
    if n == 1:
        return evals_bn
    table = _coset_table(n, root, str(evals_bn.device))
    return dit(dif(evals_bn, True, table, p), False, p=p)
