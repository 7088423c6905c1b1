"""Wrappers of the NTT stage kernels (K4, K5), with their plain versions.

Counterpart of zerokit_tpu/ff/pallas_ntt.py on the same (16, B, n) layout
(batch second-minor, domain minor) and with the same stage order, so the
results equal groth16/ntt.py's:

  * ntt_cross (K4, csrc/ntt_kernels.cu `ntt_cross<Dir>`): a run of r
    consecutive radix-2 stages, half-sizes s .. s * 2^(r-1), in one launch
    (DIT ascending, DIF descending), on tiles of c columns held in shared
    memory; its twiddles are the top stage's (16, s * 2^(r-1)) table, read
    at a stride for the lower stages. DIF (lo+hi, (lo-hi)*w); DIT
    (lo+w*hi, lo-w*hi). ntt_stage is its r = 1 call.
  * ntt_tail (K5, `ntt_tail<Dir,FuseTable>`): every stage m < P inside
    P-point chunks, P = min(n, p) for a chunk p of 2 .. 2048 (TAIL by
    default), optionally fused with a pointwise table multiply after the DIF
    stages or before the DIT stages.
  * dif / dit / coset_lift_bn: the full passes built from them: the stages
    m >= P as the K4 runs of cross_runs (at most CROSS_RMAX stages a launch),
    the rest in one K5 call.

The chunk, the tile's columns and the run length are arguments of the
wrappers so that tests and chip_smoke.py can run each setting; the proving
path uses the defaults (TAIL; CROSS_TILE and CROSS_RMAX, csrc's kCrossTile
and kCrossRMax).

Every power-of-two n and every B are taken (K4 on the card: n >= 4). A CUDA
tensor launches the kernels (or raises); a CPU tensor takes the `*_plain`
versions, which run on any device and launch no kernel. `launches` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

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
CROSS_TILE = 512  # K4's positions a tile (csrc kCrossTile): the sweep's choice on the H100 (PERF.md)
CROSS_RMAX = 5  # K4's stages a launch at most (csrc kCrossRMax): likewise
MIN_CROSS_C = 16  # the fewest columns of a default K4 tile (csrc kMinCrossC)
MAX_CROSS_C = 64  # the most columns a tile K4 takes (csrc kMaxCrossC)
MAX_CROSS_RUN = 6  # the most stages a K4 launch takes (csrc kMaxRun)
MAX_CROSS_TILE = 2048  # the most positions a K4 tile holds (csrc kMaxCrossTile)
launches = {"ntt_cross": 0, "ntt_tail": 0}


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
# K4: a run of cross stages
# ---------------------------------------------------------------------------


def cross_runs(n: int, p: int = TAIL, r_max: int = CROSS_RMAX) -> List[Tuple[int, int]]:
    """The K4 launches of a pass over n points with tail chunk p: (s, r)
    for each run of r consecutive stages of half-sizes s .. s * 2^(r-1),
    ascending (DIT order; DIF runs them in reverse). The log2(n / P) cross
    stages (P = tail_size(n, p)) go into the fewest runs of at most r_max
    stages, their lengths as near equal as can be, the longer ones first."""
    if not 1 <= r_max <= MAX_CROSS_RUN:
        raise ValueError(f"run length must be in [1, {MAX_CROSS_RUN}], got {r_max}")
    lo = tail_size(n, p).bit_length() - 1
    stages = n.bit_length() - 1 - lo
    if stages <= 0:
        return []
    count = -(-stages // r_max)
    runs = []
    for i in range(count):
        r = stages // count + (i < stages % count)
        runs.append((1 << lo, r))
        lo += r
    return runs


def cross_cols(r: int, c: Optional[int] = None) -> int:
    """K4's columns a tile for a run of r stages: c, or by default
    CROSS_TILE / 2^r within [MIN_CROSS_C, MAX_CROSS_C] (csrc
    default_cols)."""
    return c if c is not None else min(MAX_CROSS_C, max(MIN_CROSS_C, CROSS_TILE >> r))


def cross_tile(n: int, r: int, c: Optional[int] = None) -> int:
    """Positions of one K4 tile: 2^r columns of min(C, n / 2^r) positions."""
    return min(cross_cols(r, c), n >> r) << r


def cross_smem_bytes(n: int, s: int, r: int, c: Optional[int] = None) -> int:
    """Shared memory of one K4 block (csrc cross_launch): the tile's 8
    words a position and the staged twiddles, 2^i min(s, C') for each
    stage i."""
    cols = min(cross_cols(r, c), n >> r)
    low = min(s, cols)
    return 4 * 8 * ((cols << r) + (low << r) - low)


def _check_run(n: int, s: int, r: int, c: Optional[int]) -> None:
    if not (1 <= r <= MAX_CROSS_RUN and s >= 1 and s & (s - 1) == 0 and s << r <= n):
        raise ValueError(f"bad run s={s} r={r} for n={n}")
    if c is not None and (c < 1 or c & (c - 1) or c > MAX_CROSS_C):
        raise ValueError(f"tile columns must be a power of two in [1, {MAX_CROSS_C}], got {c}")


def ntt_cross(x: torch.Tensor, top: torch.Tensor, s: int, r: int, direction: str,
              c: Optional[int] = None) -> torch.Tensor:
    """The r stages of half-sizes s .. s * 2^(r-1) on x (16, B, n) in one
    K4 launch, tiles of c columns (cross_cols); top (16, s * 2^(r-1)): the
    top stage's twiddles, whose entry j * 2^(r-1-i) is stage s * 2^i's
    twiddle j."""
    _check_x(x)
    _, b, n = x.shape
    _check_run(n, s, r, c)
    if direction not in ("dif", "dit"):
        raise ValueError(f"bad direction {direction!r}")
    if tuple(top.shape) != (L, s << (r - 1)):
        raise ValueError(f"twiddles must be (16, {s << (r - 1)}), got {tuple(top.shape)}")
    if not on_cuda(x, top):
        return ntt_cross_plain(x, top, s, r, direction)
    check_limbs(x, "x")
    check_limbs(top, "top")
    tile = cross_tile(n, r, c)
    if n < 4 or tile < 4 or tile > MAX_CROSS_TILE or b > 65535:
        raise ValueError(f"K4 takes n >= 4, tiles of 4 to {MAX_CROSS_TILE} positions and "
                         f"B <= 65535: n={n}, r={r}, c={c} (tile {tile}), B={b}")
    out = torch.empty_like(x)
    cols = min(cross_cols(r, c), n >> r)
    if (tile if s < cols else cols) >= 4 and any(t.data_ptr() % 16 for t in (x, out)):
        raise ValueError("ntt_cross: x must be 16-byte aligned")
    _cuda.launch("zk_ntt_cross", int(direction == "dif"), x, top, out, b, n, s, r,
                  0 if c is None else c)
    launches["ntt_cross"] += 1
    return out


def ntt_cross_plain(x: torch.Tensor, top: torch.Tensor, s: int, r: int,
                    direction: str) -> torch.Tensor:
    """The run one stage at a time (ntt_stage_plain), stage s * 2^i's
    twiddles read from top at stride 2^(r-1-i)."""
    m_top = s << (r - 1)
    ms = [s << i for i in range(r)]
    for m in ms[::-1] if direction == "dif" else ms:
        x = ntt_stage_plain(x, top[:, :: m_top // m].contiguous(), m, direction)
    return x


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, m: int, direction: str) -> torch.Tensor:
    """One butterfly stage of half-size m on x (16, B, n); tw (16, m): the
    r = 1 call of ntt_cross."""
    _check_x(x)
    if direction not in ("dif", "dit") or m < 1 or 2 * m > x.shape[2]:
        raise ValueError(f"bad stage {direction} m={m} for n={x.shape[2]}")
    return ntt_cross(x, tw, m, 1, direction)


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


def cross(x: torch.Tensor, inverse: bool, direction: str, p: int = TAIL,
          c: Optional[int] = None, r_max: int = CROSS_RMAX) -> torch.Tensor:
    """Every cross stage (m >= P) of a pass on (16, B, n): one K4 launch a
    run of cross_runs(n, p, r_max), ascending for DIT, descending for DIF;
    tiles of c columns."""
    n = x.shape[2]
    dev = str(x.device)
    runs = cross_runs(n, p, r_max)
    for s, r in runs[::-1] if direction == "dif" else runs:
        x = ntt_cross(x, _stage_tw(n, s << (r - 1), inverse, dev), s, r, direction, c)
    return x


def dif(x: torch.Tensor, inverse: bool, table: Optional[torch.Tensor] = None,
        p: int = TAIL) -> torch.Tensor:
    """Full DIF pass on (16, B, n): natural -> bit-reversed order, then an
    optional pointwise multiply by table (16, n); tail chunk p."""
    x = cross(x, inverse, "dif", p)
    return ntt_tail(x, _tail_tw(x.shape[2], inverse, str(x.device), p), table, "dif", p)


def dit(x: torch.Tensor, inverse: bool, table: Optional[torch.Tensor] = None,
        p: int = TAIL) -> torch.Tensor:
    """Full DIT pass on (16, B, n): optional pointwise multiply by table,
    then bit-reversed -> natural order; tail chunk p."""
    x = ntt_tail(x, _tail_tw(x.shape[2], inverse, str(x.device), p), table, "dit", p)
    return cross(x, inverse, "dit", p)


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
