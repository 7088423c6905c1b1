"""K4, the NTT cross stages, as runs of stages through a shared-memory tile.

csrc/ntt_kernels.cu runs r consecutive cross stages (half-sizes S .. 2^(r-1)
S) in one launch: a block owns a tile of C' columns and their 2^r positions
each, loads it in address order (4 consecutive positions a thread), runs the
stages as radix-4 register groups exchanged through a swizzled shared-memory
tile, and reads every twiddle from the top stage's table at a stride, staged
once a block. CUDA does not run here, so `kernel_model` executes that
schedule on Python integers, line for line (the block's tile and its base,
the load and store positions, the staged twiddles and each butterfly's
index into them, the groups of cross_group, the swizzle), and is held
exactly against ntt_cross_plain, which runs the stages one at a time. The
model also checks that every layout's positions are a partition of the
tile, that the loads and stores cover the array once, and that no warp's
shared-memory access has a bank conflict. Then cross_runs, the pass's cut
into runs, and groth16/ntt.natural_ntt with the model as its K4 against the
JAX package's fft / ifft. Every comparison is on integers, with no tolerance.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerokit_tpu.groth16 import ntt as jax_ntt
from zerokit_tpu_torch.ff import ntt_kernels as nk
from zerokit_tpu_torch.ff.field import FR, from_numpy_limbs
from zerokit_tpu_torch.groth16 import ntt
from zerokit_tpu_torch.runtime import profiling as prof

from test_torch_ntt_tail import butterfly, check_banks, random_mont, swz

torch.set_num_threads(1)

LR = nk.TAIL_LR
E = 1 << LR
CSRC = os.path.join(os.path.dirname(nk.__file__), "..", "csrc", "ntt_kernels.cu")


# ---------------------------------------------------------------------------
# The kernel's schedule on Python integers (csrc/ntt_kernels.cu, K4)
# ---------------------------------------------------------------------------


def group_pos(t: int, g: int, c: int) -> int:
    low = t & ((1 << g) - 1)
    return ((t >> g) << (g + LR)) + (c << g) + low


def cross_group(gi: int, r: int, ls: int, lt: int):
    """(g, qlo, qhi) of group gi in DIT order (csrc cross_group)."""
    if not r & 1:
        return ls + 2 * gi, 0, 1
    if ls >= 1:
        return (ls - 1, 1, 1) if gi == 0 else (ls + 2 * gi - 1, 0, 1)
    if gi < r // 2:
        return 2 * gi, 0, 1
    return (r - 1, 0, 0) if r < lt else (r - 2, 1, 1)


def check_banks_16(accesses) -> None:
    """accesses: (thread, 16-byte slot) of one 16-byte shared-memory access
    of a block. The card serves a warp's 16-byte accesses a quarter-warp at
    a time; each quarter's distinct slots must lie in distinct groups of
    four banks (slot mod 8)."""
    quarters = {}
    for t, slot in accesses:
        quarters.setdefault(t // 8, set()).add(slot)
    for slots in quarters.values():
        groups = [slot % 8 for slot in slots]
        assert len(groups) == len(set(groups)), "shared-memory bank conflict"


def tile_offset(pos: int, lrow: int, logs: int) -> int:
    return ((pos >> lrow) << logs) + (pos & ((1 << lrow) - 1))


class Block:
    """One block of ntt_cross_kernel<dif>: its tile in shared memory and its
    staged twiddles."""

    def __init__(self, top: list, n: int, s: int, r: int, c: int, blk: int):
        logn, self.logs, self.r = n.bit_length() - 1, s.bit_length() - 1, r
        self.lc = min(c.bit_length() - 1, logn - r)
        self.lt = r + self.lc
        self.tile = 1 << self.lt
        self.ls = min(self.logs, self.lc)
        self.lrow = self.lt if self.logs < self.lc else self.lc
        self.ntw = (1 << (self.ls + r)) - (1 << self.ls)
        self.threads = self.tile >> LR
        q0 = blk << self.lc
        self.low0 = q0 & ((1 << self.logs) - 1)
        self.base = ((q0 >> self.logs) << (self.logs + r)) + self.low0
        self.data = [None] * self.tile
        self.products = 0
        # the staged twiddles: entry i is stage bit b's (b = ls + i')
        # twiddle for the lo positions whose low b bits are k; words 0-3 at
        # 16-byte slot i, 4-7 at slot ntw + i, written by thread i mod the
        # block's threads
        for plane in (0, self.ntw):
            for first in range(0, self.ntw, self.threads):
                check_banks_16([(t, plane + first + t) for t in range(self.threads)
                                if first + t < self.ntw])
        self.tw = []
        for i in range(self.ntw):
            bit = (i + (1 << self.ls)).bit_length() - 1
            k = i + (1 << self.ls) - (1 << bit)
            j = ((k >> self.ls) << self.logs) + self.low0 + (k & ((1 << self.ls) - 1))
            stage = bit - self.ls
            assert j < s << stage, "a twiddle index beyond its stage"
            self.tw.append(top[j << (r - 1 - stage)])

    def offset(self, pos: int) -> int:
        """Row-local device-memory offset of local position pos."""
        return self.base + tile_offset(pos, self.lrow, self.logs)

    def quads(self) -> list:
        """The offsets each thread loads and stores: 4 consecutive local
        positions, consecutive addresses where a tile row holds 4 or more."""
        out = [[self.offset(E * t + c) for c in range(E)] for t in range(self.threads)]
        if 1 << self.lrow >= E:
            assert all(q == list(range(q[0], q[0] + E)) and q[0] % E == 0 for q in out)
        return out

    def exchange(self, es: list, g: int, load: bool) -> list:
        for c in range(E):
            check_banks([(t, swz(group_pos(t, g, c))) for t in range(self.threads)])
        pos = [group_pos(t, g, c) for t in range(self.threads) for c in range(E)]
        assert sorted(pos) == list(range(self.tile)), "a layout is not a partition of the tile"
        if load:
            return [[self.data[swz(group_pos(t, g, c))] for c in range(E)]
                    for t in range(self.threads)]
        for t, e in enumerate(es):
            for c in range(E):
                self.data[swz(group_pos(t, g, c))] = e[c]
        return es

    def stages(self, dif: bool, es: list, grp) -> None:
        g, qlo, qhi = grp
        for q in (range(LR - 1, -1, -1) if dif else range(LR)):
            if q < qlo or q > qhi:
                continue
            h = 1 << q
            off = (1 << (g + q)) - (1 << self.ls)
            for c in range(E):
                if c & h:
                    continue
                idx = [off + (t & ((1 << g) - 1)) + ((c & (h - 1)) << g)
                       for t in range(self.threads)]
                # the index is the lo position's low g + q bits
                for t in range(self.threads):
                    lo = group_pos(t, g, c)
                    assert idx[t] - off == lo & ((1 << (g + q)) - 1)
                for plane in (0, self.ntw):
                    check_banks_16([(t, plane + i) for t, i in enumerate(idx)])
                for t, e in enumerate(es):
                    e[c], e[c + h] = butterfly(dif, e[c], e[c + h], self.tw[idx[t]])
                    self.products += 1


def kernel_model(x: list, top: list, s: int, r: int, c: int, dif: bool):
    """x: B rows of n ints (Montgomery form) through ntt_cross_kernel<dif>
    with tiles of c columns: returns the rows out and the products run."""
    n = len(x[0])
    probe = Block(top, n, s, r, c, 0)
    out = [[None] * n for _ in x]
    loaded = [0] * n
    products = 0
    for row, xr in enumerate(x):
        for blk in range(n >> probe.lt):
            b = Block(top, n, s, r, c, blk)
            quads = b.quads()
            es = [[xr[o] for o in q] for q in quads]
            for q in quads:
                for o in q:
                    loaded[o] += row == 0
            groups = (r + 1) // 2
            prev = 0
            for gg in range(groups):
                grp = cross_group(groups - 1 - gg if dif else gg, r, b.ls, b.lt)
                if grp[0] != prev:
                    b.exchange(es, prev, load=False)
                    es = b.exchange(None, grp[0], load=True)
                    prev = grp[0]
                b.stages(dif, es, grp)
            if prev != 0:
                b.exchange(es, prev, load=False)
                es = b.exchange(None, 0, load=True)
            for q, e in zip(quads, es):
                for o, v in zip(q, e):
                    assert out[row][o] is None
                    out[row][o] = v
            products += b.products
    assert loaded == [1] * n, "the loads do not cover the row once"
    return out, products


def _ints(limbs: np.ndarray) -> list:
    return [int(v) for v in FR.decode(torch.from_numpy(limbs.astype(np.int32)), mont=False)]


def _rows(t: torch.Tensor) -> list:
    return [_ints(t[:, b].numpy()) for b in range(t.shape[1])]


def model_cross(x: torch.Tensor, top: torch.Tensor, s: int, r: int, direction: str,
                c=None) -> torch.Tensor:
    """ntt_cross on a CPU tensor through kernel_model: its signature, the
    model's result as (16, B, n) limbs."""
    rows, _ = kernel_model(_rows(x), _ints(top.numpy()), s, r, nk.cross_cols(r, c),
                           direction == "dif")
    out = FR.encode([v for row in rows for v in row], mont=False)
    return out.reshape(16, x.shape[1], x.shape[2])


def run_cases(n: int):
    """(s, r) runs at n: every run cross_runs makes at chunks 2 .. n/2 and
    r_max 1 .. MAX_CROSS_RUN, and each r = 1 .. MAX_CROSS_RUN at the
    smallest and the largest s."""
    cases = set()
    for p in (1 << k for k in range(1, n.bit_length() - 1)):
        for r_max in range(1, nk.MAX_CROSS_RUN + 1):
            cases.update(nk.cross_runs(n, p, r_max))
    for r in range(1, nk.MAX_CROSS_RUN + 1):
        if 1 << r <= n:
            cases.update({(1, r), (n >> r, r)})
    return sorted(cases)


@pytest.mark.parametrize("n", [1 << k for k in range(4, 13)])
@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_kernel_schedule_equals_plain(n, direction):
    """The kernel's tiles, groups, positions, swizzle and twiddle lookups
    give ntt_cross_plain's integers for each run, B = 1 and 3 (B = 3 at
    n <= 1024), at the default tile (cross_cols) and C = 16 and 64, and run
    one product a butterfly (kernel_work's K4 count)."""
    rng = np.random.default_rng(n + (direction == "dif"))
    for s, r in run_cases(n):
        for c, batch in ((nk.cross_cols(r), 1), (16, 3 if n <= 1024 else 1), (64, 1)):
            if nk.cross_tile(n, r, c) > nk.MAX_CROSS_TILE or nk.cross_tile(n, r, c) < 4:
                continue
            x = torch.from_numpy(random_mont(rng, (batch, n)).astype(np.int32))
            top = nk._stage_tw(n, s << (r - 1), direction == "dif", "cpu")
            want = nk.ntt_cross_plain(x, top, s, r, direction)
            got, products = kernel_model(_rows(x), _ints(top.numpy()), s, r, c,
                                         direction == "dif")
            assert got == _rows(want), (s, r, c)
            assert products == batch * n // 2 * r
            work = prof.kernel_work("K4", rows=batch, n=n, m=s << (r - 1), r=r)
            assert work[0] == products * prof.MONT_MUL_IMADS
            block = Block(_ints(top.numpy()), n, s, r, c, 0)
            smem = 4 * 8 * (block.tile + block.ntw)
            assert nk.cross_smem_bytes(n, s, r, c) == smem <= 128 << 10


def test_run_equals_its_stages_and_the_wrapper_takes_the_plain_version_on_cpu():
    """ntt_cross on a CPU tensor is ntt_cross_plain; ntt_stage is its r = 1
    call; the run equals its stages through their own tables."""
    rng = np.random.default_rng(5)
    n, s, r = 256, 4, 5
    x = torch.from_numpy(random_mont(rng, (2, n)).astype(np.int32))
    for direction in ("dif", "dit"):
        inverse = direction == "dif"
        nk.reset_launches()
        got = nk.ntt_cross(x, nk._stage_tw(n, s << (r - 1), inverse, "cpu"), s, r, direction)
        assert nk.launches == {"ntt_cross": 0, "ntt_tail": 0}
        y = x
        ms = [s << i for i in range(r)]
        for m in ms[::-1] if direction == "dif" else ms:
            y = nk.ntt_stage(y, nk._stage_tw(n, m, inverse, "cpu"), m, direction)
        assert torch.equal(got, y)


def test_arguments_are_checked():
    x = torch.zeros((16, 1, 64), dtype=torch.int32)
    tw = nk._stage_tw(64, 16, False, "cpu")
    for s, r, c in ((16, 3, 32), (3, 1, 32), (8, 7, 32), (16, 2, 128), (16, 2, 3)):
        with pytest.raises(ValueError):
            nk.ntt_cross(x, tw, s, r, "dit", c)
    with pytest.raises(ValueError):  # the top table of s = 4, r = 2 is (16, 8)
        nk.ntt_cross(x, tw, 4, 2, "dit")
    assert nk.ntt_cross(x, tw, 8, 2, "dit").shape == x.shape  # s = 8, r = 2: (16, 16)
    with pytest.raises(ValueError):
        nk.ntt_cross(x, tw, 16, 1, "up")
    with pytest.raises(ValueError):
        nk.cross_runs(64, 2, 0)


def test_constants_mirror_the_source():
    """The Python mirrors of the kernel's constants read from csrc."""
    with open(CSRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("kCrossTile") == nk.CROSS_TILE and const("kCrossRMax") == nk.CROSS_RMAX
    assert const("kMaxCrossC") == nk.MAX_CROSS_C and const("kMaxRun") == nk.MAX_CROSS_RUN
    assert const("kMaxCrossTile") == nk.MAX_CROSS_TILE
    assert re.search(r"constexpr int kLR = (\d+)", src).group(1) == str(LR)
    assert const("kMinCrossC") == nk.MIN_CROSS_C
    # the default tile: CROSS_TILE positions at r = 3-5, 64 columns below,
    # 16 above
    assert [nk.cross_cols(r) for r in range(1, 7)] == [64, 64, 64, 32, 16, 16]
    assert [nk.cross_tile(1 << 22, r) for r in range(1, 7)] == [128, 256, 512, 512, 512, 1024]


# ---------------------------------------------------------------------------
# The pass's runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r_max", range(1, 7))
def test_cross_runs_cover_every_cross_stage_once_in_order(r_max):
    for log_n in range(1, 23):
        n = 1 << log_n
        for p in (1 << k for k in range(1, 12)):
            runs = nk.cross_runs(n, p, r_max)
            lo = nk.tail_size(n, p).bit_length() - 1
            stages = [s.bit_length() - 1 + i for s, r in runs for i in range(r)]
            assert stages == list(range(lo, log_n))
            if runs:
                lengths = [r for _, r in runs]
                assert len(runs) == math.ceil((log_n - lo) / r_max)
                assert max(lengths) <= r_max and max(lengths) - min(lengths) <= 1
                assert lengths == sorted(lengths, reverse=True)


def test_cross_runs_of_the_main_shapes():
    """The main path's n = 8192 is one run each way (was three launches),
    the mesh's local 4096 one (was two), 2^20 two runs of five (was ten),
    2^22 two runs of six at r_max = 6."""
    assert nk.cross_runs(8192) == [(1024, 3)]
    assert nk.cross_runs(4096) == [(1024, 2)]
    assert nk.cross_runs(1 << 20) == [(1024, 5), (1 << 15, 5)]
    assert nk.cross_runs(1 << 22, r_max=6) == [(1024, 6), (1 << 16, 6)]
    assert nk.cross_runs(1024) == [] and nk.cross_runs(2) == []


# ---------------------------------------------------------------------------
# The natural-order NTT with the model as its K4, against the JAX package
# ---------------------------------------------------------------------------


def test_natural_ntt_through_the_model_equals_jax(monkeypatch):
    """groth16/ntt.natural_ntt at n = 2^12 with a tail chunk of 64: six
    cross stages, two runs of three, each through kernel_model; the tail and
    the gather as on the CPU. Equal to the JAX package's fft and ifft."""
    n, batch, p = 1 << 12, 2, 64
    calls = []

    def as_kernel(x, top, s, r, direction, c=None):
        calls.append((s, r, direction))
        return model_cross(x, top, s, r, direction, c)

    dif = nk.dif
    monkeypatch.setattr(nk, "ntt_cross", as_kernel)
    monkeypatch.setattr(nk, "dif", lambda x, inverse, table=None: dif(x, inverse, table, p))
    rng = np.random.default_rng(12)
    arr = random_mont(rng, (n, batch))  # the JAX package's (16, n, B)
    x = from_numpy_limbs(arr, "cpu").transpose(1, 2).contiguous()
    got_fft = ntt.fft(x)
    got_ifft = ntt.ifft(x)
    assert calls == [(512, 3, "dif"), (64, 3, "dif")] * 2
    want_fft = np.asarray(jax_ntt.fft(jnp.asarray(arr)))
    want_ifft = np.asarray(jax_ntt.ifft(jnp.asarray(arr)))
    assert np.array_equal(got_fft.transpose(1, 2).numpy().astype(np.uint32), want_fft)
    assert np.array_equal(got_ifft.transpose(1, 2).numpy().astype(np.uint32), want_ifft)
