"""K5, the NTT tail, at every chunk size: the coset lift against the JAX
package, and the kernel's schedule against its plain version.

csrc/ntt_kernels.cu runs the tail as radix-4 register groups: a thread
holds 4 values, runs up to two stages on them, and exchanges them
through a swizzled shared-memory chunk; twiddles come from two staged
tables, and the first group's multiplies by 1 are skipped. CUDA does not
run here, so `kernel_model` executes that schedule on Python integers,
line for line (the groups, the positions of each thread, the swizzles,
the twiddle lookups, the skipped products), and is held against
ntt_tail_plain, which runs the stages one at a time. The model also checks
that every group's positions are a partition of the chunk and that no
shared-memory access of a warp has a bank conflict. Every comparison is on
integers, with no tolerance.
"""

import numpy as np
import pytest
import torch

from zerokit_tpu.groth16 import ntt as jntt
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff import ntt_kernels as nk
from zerokit_tpu_torch.ff.field import FR, from_numpy_limbs, to_numpy_limbs
from zerokit_tpu_torch.groth16 import ntt
from zerokit_tpu_torch.runtime import profiling as prof

torch.set_num_threads(1)

CHUNKS = (512, 1024, 2048)
SMALL_TW = 64  # csrc kSmallTw
R_INV = pow(1 << 256, -1, R)


def random_mont(rng, shape) -> np.ndarray:
    """(16, *shape) uint32 limbs of seeded Fr values (< r)."""
    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.uint32)
    limbs[15] %= (R >> 240) & 0xFFFF
    return limbs


# ---------------------------------------------------------------------------
# The kernel's schedule on Python integers (csrc/ntt_kernels.cu, K5)
# ---------------------------------------------------------------------------


SWZ_G = (0, 10, 21, 31, 25, 19, 12, 6)  # csrc swz: g of bits 5-7 of pos


def swz(pos: int) -> int:
    return pos ^ SWZ_G[(pos >> 5) & 7]


def swz_tw(i: int) -> int:
    return i ^ ((i >> 5) & 15)


def group_pos(t: int, logs: int, c: int, lr: int) -> int:
    low = t & ((1 << logs) - 1)
    return ((t >> logs) << (logs + lr)) + (c << logs) + low


def mont(a: int, b: int) -> int:
    return a * b * R_INV % R


def butterfly(dif: bool, lo: int, hi: int, w: int):
    if dif:
        return (lo + hi) % R, mont((lo - hi) % R, w)
    t = mont(hi, w)
    return (lo + t) % R, (lo - t) % R


def check_banks(accesses) -> None:
    """accesses: (thread, word address) of one instruction of a block; each
    warp's distinct addresses must lie in distinct banks."""
    warps = {}
    for t, addr in accesses:
        warps.setdefault(t // 32, set()).add(addr)
    for addrs in warps.values():
        banks = [a % 32 for a in addrs]
        assert len(banks) == len(set(banks)), "shared-memory bank conflict"


class Chunk:
    """One block of the tail kernel: its staged twiddles and its chunk."""

    def __init__(self, tw: list, p: int, lr: int):
        self.p, self.logp, self.lr, self.e = p, p.bit_length() - 1, lr, 1 << lr
        self.small = [tw[i] for i in range(min(p, SMALL_TW))]
        self.top = [None] * (p // 2) if p >= 2 * SMALL_TW else []
        for i in range(len(self.top)):
            self.top[swz_tw(i)] = tw[p // 2 + i]
        self.data = [None] * p
        self.reads = 0  # twiddle reads, to count the products

    def twiddle_addr(self, m: int, logm: int, j: int):
        """(table, word index) of stage m's twiddle j."""
        if m < SMALL_TW:
            return self.small, m + j
        return self.top, swz_tw(j << (self.logp - 1 - logm))

    def twiddle(self, m: int, logm: int, j: int) -> int:
        self.reads += 1
        table, i = self.twiddle_addr(m, logm, j)
        return table[i]

    def pos(self, t: int, logs: int, c: int) -> int:
        return group_pos(t, logs, c, self.lr)

    def store(self, es: list, logs: int) -> None:
        for c in range(self.e):
            check_banks([(t, swz(self.pos(t, logs, c))) for t in range(len(es))])
        pos = [self.pos(t, logs, c) for t in range(len(es)) for c in range(self.e)]
        assert sorted(pos) == list(range(self.p)), "a group's positions are not a partition"
        for t, e in enumerate(es):
            for c in range(self.e):
                self.data[swz(self.pos(t, logs, c))] = e[c]

    def load(self, n_threads: int, logs: int) -> list:
        for c in range(self.e):
            check_banks([(t, swz(self.pos(t, logs, c))) for t in range(n_threads)])
        return [[self.data[swz(self.pos(t, logs, c))] for c in range(self.e)]
                for t in range(n_threads)]

    def stage_order(self, dif: bool):
        return range(self.lr - 1, -1, -1) if dif else range(self.lr)

    def group_stages(self, dif: bool, es: list, logs: int) -> None:
        for q in self.stage_order(dif):
            h = 1 << q
            for c in range(self.e):
                if c & h:
                    continue
                js = [((c & (h - 1)) << logs) + (t & ((1 << logs) - 1))
                      for t in range(len(es))]
                m = 1 << (logs + q)
                check_banks([(t, self.twiddle_addr(m, logs + q, j)[1])
                             for t, j in enumerate(js)])
                ws = [self.twiddle(m, logs + q, j) for j in js]
                for t, e in enumerate(es):
                    e[c], e[c + h] = butterfly(dif, e[c], e[c + h], ws[t])

    def first_stages(self, dif: bool, es: list, r0: int) -> None:
        for q in self.stage_order(dif):
            if q >= r0:
                continue
            h = 1 << q
            for c in range(self.e):
                if c & h:
                    continue
                j = c & (h - 1)
                for e in es:
                    if j == 0:
                        e[c], e[c + h] = (e[c] + e[c + h]) % R, (e[c] - e[c + h]) % R
                    else:
                        e[c], e[c + h] = butterfly(dif, e[c], e[c + h], self.twiddle(h, q, j))


def kernel_model(x: list, tw: list, table, dif: bool, p: int, lr: int):
    """One chunk x (p ints, Montgomery form) through ntt_tail_kernel<dif,
    table is not None, lr>: returns the outputs and the products it ran."""
    chunk = Chunk(tw, p, lr)
    logp, e_n = chunk.logp, chunk.e
    groups = (logp + lr - 1) // lr
    r0 = logp - lr * (groups - 1)
    top_logs = r0 + lr * (groups - 2)
    n_threads = max(p // e_n, 1)
    run = [[x[e_n * t + c] if e_n * t + c < p else 0 for c in range(e_n)]
           for t in range(n_threads)]
    products = 0

    def mul_table(es):
        nonlocal products
        for t, e in enumerate(es):
            for c in range(min(e_n, p)):
                e[c] = mont(e[c], table[e_n * t + c])
                products += 1

    if not dif:
        es = run
        if table is not None:
            mul_table(es)
        chunk.first_stages(False, es, r0)
        prev = 0
        for g in range(1, groups):
            logs = r0 + lr * (g - 1)
            chunk.store(es, prev)
            es = chunk.load(n_threads, logs)
            chunk.group_stages(False, es, logs)
            prev = logs
        last = 0 if groups == 1 else top_logs
    else:
        if groups > 1:
            es = [[x[chunk.pos(t, top_logs, c)] for c in range(e_n)] for t in range(n_threads)]
        else:
            es = run
        for g in range(groups - 1, 0, -1):
            logs = r0 + lr * (g - 1)
            if g < groups - 1:
                es = chunk.load(n_threads, logs)
            chunk.group_stages(True, es, logs)
            chunk.store(es, logs)
        if groups > 1:
            es = chunk.load(n_threads, 0)
        chunk.first_stages(True, es, r0)
        if table is not None:
            mul_table(es)
        last = 0
    out = [None] * p
    for t, e in enumerate(es):
        for c in range(e_n):
            pos = chunk.pos(t, last, c)
            if pos < p:
                out[pos] = e[c]
    return out, products + chunk.reads


def _ints(limbs: np.ndarray) -> list:
    return [int(v) for v in FR.decode(torch.from_numpy(limbs.astype(np.int32)), mont=False)]


@pytest.mark.parametrize("p", [2, 4, 8, 16, 32, 128, 512, 1024, 2048])
@pytest.mark.parametrize("direction,fused", [("dif", True), ("dif", False), ("dit", True),
                                             ("dit", False)])
def test_kernel_schedule_equals_plain(p, direction, fused):
    """The kernel's groups, positions, swizzles and twiddle lookups give the
    plain version's integers for one chunk, and run tail_skipped(p) fewer
    products than one per butterfly."""
    rng = np.random.default_rng(p + 3 * fused + (direction == "dif"))
    x = random_mont(rng, (1, p))
    tw = nk._tail_tw(p, direction == "dif", "cpu", p)
    table = random_mont(rng, (p,)) if fused else None
    xt = torch.from_numpy(x.astype(np.int32))
    tt = None if table is None else torch.from_numpy(table.astype(np.int32))
    want = _ints(to_numpy_limbs(nk.ntt_tail_plain(xt, tw, tt, direction, p))[:, 0])
    lr = nk.TAIL_LR
    got, products = kernel_model(_ints(x[:, 0]), _ints(tw.numpy()),
                                 None if table is None else _ints(table), direction == "dif", p,
                                 lr)
    assert got == want
    if p >= 1 << lr:  # below, the one thread also runs its zero padding
        logp = p.bit_length() - 1
        assert products == logp * p // 2 - prof.tail_skipped(p) + (p if fused else 0)
        work = prof.kernel_work("K5", rows=1, n=p, p=p, table=fused)[0]
        assert work == products * prof.MONT_MUL_IMADS


def test_top_table_holds_every_stage():
    """Stage m's twiddle j equals the top stage's twiddle j * P / (2m): the
    kernel stages only the top stage's for m >= 64."""
    for p in CHUNKS:
        for inverse in (False, True):
            tw = to_numpy_limbs(nk._tail_tw(8192, inverse, "cpu", p))
            m = 1
            while m < p:
                idx = np.arange(m) * (p // (2 * m)) + p // 2
                assert np.array_equal(tw[:, m: 2 * m], tw[:, idx])
                m *= 2


# ---------------------------------------------------------------------------
# The coset lift at every chunk against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", CHUNKS)
@pytest.mark.parametrize("n,batch", [(2048, 2), (4096, 1)])
def test_coset_lift_bn_matches_jax(p, n, batch):
    """n = 2048 at P = 2048 is the tail alone; below it and at n = 4096 the
    cross stages (K4) run too."""
    rng = np.random.default_rng(n + p)
    evals = random_mont(rng, (n, batch))
    root = ntt.coset_root_2n(n)
    want = np.asarray(jntt.coset_lift(evals, root))
    t = from_numpy_limbs(evals, "cpu")
    nk.reset_launches()
    got = nk.coset_lift_bn(t.transpose(1, 2).contiguous(), root, p)
    assert nk.launches == {"ntt_cross": 0, "ntt_tail": 0}
    assert np.array_equal(to_numpy_limbs(got.transpose(1, 2)), want)


def test_chunk_is_checked():
    x = torch.zeros((16, 1, 16), dtype=torch.int32)
    for bad in (0, 1, 3, 4096):
        with pytest.raises(ValueError):
            nk.ntt_tail(x, nk._tail_tw(16, False, "cpu"), None, "dit", bad)
    assert nk.tail_size(8192) == nk.TAIL and nk.tail_size(16, 2048) == 16
    # the twiddles are cached per chunk
    assert nk._tail_tw(4096, False, "cpu", 512).shape == (16, 512)
    assert nk._tail_tw(4096, False, "cpu", 2048).shape == (16, 2048)
