"""W2's inversion (csrc/witness_kernels.cu `safegcd_inv`), walked on Python integers.

No CUDA compiler runs here, so this file translates the kernel's C body
step for step into Python: the same signed-30-bit limbs, the same 20
batches of 30 half-delta divsteps on masks, the same update_de / update_fg
/ normalize, e started at R^2 mod r, and the constants read out of the
source. Its 32-bit words wrap as the C's unsigned words do; a signed
operation that would overflow (undefined in C) fails the walk. Every
operation goes through a small word class that tallies it, under the
counting rule of runtime/profiling.SAFEGCD_OPS, so W2's bound is pinned to
the walk's own count. The walk is held against pow(x, -1, r) and against
witness_div_plain (the JAX package's Fermat form) on edge values and a
seeded batch; whole Div groups are held against the host interpreter by
tests/test_torch_witness_depth20_multi.py.
"""

import collections
import contextlib
import functools
import os
import re

import numpy as np
import pytest
import torch

from zerokit_tpu_torch.circuit import witness_kernels as wk
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.runtime import profiling

SRC = open(os.path.join(os.path.dirname(__file__), "..", "zerokit_tpu_torch", "csrc",
                        "witness_kernels.cu")).read()
MONT = 1 << 256
M32 = (1 << 32) - 1


def _int_const(name):
    return int(re.search(r"constexpr (?:int|u32) " + name + r" = (0x[0-9a-f]+|\d+)u?;",
                         SRC).group(1), 0)


def _array(name, n):
    body = re.search(name + r"\[" + str(n) + r"\] = \{([^}]*)\}", SRC).group(1)
    return [int(t.strip().rstrip("u"), 16) for t in body.split(",")]


BATCHES = int(re.search(r"constexpr int kBatches = (\d+), kBatchSteps = (\d+);", SRC).group(1))
STEPS = int(re.search(r"constexpr int kBatches = (\d+), kBatchSteps = (\d+);", SRC).group(2))
M30 = _int_const("kM30")
INV30 = _int_const("kFrInv30")
S30 = _array("kFrS30", 9)
R2 = _array("kFrR2", 8)

# edge divisors: 0, 1, r - 1, one in Montgomery form, every power of two
# below r, values just above r - 2^32, (r +- 1) / 2
EDGES = sorted({0, 1, R - 1, MONT % R, (R - 1) // 2, (R + 1) // 2}
               | {1 << k for k in range(254)}
               | {R - (1 << 32) + k for k in (1, 2, 3, 5, 1 << 16, (1 << 31) + 7)})


def seeded(n, seed=10):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


# -- words that tally their operations ----------------------------------------

TALLY = collections.Counter()
_PHASE = ["layout"]


@contextlib.contextmanager
def phase(name):
    _PHASE.append(name)
    try:
        yield
    finally:
        _PHASE.pop()


def _count(n=1):
    TALLY[_PHASE[-1]] += n


def _v(x):
    return x.v if isinstance(x, Word) else x


class Word:
    """A C integer of BITS bits. The constructor is a cast (free, wraps);
    each operator counts COST and checks the type and, for signed types,
    that the exact result fits (signed overflow is undefined in C)."""

    __slots__ = ("v",)
    BITS, SIGNED, COST = 32, False, 1

    def __init__(self, x):
        x = _v(x) & ((1 << self.BITS) - 1)
        if self.SIGNED and x >> (self.BITS - 1):
            x -= 1 << self.BITS
        self.v = x

    def _op(self, x):
        TALLY[_PHASE[-1]] += self.COST
        if self.SIGNED:
            assert -(1 << (self.BITS - 1)) <= x < 1 << (self.BITS - 1), "signed overflow"
        else:
            x &= (1 << self.BITS) - 1
        w = object.__new__(type(self))
        w.v = x
        return w

    def _other(self, o):
        if type(o) is type(self):
            return o.v
        assert not isinstance(o, Word), (type(self), type(o))
        return o

    def __add__(self, o):
        return self._op(self.v + self._other(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self._op(self.v - self._other(o))

    def __rsub__(self, o):
        return self._op(self._other(o) - self.v)

    def __and__(self, o):
        return self._op(self.v & self._other(o))

    __rand__ = __and__

    def __xor__(self, o):
        return self._op(self.v ^ self._other(o))

    def __rshift__(self, n):
        return self._op(self.v >> n)  # arithmetic for signed, logical for unsigned

    def __lshift__(self, n):
        assert not self.SIGNED, "left shift of a signed value"
        return self._op(self.v << n)

    def __eq__(self, o):
        return self.v == _v(o)


class U32(Word):
    __slots__ = ()


class I32(Word):
    __slots__ = ()
    SIGNED = True


class I64(Word):
    __slots__ = ()
    BITS, SIGNED, COST = 64, True, 2  # lo and hi words


def mul_wide(a, b):
    """(i64)a * b for 32-bit a, b: one 32x32->64 multiply, two words."""
    _count(2)
    return I64(_v(a) * _v(b))


def mad(acc, a, b):
    """acc + (i64)a * b: one 32x32->64 multiply-add (the add fused), two words."""
    assert isinstance(acc, I64)
    _count(2)
    return I64(acc.v + _v(a) * _v(b))


def mad32(a, b, c):
    """a * b + c on 32-bit unsigned words: one multiply-add."""
    _count(1)
    return U32(_v(a) * _v(b) + _v(c))


# -- the kernel's code ---------------------------------------------------------


def to_s30(w):
    """8 words -> 9 limbs of 30 bits (layout, not counted)."""
    x, acc, bits, k = [], 0, 0, 0
    for _ in range(9):
        if k < 8:
            acc |= w[k] << bits
            k += 1
            bits += 32
        x.append(I32(acc & M30))
        acc >>= 30
        bits -= 30
    return x


def from_s30(x):
    """9 limbs in [0, 2^30) -> 8 words (layout, not counted)."""
    w, acc, bits = [], 0, 0
    for limb in x:
        assert 0 <= limb.v <= M30
        acc |= limb.v << bits
        bits += 30
        if bits >= 32:
            w.append(acc & M32)
            acc >>= 32
            bits -= 32
    assert len(w) == 8 and acc == 0
    return w


def divsteps30(zeta, f, g):
    u, v, q, r = U32(1), U32(0), U32(0), U32(1)
    for _ in range(STEPS):
        c1 = U32(zeta >> 31)
        c2 = 0 - (g & 1)
        x, y, z = (f ^ c1) - c1, (u ^ c1) - c1, (v ^ c1) - c1
        g += x & c2
        q += y & c2
        r += z & c2
        c1 &= c2
        zeta = (zeta ^ I32(c1)) - 1
        f += g & c1
        u += q & c1
        v += r & c1
        g >>= 1
        u <<= 1
        v <<= 1
    return zeta, (I32(u), I32(v), I32(q), I32(r))


def update_de(d, e, t):
    tu, tv, tq, tr = t
    sd, se = d[8] >> 31, e[8] >> 31
    md = (tu & sd) + (tv & se)
    me = (tq & sd) + (tr & se)
    cd = mad(mul_wide(tu, d[0]), tv, e[0])
    ce = mad(mul_wide(tq, d[0]), tr, e[0])
    md -= I32(mad32(INV30, U32(cd), U32(md)) & M30)
    me -= I32(mad32(INV30, U32(ce), U32(me)) & M30)
    cd = mad(cd, S30[0], md)
    ce = mad(ce, S30[0], me)
    assert cd.v & M30 == 0 and ce.v & M30 == 0
    cd >>= 30
    ce >>= 30
    for i in range(1, 9):
        cd = mad(mad(mad(cd, tu, d[i]), tv, e[i]), S30[i], md)
        ce = mad(mad(mad(ce, tq, d[i]), tr, e[i]), S30[i], me)
        d[i - 1] = I32(cd) & M30
        e[i - 1] = I32(ce) & M30
        cd >>= 30
        ce >>= 30
    d[8] = I32(cd)
    e[8] = I32(ce)


def update_fg(f, g, t):
    tu, tv, tq, tr = t
    cf = mad(mul_wide(tu, f[0]), tv, g[0])
    cg = mad(mul_wide(tq, f[0]), tr, g[0])
    assert cf.v & M30 == 0 and cg.v & M30 == 0
    cf >>= 30
    cg >>= 30
    for i in range(1, 9):
        cf = mad(mad(cf, tu, f[i]), tv, g[i])
        cg = mad(mad(cg, tq, f[i]), tr, g[i])
        f[i - 1] = I32(cf) & M30
        g[i - 1] = I32(cg) & M30
        cf >>= 30
        cg >>= 30
    f[8] = I32(cf)
    g[8] = I32(cg)


def normalize(x, sign):
    add = x[8] >> 31
    for i in range(9):
        x[i] += S30[i] & add
    neg = sign >> 31
    for i in range(9):
        x[i] = (x[i] ^ neg) - neg
    for i in range(8):
        x[i + 1] += x[i] >> 30
        x[i] &= M30
    add = x[8] >> 31
    for i in range(9):
        x[i] += S30[i] & add
    for i in range(8):
        x[i + 1] += x[i] >> 30
        x[i] &= M30


def s30_value(x):
    return sum(limb.v << (30 * i) for i, limb in enumerate(x))


def safegcd_inv(b):
    """The kernel's safegcd_inv on the canonical integer b (a Montgomery
    form bR): (b^-1 R^2 mod r, 0 for b = 0; the final f and g; the
    tally of this call's operations by phase)."""
    TALLY.clear()
    words = [(b >> (32 * i)) & M32 for i in range(8)]
    d, e = [I32(0)] * 9, to_s30(R2)
    f, g = [I32(s) for s in S30], to_s30(words)
    zeta = I32(-1)
    for _ in range(BATCHES):
        with phase("divsteps"):
            zeta, t = divsteps30(zeta, U32(f[0]), U32(g[0]))
        with phase("update_de"):
            update_de(d, e, t)
        with phase("update_fg"):
            update_fg(f, g, t)
    with phase("normalize"):
        normalize(d, f[8])
    out = sum(w << (32 * i) for i, w in enumerate(from_s30(d)))
    return out, s30_value(f), s30_value(g), dict(TALLY)


@functools.lru_cache(maxsize=None)
def inverse(b):
    """safegcd_inv(b), once per b."""
    return safegcd_inv(b)


def divsteps_to_zero(x):
    """Half-delta divsteps on whole integers from (zeta, f, g) = (-1, r, x)
    (Wuille's Python form): how many until g = 0."""
    zeta, f, g, n = -1, R, x, 0
    while g:
        if zeta < 0 and g & 1:
            zeta, f, g = -zeta - 2, g, (g - f) // 2
        elif g & 1:
            zeta, g = zeta - 1, (g + f) // 2
        else:
            zeta, g = zeta - 1, g // 2
        n += 1
    return n


# -- tests ---------------------------------------------------------------------


def test_source_constants():
    assert s30_value([I32(s) for s in S30]) == R and all(0 <= s <= M30 for s in S30[:8])
    assert INV30 * R % (1 << 30) == 1 and INV30 == pow(R, -1, 1 << 30)
    assert sum(w << (32 * i) for i, w in enumerate(R2)) == MONT * MONT % R
    assert M30 == (1 << 30) - 1
    assert BATCHES * STEPS == 600 >= 590  # the divstep bound for moduli below 2^256


def test_the_kernel_inverts_by_safegcd_without_branches():
    """W2 calls safegcd_inv; its divsteps, updates and normalisation hold no
    branch, select or loop bound that could depend on the divisor."""
    kernel = SRC[SRC.index("witness_div_kernel("):]
    assert "mul(a, safegcd_inv(b))" in kernel[:kernel.index("}  // namespace")]
    for fn in ("divsteps30", "update_de", "update_fg", "normalize", "safegcd_inv"):
        start = SRC.index(f" {fn}(")
        body = SRC[SRC.index("{", start):SRC.index("\n}\n", start)]
        for token in ("if ", "if(", "?", "while", "break", "&&", "||"):
            assert token not in body, (fn, token)
        loops = re.findall(r"for \(int i = (\d+); i < (\w+); i\+\+\)", body)
        assert all(bound in ("8", "9", "kBatches", "kBatchSteps") for _, bound in loops), loops
    assert "fermat" not in SRC and "kFrPm2" not in SRC


@pytest.mark.parametrize("bs", [EDGES, seeded(256)], ids=["edges", "seeded256"])
def test_walk_equals_pow(bs):
    """A stored divisor b is the Montgomery form of x = b R^-1; the walk
    gives x^-1 R = R^2 b^-1, whose value read back (times R^-1) is
    pow(x, -1, r); inv(0) = 0. g reaches 0 within 590 divsteps and f ends
    at +-1."""
    rinv = pow(MONT, -1, R)
    for b in bs:
        got, f, g, _ = inverse(b)
        x = b * rinv % R
        assert got * rinv % R == (pow(x, -1, R) if x else 0), b
        assert g == 0 and f in ((1, -1) if b else (R,)), b
        assert divsteps_to_zero(b) <= 590


def test_inverse_of_zero_is_zero():
    got, f, g, _ = safegcd_inv(0)
    assert (got, f, g) == (0, R, 0)


def test_walk_equals_witness_div_plain():
    """a / b on the slot buffer, as W2 computes it (the walk's inverse, then
    the Montgomery product by a), against witness_div_plain, the JAX
    package's Fermat form, on the edge divisors and 256 seeded ones."""
    bs = EDGES + seeded(256)
    as_ = seeded(len(bs), seed=12)
    n = len(bs)
    vals = as_ + bs + [0] * n
    words = torch.tensor([[(v >> (32 * i)) & M32 for i in range(8)] for v in vals],
                         dtype=torch.int64)
    buf = (words - ((words >> 31) << 32)).to(torch.int32)[None].contiguous()
    ia = torch.arange(n, dtype=torch.int32)
    wk.witness_div_plain(buf, ia, ia + n, ia + 2 * n)
    got = buf[0, 2 * n:].to(torch.int64) & M32
    plain = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in got]
    rinv = pow(MONT, -1, R)
    want = [a * inverse(b)[0] * rinv % R for a, b in zip(as_, bs)]
    assert plain == want


def test_the_tally_is_the_bound():
    """Every input takes the same operations, and their count by phase is
    runtime/profiling's W2 count."""
    tallies = {tuple(sorted(safegcd_inv(x)[3].items())) for x in (0, 1, R - 1, 1 << 200)}
    assert len(tallies) == 1
    tally = dict(tallies.pop())
    assert tally == {
        "divsteps": profiling.SAFEGCD_BATCHES * profiling.SAFEGCD_BATCH_STEPS
        * profiling.SAFEGCD_DIVSTEP_OPS,
        "update_de": profiling.SAFEGCD_BATCHES * profiling.SAFEGCD_UPDATE_DE_OPS,
        "update_fg": profiling.SAFEGCD_BATCHES * profiling.SAFEGCD_UPDATE_FG_OPS,
        "normalize": profiling.SAFEGCD_NORMALIZE_OPS,
    }
    assert (profiling.SAFEGCD_BATCHES, profiling.SAFEGCD_BATCH_STEPS) == (BATCHES, STEPS)
    assert sum(tally.values()) == profiling.SAFEGCD_OPS


@pytest.mark.parametrize("mutation", ["inv30", "e_start", "steps"])
def test_mutations_are_caught(mutation, monkeypatch):
    """A wrong r^-1 mod 2^30, e started at 1, or 480 divsteps (these
    inputs need 502-508): each breaks the walk."""
    g = globals()
    if mutation == "inv30":
        monkeypatch.setitem(g, "INV30", INV30 + 2)
    elif mutation == "e_start":
        monkeypatch.setitem(g, "R2", [1] + [0] * 7)
    else:
        monkeypatch.setitem(g, "BATCHES", 16)
    bad = 0
    for x in (1, R - 1, (R + 1) // 2, 1 << 253, R - (1 << 32) + 1):
        try:
            bad += safegcd_inv(x * MONT % R)[0] != pow(x, -1, R) * MONT % R
        except AssertionError:
            bad += 1
    assert bad
