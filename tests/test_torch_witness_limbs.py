"""W1's rich-op limb code (csrc/witness_kernels.cu), modelled on Python integers.

The kernel runs Shr, Band/Bor/Bxor and the signed comparisons on canonical
values as eight 32-bit words: a barrel shifter of eight constant-shift
stages built from funnel shifts, a conditional subtraction of p through a
sub.cc borrow, and 256-bit compares by the borrow of a subtraction. The
plain version works on sixteen 16-bit limbs, so this file runs the
kernel's word code, stage by stage as the source writes it, on the
operands' edge values and holds it against witness_host.eval_duo; a
mutated model must fail on the same values. It also reads the kernel's
constants and op codes out of the source and checks them.
"""

import os
import re

import pytest

from zerokit_tpu_torch.circuit import graph as gm
from zerokit_tpu_torch.circuit import witness_eval as we
from zerokit_tpu_torch.circuit import witness_host as wh
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.runtime import profiling

SRC = open(os.path.join(os.path.dirname(__file__), "..", "zerokit_tpu_torch", "csrc",
                        "witness_kernels.cu")).read()
M32 = 0xFFFFFFFF

EDGES = [0, 1, 2, R - 1, R - 2, (R - 1) // 2, (R + 1) // 2, (R - 3) // 2, 253, 254, 255, 256,
         31, 32, 33, 1 << 16, (1 << 16) + 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 5,
         (1 << 253) + 7, 0xFFFFFFFF << 200, 0x123456789ABCDEF << 64]


def words(x):
    return [(x >> (32 * i)) & M32 for i in range(8)]


def value(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


def const_words(name):
    body = re.search(name + r"\[8\] = \{([^}]*)\}", SRC).group(1)
    return [int(t.strip().rstrip("u"), 16) for t in body.split(",")]


# -- the kernel's word code --------------------------------------------------


def sub8(r, b):
    """(r - b mod 2^256 as words, borrow mask): sub.cc/subc chain."""
    d = value(r) - value(b)
    return words(d % (1 << 256)), M32 if d < 0 else 0


def lt256(a, b):
    return sub8(a, b)[1] != 0


def signed_lt(a, b):
    half = const_words("kFrHalf")
    a_neg, b_neg = lt256(half, a), lt256(half, b)
    return lt256(a, b) if a_neg == b_neg else a_neg


def funnelshift_r(lo, hi, bit):
    return ((hi << 32 | lo) >> (bit & 31)) & M32


def shr_const(x, s):
    off, bit = divmod(s, 32)
    out = []
    for i in range(8):
        lo = x[i + off] if i + off < 8 else 0
        hi = x[i + off + 1] if i + off + 1 < 8 else 0
        out.append(funnelshift_r(lo, hi, bit) if bit else lo)
    return out


def shr_canon(x, b, threshold=254, stages=8, high_words=True):
    big = (high_words and any(b[1:])) or b[0] >= threshold
    s = b[0]
    for k in range(stages):
        if s & (1 << k):
            x = shr_const(x, 1 << k)
    return [0] * 8 if big else x


def bitwise_fix(d):
    p = words(R)
    e, borrow = sub8(d, p)
    return e if borrow == 0 and d != p else d


def rich_model(op, a, b, **mutation):
    """The canonical result the kernel's rich_op stores (its to_mont and the
    store's canonicalisation reduce the word result mod p)."""
    aw, bw = words(a), words(b)
    if op == gm.OP_SHR:
        return value(shr_canon(aw, bw, **mutation)) % R
    if op in (gm.OP_BAND, gm.OP_BOR, gm.OP_BXOR):
        fn = {gm.OP_BAND: int.__and__, gm.OP_BOR: int.__or__, gm.OP_BXOR: int.__xor__}[op]
        return value(bitwise_fix([fn(x, y) for x, y in zip(aw, bw)])) % R
    lt = {gm.OP_LT: signed_lt(aw, bw), gm.OP_GT: signed_lt(bw, aw),
          gm.OP_LEQ: not signed_lt(bw, aw), gm.OP_GEQ: not signed_lt(aw, bw)}[op]
    return int(lt)


RICH = [gm.OP_SHR, gm.OP_BAND, gm.OP_BOR, gm.OP_BXOR, gm.OP_LT, gm.OP_GT, gm.OP_LEQ, gm.OP_GEQ]


@pytest.mark.parametrize("op", RICH, ids=[gm.DUO_OP_NAMES[o] for o in RICH])
def test_word_code_equals_host(op):
    undefined = 0
    for a in EDGES:
        for b in EDGES:
            try:
                want = wh.eval_duo(op, a, b)
            except wh.WitnessCalcError:  # a bitwise result of exactly p
                undefined += 1
                assert rich_model(op, a, b) == 0  # p, to Montgomery form: 0
                continue
            assert rich_model(op, a, b) == want, (a, b)
    # Bor and Bxor of p - 1 and 1, either way round, are p
    assert undefined == (2 if op in (gm.OP_BOR, gm.OP_BXOR) else 0)


@pytest.mark.parametrize("mutation", [{"high_words": False}, {"threshold": 253}, {"stages": 7}])
def test_shr_mutations_are_caught(mutation):
    """(A clamp at 255 would not be one: a canonical value >> 254 is 0.)"""
    bad = [(a, b) for a in EDGES for b in EDGES
           if rich_model(gm.OP_SHR, a, b, **mutation) != wh.eval_duo(gm.OP_SHR, a, b)]
    assert bad


def test_kernel_constants():
    assert value(const_words("kFrOne")) == (1 << 256) % R
    assert value(const_words("kFrR2")) == (1 << 512) % R
    assert value(const_words("kFrHalf")) == (R - 1) // 2
    # W2's safegcd: r in signed-30-bit limbs and r^-1 mod 2^30
    limbs = [int(t, 16) for t in re.search(r"kFrS30\[9\] = \{([^}]*)\}", SRC).group(1).split(",")]
    assert sum(v << (30 * i) for i, v in enumerate(limbs)) == R
    inv30 = int(re.search(r"constexpr u32 kFrInv30 = (0x[0-9a-f]+)u;", SRC).group(1), 16)
    assert inv30 * R % (1 << 30) == 1


def test_kernel_op_codes_equal_the_compiler():
    body = re.search(r"enum : int \{([^}]*)\}", SRC).group(1)
    names = [t.split("=")[0].strip() for t in body.split(",") if t.strip()]
    assert [getattr(we, n) for n in names] == list(range(we.N_RICH))
    assert re.search(r"constexpr int kW = (\d+);", SRC).group(1) == str(we.W)


def test_div_product_count():
    """W2: the safegcd inverse's 20 batches of 30 divsteps, then a * b^-1,
    one CIOS product."""
    assert "constexpr int kBatches = 20, kBatchSteps = 30;" in SRC
    assert "mul(a, safegcd_inv(b))" in SRC
    assert profiling.WITNESS_DIV_OPS == profiling.SAFEGCD_OPS + profiling.MONT_MUL_IMADS


def test_witness_kernel_work():
    ops = {we.F_MUL: 10, we.F_ADD: 6, we.F_SHR: 2, we.F_LT: 1, we.F_TERN: 3}
    imads, nbytes = profiling.kernel_work("W1", ops=ops, steps=7, lanes=16, reads=5)
    assert imads == (10 + 3 * 2 + 2 * 1) * 16 * profiling.MONT_MUL_IMADS
    assert nbytes == 7 * 4 * 16 + (5 + 22) * 16 * 32
    imads, nbytes = profiling.kernel_work("W2", divs=3, lanes=16)
    assert imads == 3 * 16 * (22265 + profiling.MONT_MUL_IMADS)
    assert nbytes == 3 * 12 + 3 * 3 * 32 * 16
