"""K6, the tensor-core Montgomery product, against the JAX tool's arithmetic.

tools/mxu_mont_prototype.py's RowFieldMXU runs its reduction's two constant
multiplies as bf16 byte-Toeplitz matmuls; outside Pallas it runs eagerly on
XLA/CPU. The port's plain version of K6 repeats that byte formulation in
float64 matmuls, which CPU tensors take. The same seeded numpy limbs go
through both; every comparison is on integers, with no tolerance.
"""

import functools
import importlib.util
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.ff.field import FQ
from zerokit_tpu_torch.tools import tc_mont_prototype as tc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 128  # (8, 16) rows on the JAX side


@functools.lru_cache(maxsize=None)
def jax_tool():
    """tools/mxu_mont_prototype.py, loaded by path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "mxu_mont_prototype", os.path.join(REPO, "tools", "mxu_mont_prototype.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_limbs(seed: int, n: int = LANES) -> np.ndarray:
    """(16, n) uint32 limbs of seeded values < q; 0, 1 and q-1 in lanes 0-2."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= (FQ.p >> 240) & 0xFFFF
    for j, v in enumerate((0, 1, FQ.p - 1)):
        limbs[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return limbs


def to_rows(arr: np.ndarray):
    return [jnp.asarray(arr[i].reshape(8, -1)) for i in range(16)]


def from_rows(rows) -> np.ndarray:
    return np.stack([np.asarray(r).reshape(-1) for r in rows])


def to_torch(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32))


def test_tables_equal_toeplitz_bytes():
    mod = jax_tool()
    rf = mod.ROW_FQ_MXU
    assert tc.T_NINV.dtype == np.uint8 and tc.T_NINV.shape == (32, 32)
    assert tc.T_Q.dtype == np.uint8 and tc.T_Q.shape == (32, 64)
    assert np.array_equal(tc.T_NINV, mod._toeplitz_bytes(FQ.ninv_limbs, 32))
    assert np.array_equal(tc.T_Q, mod._toeplitz_bytes(FQ.p_limbs, 64))
    assert np.array_equal(tc.T_NINV, rf.np_t_ninv[:, :32])
    assert np.array_equal(tc.T_Q, rf.np_t_p)


@pytest.mark.parametrize("which", ["ninv", "q"])
def test_const_mul_columns_equal_jax(which):
    """The 16-bit column accumulators of one constant multiply equal
    _const_mul_mxu's."""
    rf = jax_tool().ROW_FQ_MXU
    table, np_table, n16 = {"ninv": (tc.T_NINV, rf.np_t_ninv[:, :32], 16),
                            "q": (tc.T_Q, rf.np_t_p, 32)}[which]
    limbs = seeded_limbs(31)
    want = from_rows(rf._const_mul_mxu(to_rows(limbs), jnp.asarray(np_table, jnp.bfloat16), n16))
    got = tc.const_mul_columns(to_torch(limbs), torch.from_numpy(table))
    assert got.shape == (n16, LANES)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_products_equal_jax_tool():
    rf = jax_tool().ROW_FQ_MXU
    rf.set_toeplitz(jnp.asarray(rf.np_t_ninv[:, :32], jnp.bfloat16),
                    jnp.asarray(rf.np_t_p, jnp.bfloat16))
    a = seeded_limbs(41)
    b = seeded_limbs(42)[:, ::-1].copy()  # q-1, 1, 0 meet every value of a
    want = from_rows(rf.mul(to_rows(a), to_rows(b)))
    got = tc.mont_mul_tc(to_torch(a), to_torch(b))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    r_inv = pow(1 << 256, -1, FQ.p)
    xs = FQ.decode(to_torch(a), mont=False)
    ys = FQ.decode(to_torch(b), mont=False)
    zs = FQ.decode(got, mont=False)
    assert all(int(z) == int(x) * int(y) * r_inv % FQ.p for x, y, z in zip(xs, ys, zs))


def test_plain_equals_k1_plain():
    a = to_torch(seeded_limbs(51, 1000))
    b = to_torch(seeded_limbs(52, 1000)[:, ::-1].copy())
    assert torch.equal(tc.mont_mul_tc_plain(a, b), fk.mont_mul_plain("fq", a, b))


def test_wrapper_takes_plain_on_cpu_and_checks_inputs():
    tc.reset_launches()
    a = to_torch(seeded_limbs(61, 64))
    b = to_torch(seeded_limbs(62, 64))
    assert torch.equal(tc.mont_mul_tc(a, b), tc.mont_mul_tc_plain(a, b))
    assert tc.launches["mont_mul_tc"] == 0
    with pytest.raises(ValueError):
        tc.mont_mul_tc(a, b[:, :32])
    with pytest.raises(ValueError):
        tc.mont_mul_tc(a.reshape(16, 8, 8), b.reshape(16, 8, 8))
    with pytest.raises(TypeError):
        tc.mont_mul_tc(a.to(torch.int64), b.to(torch.int64))


# ---------------------------------------------------------------------------
# The kernel's fold from the tensor-core accumulators, on Python integers
# ---------------------------------------------------------------------------
#
# csrc/mont_tc.cu: a row's column sums lie on the 4 threads of a quad, thread
# j holding columns 8i + 2j + e (e = 0, 1) of each of its 4 rows. `partial`
# makes each thread's exact W-word number of one row, `quad_fold` sums the
# four threads' numbers by a reduce-scatter with carry-chain adds, leaving
# thread j with row j. The model below is that code line by line; `drop`
# removes one carry of one chain, which the edge inputs must notice.

MASK = (1 << 32) - 1


def add_chain(r, b, drop=None):
    """r += b word by word with a carry (PTX add.cc/addc); drop = index of
    a word whose carry out is lost."""
    carry, out = 0, []
    for i, (x, y) in enumerate(zip(r, b)):
        s = x + y + carry
        out.append(s & MASK)
        carry = 0 if i == drop else s >> 32
    return out


def partial_words(c, j, w):
    """partial<W>: thread j's columns c[2i + e] = column 8i + 2j + e."""
    odd, sh = j >> 1, 16 * (j & 1)
    p = [0] * w
    for i in range(w // 2):
        v = (c[2 * i] << sh) + (c[2 * i + 1] << (sh + 8))
        lo, hi = v & MASK, v >> 32
        p[2 * i] = p[2 * i] if odd else lo
        p[2 * i + 1] = lo if odd else hi
        if 2 * i + 2 < w:
            p[2 * i + 2] = hi if odd else p[2 * i + 2]
    return p


def quad_fold(p, w, drop=None):
    """quad_fold<W> over the 4 threads: p[j][a] is thread j's partial of row
    a; returns out[j], thread j's sum of row j. drop = (round, word)."""
    keep = [[None, None] for _ in range(4)]
    for j in range(4):  # round 1: xor 1
        for b in range(2):
            give = p[j ^ 1][2 * b + (j & 1)]  # the partner gives the row j keeps
            keep[j][b] = add_chain(p[j][2 * b + (j & 1)], give,
                                   drop[1] if drop and drop[0] == 1 else None)
    out = []
    for j in range(4):  # round 2: xor 2
        give = keep[j ^ 2][j >> 1]
        out.append(add_chain(keep[j][j >> 1], give, drop[1] if drop and drop[0] == 2 else None))
    return out


def words(v, w):
    return [(v >> (32 * i)) & MASK for i in range(w)]


def value(ws):
    return sum(x << (32 * i) for i, x in enumerate(ws))


def byte_columns(v, table):
    """The tensor cores' output: byte columns of v's 32 low bytes @ table."""
    return [int(x) for x in np.array([(v >> (8 * k)) & 0xFF for k in range(32)], np.int64)
            @ table.astype(np.int64)]


def kernel_reduce(ts, drop=None):
    """The kernel's reduction of the 4 rows of one quad with products ts:
    the n' columns folded into m, m's q columns folded and t added; returns
    each row's u / 2^256 (below 2q)."""
    fold_drop = drop if drop and drop[0] in (1, 2) else None
    cols_n = [byte_columns(t % (1 << 256), tc.T_NINV) for t in ts]
    m = quad_fold([[partial_words([cols_n[a][8 * i + 2 * j + e] for i in range(4)
                                   for e in range(2)], j, 8) for a in range(4)]
                   for j in range(4)], 8, fold_drop if drop and drop[2] == "m" else None)
    cols_q = [byte_columns(value(m[a]), tc.T_Q) for a in range(4)]
    s = quad_fold([[partial_words([cols_q[a][8 * i + 2 * j + e] for i in range(8)
                                   for e in range(2)], j, 16) for a in range(4)]
                   for j in range(4)], 16, fold_drop if drop and drop[2] == "u" else None)
    u = [add_chain(s[a], words(ts[a], 16), drop[1] if drop and drop[0] == 3 else None)
         for a in range(4)]
    return [value(x) >> 256 for x in u]


def plain_reduce(t: int) -> int:
    """The plain version's arithmetic on one t: const_mul_columns' 16-bit
    accumulators, normalised; u / 2^256."""
    tl = torch.tensor([[(t >> (16 * i)) & 0xFFFF] for i in range(16)], dtype=torch.int64)
    m = sum(int(c) << (16 * i) for i, c in enumerate(
        tc.const_mul_columns(tl, torch.from_numpy(tc.T_NINV))[:, 0])) % (1 << 256)
    ml = torch.tensor([[(m >> (16 * i)) & 0xFFFF] for i in range(16)], dtype=torch.int64)
    mq = sum(int(c) << (16 * i) for i, c in enumerate(
        tc.const_mul_columns(ml, torch.from_numpy(tc.T_Q))[:, 0]))
    u = t + mq
    assert u % (1 << 256) == 0
    return u >> 256


q = FQ.p
EDGE_TS = [0, 1, (q - 1) ** 2, (1 << 256) - 1, (q - 1) * 1, ((1 << 256) - 1) + (5 << 256),
           (q - 1) ** 2 // 3, q * (q - 2)]


@pytest.mark.parametrize("rows", range(0, len(EDGE_TS) + 1, 4))
def test_fold_model_equals_plain(rows):
    """The kernel's fold gives the plain version's u / 2^256 on edge values
    of t (0, 1, (q-1)^2, all-0xFF low bytes) and seeded ones."""
    rng = random.Random(rows)
    ts = EDGE_TS[rows: rows + 4]
    ts += [rng.randrange(q) * rng.randrange(q) for _ in range(4 - len(ts))]
    got = kernel_reduce(ts)
    for t, g in zip(ts, got):
        assert g == plain_reduce(t) and g < 2 * q
        assert g % q == t * pow(1 << 256, -1, q) % q


# (chain, word, fold): chain 1 and 2 are the reduce-scatter's rounds, 3 the
# add of t. The m fold's second-round carries need two partial words that
# sum past 2^32 (about 2^-18 a word on seeded values) and are not reached.
MUTATIONS = ([(1, w, "m") for w in (2, 4, 6)] + [(1, w, "u") for w in (3, 5, 9)]
             + [(2, w, "u") for w in (1, 4, 7)] + [(3, w, "u") for w in (0, 7, 14)])


@pytest.mark.parametrize("mut", MUTATIONS)
def test_fold_model_detects_a_dropped_carry(mut):
    """Mutation check: with one carry dropped, the model differs from the
    plain version on the edge rows or on one of 60 seeded quads."""
    rng = random.Random(str(mut))
    quads = [EDGE_TS[:4], EDGE_TS[4:8]]
    quads += [[rng.randrange(q) * rng.randrange(q) for _ in range(4)] for _ in range(60)]
    for ts in quads:
        if kernel_reduce(ts, mut) != [plain_reduce(t) for t in ts]:
            return
    pytest.fail(f"dropping carry {mut} went unnoticed")


def img_off(row: int, k: int) -> int:
    """csrc/mont_tc.cu img_off."""
    return (row >> 3) * 256 + (k >> 4) * 128 + (row & 7) * 16 + (k & 15)


@pytest.mark.parametrize("which", ["ninv", "q"])
def test_smem_image_holds_the_b_fragments(which):
    """The kernel copies smem_image into shared memory and loads each
    lane's mma.sync B fragment of n-tile nt as the 4 bytes at img_off(column,
    k) and at k + 16 (column 8 nt + lane / 4, k = 4 (lane % 4)): they must be
    the table's rows k .. k+3 of that column, every byte placed once."""
    table = {"ninv": tc.T_NINV, "q": tc.T_Q}[which]
    img = tc.smem_image(table)
    cols = table.shape[1]
    assert img.shape == (cols * 32,)
    assert sorted(img_off(n, k) for n in range(cols) for k in range(32)) == list(range(cols * 32))
    for nt in range(cols // 8):
        for lane in range(32):
            col, k = 8 * nt + lane // 4, 4 * (lane % 4)
            for kk in (k, k + 16):
                assert list(img[img_off(col, kk): img_off(col, kk) + 4]) == list(
                    table[kk: kk + 4, col])
