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
