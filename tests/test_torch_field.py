"""zerokit_tpu_torch field arithmetic against the JAX package, exactly.

The same seeded numpy limbs go through the JAX FrField/FqField (and once
through the Pallas multiply kernel in interpret mode) and through the port's
Field ops, whose products are the K1 wrapper's plain version on CPU tensors.
Every comparison is on integers: no tolerance.
"""

import zlib

import numpy as np
import pytest
import torch

from zerokit_tpu.ff import field as jfield
from zerokit_tpu.ff import fq2 as jfq2
from zerokit_tpu.ff import pallas_field
from zerokit_tpu.hostmath import bn254
from zerokit_tpu_torch.ff import field as tfield
from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.ff import fq2 as tfq2

torch.set_num_threads(1)

SPECS = {"fr": tfield.FR, "fq": tfield.FQ}
PORT = {"fr": tfield.FrField, "fq": tfield.FqField}
JAX = {"fr": jfield.FrField, "fq": jfield.FqField}


def random_limbs(rng, p: int, n: int) -> np.ndarray:
    """(16, n) uint32 limbs of seeded values < p, with 0, 1, p-1 and p-2
    in the first lanes."""
    top = (p >> 240) & 0xFFFF
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= top
    for j, v in enumerate((0, 1, p - 1, p - 2)):
        limbs[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return limbs


def port_tensor(arr):
    return tfield.from_numpy_limbs(arr, "cpu")


def test_numpy_limbs_round_trip():
    rng = np.random.default_rng(1)
    arr = random_limbs(rng, tfield.FQ.p, 64)
    t = port_tensor(arr)
    assert t.dtype == torch.int32 and tuple(t.shape) == (16, 64)
    back = tfield.to_numpy_limbs(t)
    assert back.dtype == np.uint32 and np.array_equal(back, arr)
    with pytest.raises(ValueError):
        tfield.from_numpy_limbs(np.full((16, 1), 1 << 16, dtype=np.uint32), "cpu")


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_encode_decode_match_jax(name):
    spec = SPECS[name]
    rng = np.random.default_rng(2)
    vals = [int(v) for v in spec.decode(port_tensor(random_limbs(rng, spec.p, 40)), mont=False)]
    for mont in (True, False):
        want = np.asarray(getattr(jfield, name.upper()).encode(vals, mont=mont))
        got = spec.encode(vals, mont=mont)
        assert np.array_equal(tfield.to_numpy_limbs(got), want)
        assert list(spec.decode(got, mont=mont)) == vals


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg", "to_mont", "from_mont"])
@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_op_matches_jax(name, op):
    spec = SPECS[name]
    rng = np.random.default_rng(zlib.crc32(f"{name} {op}".encode()))
    a = random_limbs(rng, spec.p, 700)
    b = random_limbs(rng, spec.p, 700)[:, ::-1].copy()
    port, jax_field = PORT[name], JAX[name]
    if op in ("mul", "add", "sub"):
        got = getattr(port, op)(port_tensor(a), port_tensor(b))
        want = getattr(jax_field, op)(a, b)
    else:
        got = getattr(port, op)(port_tensor(a))
        want = getattr(jax_field, op)(a)
    assert np.array_equal(tfield.to_numpy_limbs(got), np.asarray(want))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_inv_select_and_plain_field(name):
    spec = SPECS[name]
    rng = np.random.default_rng(3)
    a = port_tensor(random_limbs(rng, spec.p, 24))
    vals = spec.decode(a)
    inv = spec.decode(PORT[name].inv(a))
    assert list(inv) == [pow(int(v), -1, spec.p) if v else 0 for v in vals]
    plain = tfield.FrPlain if name == "fr" else tfield.FqPlain
    b = a.flip(1).contiguous()
    assert torch.equal(plain.mul(a, b), PORT[name].mul(a, b))
    cond = torch.arange(24) % 3 == 0
    sel = PORT[name].select(cond, a, b)
    assert torch.equal(sel[:, cond], a[:, cond]) and torch.equal(sel[:, ~cond], b[:, ~cond])


def test_mont_mul_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(4)
    a = port_tensor(random_limbs(rng, tfield.FR.p, 32)).reshape(16, 4, 8)
    b = port_tensor(random_limbs(rng, tfield.FR.p, 32)).reshape(16, 4, 8)
    fk.reset_launches()
    got = fk.mont_mul("fr", a, b)
    assert fk.launches["mont_mul"] == 0
    assert got.shape == a.shape
    assert torch.equal(got, fk.mont_mul_plain("fr", a, b))
    assert torch.equal(fk.mont_from("fr", got), fk.mont_from_plain("fr", got))
    with pytest.raises(ValueError):
        fk.mont_mul("fr", a, b[:, :2])


def test_mont_mul_matches_pallas_kernel_interpreted(monkeypatch):
    """The K1 plain version against the TPU kernel itself, run by the Pallas
    interpreter on the CPU."""
    monkeypatch.setattr(pallas_field, "_FORCE_INTERPRET", True)
    rng = np.random.default_rng(5)
    a = random_limbs(rng, tfield.FR.p, 4096)
    b = random_limbs(rng, tfield.FR.p, 4096)[:, ::-1].copy()
    want = np.asarray(pallas_field.mont_mul("fr", a, b))
    got = fk.mont_mul("fr", port_tensor(a), port_tensor(b))
    assert np.array_equal(tfield.to_numpy_limbs(got), want)


def _fq2_values(rng, n):
    """n seeded Fq2 elements as (c0, c1) integer pairs."""
    flat = tfield.FQ.decode(port_tensor(random_limbs(rng, tfield.FQ.p, 2 * n)), mont=False)
    return [(int(flat[2 * i]), int(flat[2 * i + 1])) for i in range(n)]


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fq2_matches_jax_and_host(op):
    rng = np.random.default_rng(6)
    xs = [(0, 0), (1, 0), (0, 1), (tfield.FQ.p - 1, tfield.FQ.p - 1)] + _fq2_values(rng, 60)
    ys = list(reversed(xs))
    a = tfq2.Fq2Adapter.encode(xs)
    b = tfq2.Fq2Adapter.encode(ys)
    ja = jfq2.Fq2Adapter.encode(xs)
    jb = jfq2.Fq2Adapter.encode(ys)
    assert np.array_equal(tfield.to_numpy_limbs(a), np.asarray(ja))
    if op == "mul":
        got = tfq2.Fq2Adapter.mul(a, b)
        want = jfq2.Fq2Adapter.mul(ja, jb)
        host = [bn254.fq2_mul(x, y) for x, y in zip(xs, ys)]
    else:
        got = tfq2.Fq2Adapter.sqr(a)
        want = jfq2.Fq2Adapter.sqr(ja)
        host = [bn254.fq2_sqr(x) for x in xs]
    assert np.array_equal(tfield.to_numpy_limbs(got), np.asarray(want))
    assert tfq2.Fq2Adapter.decode(got) == host
    assert torch.equal(getattr(tfq2.Fq2PlainAdapter, op)(*((a, b) if op == "mul" else (a,))), got)


def test_b3_mul_matches_jax():
    rng = np.random.default_rng(7)
    xs = _fq2_values(rng, 16)
    a = tfq2.Fq2Adapter.encode(xs)
    want = jfq2.Fq2Adapter.b3_mul(jfq2.Fq2Adapter.encode(xs))
    assert np.array_equal(tfield.to_numpy_limbs(tfq2.Fq2Adapter.b3_mul(a)), np.asarray(want))
    g1 = tfq2.FqAdapter.encode([x for x, _ in xs])
    want1 = jfq2.FqAdapter.b3_mul(jfq2.FqAdapter.encode([x for x, _ in xs]))
    assert np.array_equal(tfield.to_numpy_limbs(tfq2.FqAdapter.b3_mul(g1)), np.asarray(want1))
