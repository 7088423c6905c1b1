"""The port's natural-order NTT and its Bailey NTT over tp ranks, against the JAX package.

The port's groth16/ntt fft / ifft / distribute_powers (K4 + K5 on the
kernels' (16, B, n) layout, their plain versions on CPU tensors) equal the
JAX package's ntt.fft / ifft / distribute_powers on its (16, n, B) layout.
The port's parallel/ntt_sharded.sharded_fft, run in gloo ranks started by
parallel/launch.py (bodies in parallel/dryrun.py), equals the JAX
sharded_fft on the conftest's virtual mesh at tp = 2, and the single-device
JAX NTT at tp = 4, forward and inverse; its coset lift (two Bailey passes
with the second all_to_all between them) equals the JAX coset_lift; the
mesh WitnessMapper at (dp, tp) = (2, 2) equals the JAX WitnessMapper.
Every comparison is exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerokit_tpu.circuit.zkey import ConstraintMatrices as JaxMatrices
from zerokit_tpu.ff.field import FR as JAX_FR, FrField as JaxFrField
from zerokit_tpu.groth16 import ntt as jax_ntt
from zerokit_tpu.groth16.qap import WitnessMapper as JaxWitnessMapper
from zerokit_tpu.parallel.ntt_sharded import sharded_fft as jax_sharded_fft
from zerokit_tpu.parallel.sharded import make_mesh as jax_make_mesh
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import encode_canonical_fast
from zerokit_tpu_torch.groth16 import ntt
from zerokit_tpu_torch.parallel import ntt_sharded
from zerokit_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)

BODIES = "zerokit_tpu_torch.parallel.dryrun"
TIMEOUT = 240


def run(world, body, *args):
    return launch(world, f"{BODIES}:{body}", args, timeout=TIMEOUT)


def jax_values(rnd, n, b):
    """(16, n, B) Montgomery limbs as the JAX package lays them out."""
    return np.asarray(JAX_FR.encode([rnd.randrange(R) for _ in range(n * b)])).reshape(16, n, b)


def to_port(arr: np.ndarray) -> torch.Tensor:
    """JAX (16, n, B) uint32 -> port (16, B, n) int32."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(arr, 1, 2)).astype(np.int32))


def to_jax(t) -> np.ndarray:
    arr = t.numpy() if isinstance(t, torch.Tensor) else t
    return np.swapaxes(arr, 1, 2).astype(np.uint32)


@pytest.mark.parametrize("n", [2, 32, 2048])
def test_fft_ifft_distribute_powers_equal_jax(n):
    """n = 2048 runs one K4 stage above the tail's chunk of 1024."""
    rnd = random.Random(n)
    arr = jax_values(rnd, n, 3)
    x = to_port(arr)
    want_fft = np.asarray(jax_ntt.fft(jnp.asarray(arr)))
    want_ifft = np.asarray(jax_ntt.ifft(jnp.asarray(arr)))
    assert np.array_equal(to_jax(ntt.fft(x)), want_fft)
    assert np.array_equal(to_jax(ntt.ifft(x)), want_ifft)
    assert np.array_equal(to_jax(ntt.natural_ntt_plain(x, False)), want_fft)
    assert np.array_equal(to_jax(ntt.natural_ntt_plain(x, True, pow(n, -1, R))), want_ifft)
    root = ntt.coset_root_2n(n)
    want = np.asarray(jax_ntt.distribute_powers(jnp.asarray(arr), root))
    assert np.array_equal(to_jax(ntt.distribute_powers(x, root)), want)


def test_fits():
    assert ntt_sharded.fits(32, 2) and ntt_sharded.fits(32, 4) and ntt_sharded.fits(8192, 4)
    assert not ntt_sharded.fits(4, 4)  # n2 = 1 holds no column for each of 4 ranks
    assert not ntt_sharded.fits(24, 2)  # n2 = 12 is not a power of two
    assert not ntt_sharded.fits(32, 3)


@pytest.mark.parametrize("n,d", [(8, 2), (16, 2), (32, 4), (64, 4), (128, 8)])
def test_rows_to_columns_plan(n, d):
    """The second all_to_all's plan, every rank simulated on global indices:
    each rank ends with its columns block, whatever the splits' evenness."""
    n2 = n // d
    m = n2 // d
    plans = [ntt_sharded._rows_to_columns_plan(n, d, t) for t in range(d)]
    sent = []
    for t, (send, in_splits, _, _) in enumerate(plans):
        rows = t + d * np.arange(n2)
        chunks = np.split(rows[send], np.cumsum(in_splits)[:-1])
        sent.append(chunks)
    for t, (_, _, out_splits, arrivals) in enumerate(plans):
        recv = np.concatenate([sent[src][t] for src in range(d)])
        assert [len(sent[src][t]) for src in range(d)] == out_splits
        block = recv[np.argsort(arrivals)].reshape(d, m)
        want = np.arange(n).reshape(d, n2)[:, t * m:(t + 1) * m]
        assert np.array_equal(block, want)


def test_sharded_fft_equals_jax_sharded_fft_tp2():
    rnd = random.Random(4)
    arr = jax_values(rnd, 32, 2)
    mesh = jax_make_mesh(tp=2, dp=4)
    with mesh:
        want = np.asarray(jax_sharded_fft(arr, mesh, "tp"))
    got = run(2, "sharded_fft_np", 2, 1, "cpu", to_port(arr).numpy(), False)
    for g in got:
        assert np.array_equal(to_jax(g), want)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_sharded_fft_tp4_equals_single_device(inverse):
    """tp = 4 at n = 32: n2 = 8, two columns a rank."""
    rnd = random.Random(5 + inverse)
    arr = jax_values(rnd, 32, 2)
    want = np.asarray((jax_ntt.ifft if inverse else jax_ntt.fft)(jnp.asarray(arr)))
    got = run(4, "sharded_fft_np", 4, 1, "cpu", to_port(arr).numpy(), inverse)
    for g in got:
        assert np.array_equal(to_jax(g), want)


@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1)])
def test_sharded_coset_lift_equals_jax(tp, dp):
    """Inverse Bailey, the rows' powers, the second all_to_all (uneven at
    tp = 4, n = 32), forward Bailey: the JAX coset_lift."""
    rnd = random.Random(7 + tp)
    n = 32
    arr = jax_values(rnd, n, 3)
    root = ntt.coset_root_2n(n)
    want = np.asarray(jax_ntt.coset_lift(jnp.asarray(arr), root))
    got = run(tp * dp, "sharded_fft_np", tp, dp, "cpu", to_port(arr).numpy(), False, root)
    for g in got:
        assert np.array_equal(to_jax(g), want)


def test_sharded_witness_map_equals_jax():
    """The mesh WitnessMapper at (dp, tp) = (2, 2) on a domain of 16 (the
    matrices of the JAX package's test_sharded_witness_map_parity): each dp
    rank maps its 2 lanes with the lift sharded over tp; h equals the JAX
    single-device WitnessMapper's."""
    rnd = random.Random(21)
    n_wires, n_constraints, n_pub = 10, 12, 2

    def rows():
        return [[(rnd.randrange(R), rnd.randrange(n_wires)) for _ in range(2)]
                for _ in range(n_constraints)]

    fields = dict(num_instance_variables=n_pub, num_witness_variables=n_wires - n_pub,
                  num_constraints=n_constraints, a_num_non_zero=2 * n_constraints,
                  b_num_non_zero=2 * n_constraints, c_num_non_zero=2 * n_constraints,
                  a=rows(), b=rows(), c=rows())
    b = 4
    canon = encode_canonical_fast([rnd.randrange(R) for _ in range(n_wires * b)])
    assign = np.asarray(JaxFrField.to_mont(jnp.asarray(canon.numpy().astype(np.uint32)
                                                       .reshape(16, n_wires, b))))
    want = np.asarray(JaxWitnessMapper(JaxMatrices(**fields)).witness_map(assign))
    out = run(4, "witness_map_np", 2, 2, "cpu", ConstraintMatrices(**fields),
              assign.astype(np.int32))
    for o in out:
        assert o["sharded"]
        d = o["dp_index"]
        assert np.array_equal(o["h"].astype(np.uint32), want[:, :, 2 * d:2 * d + 2])
