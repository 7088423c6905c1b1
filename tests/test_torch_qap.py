"""The QAP witness map and the NTT kernels' plain versions against the JAX
package, exactly.

The port's coset lift runs on the (16, B, n) layout through the K4/K5
wrappers (their plain versions on CPU tensors) and, as groth16/ntt.coset_lift,
on the (16, n, B) layout; both must equal the JAX coset_lift. The witness
map must equal the JAX package's host-integer map (native NTT) on a small
synthetic circuit and on the depth-10 RLN matrices.
"""

import random

import numpy as np
import pytest
import torch

from zerokit_tpu.groth16 import ntt as jntt
from zerokit_tpu.groth16.qap import WitnessMapper as JWitnessMapper
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff import ntt_kernels as nk
from zerokit_tpu_torch.ff.field import FR, FrField, from_numpy_limbs, to_numpy_limbs
from zerokit_tpu_torch.groth16 import ntt
from zerokit_tpu_torch.groth16.qap import WitnessMapper, sparse_matvec
from zerokit_tpu_torch.resources import load_circuit

torch.set_num_threads(1)


def random_mont(rng, shape) -> np.ndarray:
    """(16, *shape) uint32 limbs of seeded Fr values (< r)."""
    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.uint32)
    limbs[15] %= (R >> 240) & 0xFFFF
    return limbs


def test_coset_lift_matches_jax():
    n, batch = 1024, 2
    rng = np.random.default_rng(1)
    evals = random_mont(rng, (n, batch))
    root = ntt.coset_root_2n(n)
    assert root == jntt.coset_root_2n(n)
    want = np.asarray(jntt.coset_lift(evals, root))
    t = from_numpy_limbs(evals, "cpu")
    assert np.array_equal(to_numpy_limbs(ntt.coset_lift(t, root)), want)
    fused = nk.coset_lift_bn(t.transpose(1, 2).contiguous(), root)  # K4/K5 plain
    assert np.array_equal(to_numpy_limbs(fused.transpose(1, 2)), want)


def test_host_tables_match_jax():
    for n in (2, 16, 1024):
        assert ntt.domain_generator(n) == jntt.domain_generator(n)
        assert np.array_equal(ntt._bitrev(n), jntt._bitrev(n))
        root = ntt.coset_root_2n(n)
        assert np.array_equal(ntt._coset_table_brev(n, root), jntt._coset_table_brev(n, root))
        for mine, ref in zip(ntt._stage_twiddles(n, True), jntt._stage_twiddles(n, True)):
            assert np.array_equal(mine, np.asarray(ref))


@pytest.mark.parametrize("n,batch", [(2, 1), (16, 3), (2048, 2)])
def test_coset_lift_bn_matches_plain_lift(n, batch):
    """Every power-of-two n and any B: n <= 512 is the tail alone (K5);
    n = 2048 adds two cross stages (K4) on each side."""
    rng = np.random.default_rng(n + batch)
    evals = from_numpy_limbs(random_mont(rng, (n, batch)), "cpu")
    root = ntt.coset_root_2n(n)
    want = ntt.coset_lift(evals, root)
    nk.reset_launches()
    got = nk.coset_lift_bn(evals.transpose(1, 2).contiguous(), root)
    assert nk.launches == {"ntt_cross": 0, "ntt_tail": 0}
    assert torch.equal(got.transpose(1, 2), want)


def test_ntt_stage_and_tail_compose_to_a_dft():
    """dif (no table) then dit with inverse twiddles is n times the input."""
    n, batch = 1024, 1
    rng = np.random.default_rng(7)
    x = from_numpy_limbs(random_mont(rng, (batch, n)), "cpu")
    there = nk.dif(x, False)
    back = nk.dit(there, True)
    n_mont = FR.encode([n]).reshape(16, 1, 1).expand(x.shape).contiguous()
    assert torch.equal(back, FrField.mul(x, n_mont))
    with pytest.raises(ValueError):
        nk.ntt_stage(x, nk._stage_tw(n, 4, False, "cpu"), 8, "dif")
    with pytest.raises(ValueError):
        nk.ntt_tail(x[:, :, :12], nk._tail_tw(n, False, "cpu"), None, "dit")


def _synthetic_matrices(seed):
    """Random sparse A/B rows (the synthetic circuit of
    test_production_shapes.py), with empty rows and repeated wires."""
    rnd = random.Random(seed)
    n_constraints, n_instance, n_wires = 11, 3, 9

    def rand_rows(max_nnz):
        return [
            [(rnd.randrange(1, R), rnd.randrange(n_wires)) for _ in range(rnd.randrange(0, max_nnz + 1))]
            for _ in range(n_constraints)
        ]

    matrices = ConstraintMatrices(
        num_instance_variables=n_instance, num_witness_variables=n_wires - n_instance,
        num_constraints=n_constraints, a_num_non_zero=0, b_num_non_zero=0,
        c_num_non_zero=0, a=rand_rows(4), b=rand_rows(3), c=[],
    )
    return matrices, n_wires


def _compare_maps(matrices, n_wires, batch, seed):
    """The JAX mapper reads the same matrices object (plain ints)."""
    rng = np.random.default_rng(seed)
    assignment = random_mont(rng, (n_wires, batch))
    want = np.asarray(JWitnessMapper(matrices)._witness_map_host(assignment))
    mapper = WitnessMapper(matrices, "cpu")
    got = mapper.witness_map(from_numpy_limbs(assignment, "cpu"))
    assert got.shape == (16, mapper.domain_size, batch)
    assert np.array_equal(to_numpy_limbs(got), want)


def test_witness_map_matches_jax_synthetic():
    m, n_wires = _synthetic_matrices(9)
    _compare_maps(m, n_wires, 3, seed=9)


def test_sparse_matvec_matches_host_sums():
    m, n_wires = _synthetic_matrices(5)
    mapper = WitnessMapper(m, "cpu")
    rng = np.random.default_rng(5)
    assignment = from_numpy_limbs(random_mont(rng, (n_wires, 2)), "cpu")
    z = FR.decode(assignment)  # (n_wires, 2) ints
    got = FR.decode(sparse_matvec(mapper.a, assignment))
    for r in range(mapper.domain_size):
        row = m.a[r] if r < len(m.a) else []
        for b in range(2):
            assert got[r, b] == sum(c * z[w, b] for c, w in row) % R


def test_witness_map_matches_jax_depth10():
    zkey, _ = load_circuit(10)
    n_wires = zkey.matrices.num_instance_variables + zkey.matrices.num_witness_variables
    _compare_maps(zkey.matrices, n_wires, 2, seed=10)
