"""Partial/finish proving (reference rln/src/partial_proof.rs), on the port.

Mirrors tests/test_groth16_e2e.py::test_partial_then_finish_matches_full
(a slow test in the JAX package, for its XLA compiles) on the 2-constraint
circuit, with the port's host trusted setup: prove_partial over the known
entries, then finish_proof over the rest, equals the full proof at the
same (r, s) (the JAX prover's, with its host MSMs) and passes the pairing
check; a mask of the wrong length raises ProverError. The port's MSMs run
their plain versions on CPU tensors.
"""

import random

import pytest
import torch

from test_torch_prover import jax_prover_for
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import NUM_LIMBS, R
from zerokit_tpu_torch.ff.field import FrField, encode_canonical_fast, to_numpy_limbs
from zerokit_tpu_torch.groth16.prover import Groth16Prover, PartialProof, ProverError
from zerokit_tpu_torch.groth16.setup import groth16_setup
from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof

torch.set_num_threads(1)

# public x; witness w1, w2; constraints w1*w1 = w2, w2*w1 = x
MATRICES = ConstraintMatrices(
    num_instance_variables=2, num_witness_variables=2, num_constraints=2,
    a_num_non_zero=2, b_num_non_zero=2, c_num_non_zero=2,
    a=[[(1, 2)], [(1, 3)]], b=[[(1, 2)], [(1, 2)]], c=[[(1, 3)], [(1, 1)]],
)


def test_partial_then_finish_matches_full():
    rng = random.Random(12)
    zkey = groth16_setup(MATRICES, rng)
    prover = Groth16Prover(zkey, None, "cpu")
    pvk = prepare_verifying_key(zkey.pk.vk)
    w1 = rng.randrange(R)
    row = [1, w1 * w1 % R * w1 % R, w1, w1 * w1 % R]
    assignment = FrField.to_mont(encode_canonical_fast(row).reshape(NUM_LIMBS, 4, 1))

    # w1 known, x and w2 unknown (entries exclude the leading 1)
    partial = prover.prove_partial([None, row[2], None])
    assert isinstance(partial, PartialProof) and partial.mask == [False, True, False]
    r, s = rng.randrange(R), rng.randrange(R)
    proof = prover.finish_proof(partial, assignment, r, s)
    # the full proof at the same (r, s): the port's full proofs equal the
    # JAX prover's (tests/test_torch_prover.py), whose host MSMs are fast here
    full = jax_prover_for(zkey, 2, 4).prove_batch_with_assignment(
        to_numpy_limbs(assignment), [r], [s])[0]
    assert proof == full
    assert verify_proof(pvk, proof, [row[1]])
    assert not verify_proof(pvk, proof, [(row[1] + 1) % R])

    with pytest.raises(ProverError):
        prover.prove_partial([None, row[2]])
    with pytest.raises(ProverError):
        prover.finish_proof(PartialProof([True] * 4, None, None, None, None), assignment, r, s)
