"""Batched two-phase proving on the port (reference rln/src/partial_proof.rs).

On the 2-constraint circuit of tests/test_torch_partial.py with the port's
host trusted setup and four distinct witnesses: prove_partial_batch and
finish_batch equal, lane by lane, the port's full proofs at the same
(r, s) and the plain two-phase reference (rlnbench/reference/partial.py),
and they verify; the counters say what the calls did; a partial proof of
another known-mask than the prover's is refused. A subset MSM equals
the masked MSM over the same query, on G1 and G2. The port's kernels run
their plain versions on CPU tensors.
"""

import dataclasses
import random

import pytest
import torch

from rlnbench.reference import partial as ref_partial
from rlnbench.reference.prover import Circuit
from test_torch_partial import MATRICES
from zerokit_tpu_torch.constants import NUM_LIMBS, R
from zerokit_tpu_torch.ff.field import FrField, encode_canonical_fast
from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
from zerokit_tpu_torch.groth16.msm import MSM
from zerokit_tpu_torch.groth16.prover import Groth16Prover, ProverError
from zerokit_tpu_torch.groth16.setup import groth16_setup
from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.runtime.profiling import PipelineMetrics

torch.set_num_threads(1)

LANES = 4


def test_partial_batch_then_finish_batch_equal_full_and_reference():
    rng = random.Random(21)
    zkey = groth16_setup(MATRICES, rng)
    prover = Groth16Prover(zkey, None, "cpu")
    rows = []
    for _ in range(LANES):
        w1 = rng.randrange(R)
        rows.append([1, w1 * w1 % R * w1 % R, w1, w1 * w1 % R])
    canon = encode_canonical_fast([rows[b][i] for i in range(4) for b in range(LANES)])
    assignment = FrField.to_mont(canon.reshape(NUM_LIMBS, 4, LANES))
    rs = [rng.randrange(R) for _ in range(LANES)]
    ss = [rng.randrange(R) for _ in range(LANES)]
    mask = [False, True, False]  # w1 known; x and w2 come with the message

    # a prover without a graph takes its known-mask from its first partial
    first = prover.prove_partial([None, rows[0][2], None])
    parts = prover._split()
    metrics = PipelineMetrics()
    partials = prover.prove_partial_batch(assignment, metrics=metrics)
    assert partials[0] == first
    proofs = prover.finish_batch(partials, assignment, rs, ss, metrics=metrics)
    assert proofs == prover.prove_batch_with_assignment(assignment, rs, ss)
    assert len(set(proofs)) == LANES

    circuit = Circuit(zkey, None)
    pvk = prepare_verifying_key(zkey.pk.vk)
    for b in range(LANES):
        want = ref_partial.partial(circuit, [1, None, rows[b][2], None])
        got = partials[b]
        assert got.mask == mask and want.mask == [True] + mask
        assert (got.partial_pi_a, got.partial_rho, got.partial_pi_b, got.partial_pi_c) == (
            want.pi_a, want.rho, want.pi_b, want.pi_c)
        assert proofs[b] == ref_partial.finish(circuit, want, rows[b], rs[b], ss[b])
        assert verify_proof(pvk, proofs[b], [rows[b][1]])

    assert metrics.counts == {"partials_made": LANES, "finish_lanes": LANES,
                              "finish_points_g1eq": LANES * prover.finish_points()}
    assert {"partial_msm", "qap_witness_map", "msm_finish", "msm_h",
            "host_assembly"} <= set(metrics.stages)
    other = dataclasses.replace(partials[1], mask=[False, False, True])
    with pytest.raises(ProverError):
        prover.finish_batch(partials[:1] + [other] * 3, assignment, rs, ss)
    with pytest.raises(ProverError):
        prover.prove_partial([rows[0][1], None, None])
    assert prover._split() is parts and prover.known_wires.tolist() == [True] + mask


@pytest.mark.parametrize("adapter, mul", [(FqAdapter, bn254.G1.mul), (Fq2Adapter, bn254.G2.mul)])
def test_subset_msm_equals_masked_msm(adapter, mul):
    rng = random.Random(5 if adapter is FqAdapter else 6)
    gen = bn254.G1_GENERATOR if adapter is FqAdapter else bn254.G2_GENERATOR
    n, lanes = 20, 2
    points = [None if i % 7 == 3 else mul(gen, rng.randrange(1, R)) for i in range(n)]
    index = [i for i in range(n) if rng.random() < 0.5 and points[i] is not None]
    scalars = [rng.randrange(R) for _ in range(n * lanes)]
    canon = encode_canonical_fast(scalars).reshape(NUM_LIMBS, n, lanes)
    on = torch.zeros((n, 1), dtype=torch.bool)
    on[index] = True

    whole = MSM(points, adapter, "cpu")
    sub = MSM(points, adapter, "cpu", index=index)
    assert sub.n_real == len(index) and sub.n == 32 and sub.n_scalars == n
    assert sub.to_affine_ints(sub(canon)) == whole.to_affine_ints(whole(canon, mask=on))
    with pytest.raises(ValueError):
        sub(canon[:, 1:])
