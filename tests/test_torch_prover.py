"""The port's Groth16 prover against the JAX prover at the same (r, s).

Groth16 proofs are deterministic given the witness and the blinding pair,
so the port's proofs must equal the JAX package's proofs exactly, and they
must pass the pairing check. The port runs its whole device path here on
CPU tensors (every kernel's plain version); the JAX prover runs as its own
CPU tests run it (host QAP map, native host MSMs).
"""

import random

import numpy as np
import pytest
import torch

from zerokit_tpu.ff.fq2 import Fq2Adapter as JaxFq2, FqAdapter as JaxFq
from zerokit_tpu.groth16.msm_host import HostMSM
from zerokit_tpu.groth16.prover import Groth16Prover as JaxProver
from zerokit_tpu.groth16.qap import WitnessMapper as JaxWitnessMapper
from zerokit_tpu.groth16.setup import groth16_setup
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import NUM_LIMBS, R
from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.ff import ntt_kernels as nk
from zerokit_tpu_torch.ff.field import (
    FrField, decode_canonical_fast, encode_canonical_fast, to_numpy_limbs,
)
from zerokit_tpu_torch.groth16.prover import Groth16Prover, _padded_batch
from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof
from zerokit_tpu_torch.resources import load_circuit
from zerokit_tpu_torch.runtime.profiling import PipelineMetrics

torch.set_num_threads(1)

# public x; witness w1, w2; constraints w1*w1 = w2, w2*w1 = x
MATRICES = ConstraintMatrices(
    num_instance_variables=2,
    num_witness_variables=2,
    num_constraints=2,
    a_num_non_zero=2,
    b_num_non_zero=2,
    c_num_non_zero=2,
    a=[[(1, 2)], [(1, 3)]],
    b=[[(1, 2)], [(1, 2)]],
    c=[[(1, 3)], [(1, 1)]],
)

STAGES = {"witness_eval", "qap_witness_map", "from_mont", "msm_ab1l", "msm_b2", "msm_h",
          "host_assembly"}


def jax_prover_for(zkey, n_inputs, n_wires, graph=None):
    """The JAX prover with its CPU backends (host map, native host MSMs)."""
    prover = JaxProver.__new__(JaxProver)
    prover.zkey = zkey
    prover.graph = graph
    prover.mesh = None
    prover.evaluator = None
    prover.num_inputs = n_inputs
    prover.n_wires = n_wires
    prover.mapper = JaxWitnessMapper(zkey.matrices)
    prover.msm_a = HostMSM(zkey.pk.a_query, JaxFq)
    prover.msm_b1 = HostMSM(zkey.pk.b_g1_query, JaxFq)
    prover.msm_b2 = HostMSM(zkey.pk.b_g2_query, JaxFq2)
    prover.msm_h = HostMSM(zkey.pk.h_query, JaxFq)
    prover.msm_l = HostMSM(zkey.pk.l_query, JaxFq)
    prover._g1_group = None
    return prover


def small_assignments(rng, batch):
    rows = []
    for _ in range(batch):
        w1 = rng.randrange(R)
        w2 = w1 * w1 % R
        rows.append([1, w2 * w1 % R, w1, w2])
    flat = [rows[b][i] for i in range(4) for b in range(batch)]
    canon = encode_canonical_fast(flat).reshape(NUM_LIMBS, 4, batch)
    return rows, FrField.to_mont(canon)


def test_padded_batch():
    assert [_padded_batch(b) for b in (1, 4, 5, 16)] == [4, 4, 8, 16]


def test_small_circuit_proofs_equal_jax():
    rng = random.Random(11)
    zkey = groth16_setup(MATRICES, rng)
    jax_prover = jax_prover_for(zkey, 2, 4)
    prover = Groth16Prover(zkey, None, "cpu")
    pvk = prepare_verifying_key(zkey.pk.vk)
    batch = 3
    rows, assignment = small_assignments(rng, batch)
    rs = [rng.randrange(R) for _ in range(batch)]
    ss = [rng.randrange(R) for _ in range(batch)]
    rs[2], ss[2] = 0, 0  # the deterministic r = s = 0 edge
    metrics = PipelineMetrics()
    fk.reset_launches()
    nk.reset_launches()
    proofs = prover.prove_batch_with_assignment(assignment, rs, ss, metrics=metrics)
    assert all(v == 0 for v in {**fk.launches, **nk.launches}.values())
    # a and l differ in size here, so the three G1 MSMs run one by one
    small_stages = STAGES - {"witness_eval", "msm_ab1l"} | {"msm_a", "msm_b1", "msm_l"}
    assert set(metrics.stages) == small_stages and metrics.batch == batch
    want = jax_prover.prove_batch_with_assignment(to_numpy_limbs(assignment), rs, ss)
    assert proofs == want
    for b in range(batch):
        assert verify_proof(pvk, proofs[b], [rows[b][1]])
        assert not verify_proof(pvk, proofs[b], [(rows[b][1] + 1) % R])


@pytest.mark.slow
def test_depth10_proofs_equal_jax():
    """prove_batch from named inputs (host witness interpreter) at B = 4."""
    zkey, graph = load_circuit(10)
    n_inputs = zkey.matrices.num_instance_variables
    n_wires = len(zkey.pk.a_query)
    rng = np.random.default_rng(10)

    def fr():
        return int.from_bytes(rng.bytes(32), "little") % R

    batch, depth = 4, 10
    named = {
        "identitySecret": [[fr() for _ in range(batch)]],
        "userMessageLimit": [[100] * batch],
        "messageId": [[1] * batch],
        "pathElements": [[fr() for _ in range(batch)] for _ in range(depth)],
        "identityPathIndex": [[int(v) for v in rng.integers(0, 2, batch)] for _ in range(depth)],
        "x": [[fr() for _ in range(batch)]],
        "externalNullifier": [[fr() for _ in range(batch)]],
    }
    rs = [fr() for _ in range(batch)]
    ss = [fr() for _ in range(batch)]
    prover = Groth16Prover(zkey, graph, "cpu")
    metrics = PipelineMetrics()
    proofs = prover.prove_batch(named, rs, ss, metrics=metrics)
    assert set(metrics.stages) == STAGES

    jax_prover = jax_prover_for(zkey, n_inputs, n_wires, graph)
    want = jax_prover.prove_batch(named, rs, ss)
    assert proofs == want
    pvk = prepare_verifying_key(zkey.pk.vk)
    z = prover.last_batch["z_canon"]
    for b in range(batch):
        assert verify_proof(pvk, proofs[b], decode_canonical_fast(z[:, 1 : n_inputs, b]))
