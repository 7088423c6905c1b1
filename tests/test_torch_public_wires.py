"""The public wires of the device evaluator's assignment are the proof values.

RLN.generate_proofs reads each proof's values from the public wires
z[1:num_inputs] of the assignment it proves (groth16/prover.public_wires,
protocol/proof.proof_values_from_public) in place of recomputing them on the
host. On both embedded depth-20 graphs, the plain evaluator's assignment of
seeded witnesses, read that way, equals the host's values from the same
witnesses (protocol/proof.proof_values_from_witness) in the circuit's order
(groth16/verifier.rln_public_inputs); the multi-message-id witnesses leave
slots unused. Each graph is its own case, so that the test runner's
file-level distribution runs them on one worker.
"""

import random

import pytest
import torch

from zerokit_tpu_torch.api import default_graph, default_zkey
from zerokit_tpu_torch.circuit.witness_eval import WitnessEvaluator, compile_graph
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.groth16.prover import public_wires
from zerokit_tpu_torch.groth16.verifier import rln_public_inputs
from zerokit_tpu_torch.protocol.proof import proof_values_from_public, proof_values_from_witness
from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

torch.set_num_threads(1)

LANES = 4
# the slots each multi-message-id lane uses: unused slots in all but one lane
SELECTORS = [[1, 1, 0, 1], [1, 0, 0, 0], [0, 0, 1, 0], [1, 1, 1, 1]]


def seeded_witnesses(mode: str, depth: int, seed: int = 18):
    rnd = random.Random(seed)
    ws = []
    for lane in range(LANES):
        common = dict(identity_secret=rnd.randrange(R), user_message_limit=100,
                      path_elements=[rnd.randrange(R) for _ in range(depth)],
                      identity_path_index=[rnd.randrange(2) for _ in range(depth)],
                      x=rnd.randrange(R), external_nullifier=rnd.randrange(R))
        if mode == "single":
            ws.append(RLNWitnessInput.new_single(message_id=rnd.randrange(100), **common))
        else:
            ws.append(RLNWitnessInput.new_multi(
                message_ids=rnd.sample(range(100), 4),
                selector_used=[bool(u) for u in SELECTORS[lane]], **common))
    return ws


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_public_wires_are_the_host_values(mode):
    graph, zkey = default_graph(mode), default_zkey(mode)
    ws = seeded_witnesses(mode, graph.tree_depth)
    per_witness = [w.named_inputs() for w in ws]
    named = {name: [[pw[name][slot] for pw in per_witness] for slot in range(len(col))]
             for name, col in per_witness[0].items()}
    ev = WitnessEvaluator(compile_graph(graph), "cpu")
    assignment = ev.evaluate_mont(ev.build_input_buffer(named, LANES))
    publics = public_wires(assignment, zkey.matrices.num_instance_variables)
    want = [proof_values_from_witness(w) for w in ws]
    assert publics == [rln_public_inputs(v) for v in want]
    assert [proof_values_from_public(p, graph.max_out) for p in publics] == want
    if mode == "multi":
        assert any(0 in v.ys and 0 in v.nullifiers for v in want)  # unused slots read 0
