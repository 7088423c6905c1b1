"""The partial witness of zerokit's depth-20 circuits, found from the graph.

witness_eval.unknown_mask must name exactly the wires that the host
interpreter's calc_witness_partial leaves None when the message inputs are
unknown (reference graph.rs:274-312), and the device evaluator (its plain
version, on the CPU) with those inputs at 0 must give every other wire
the interpreter's value: on the v2 graph, and the mask on the
multi-message-id graph. The finish's finite points a lane on the v2 key
equal the count in the benchmark's partial configuration, and the v2
prover refuses a partial proof of any other mask than the graph's.
"""

import json
import random

import pytest
import torch

from rlnbench.manifest import HERE

from zerokit_tpu_torch.api import default_graph, default_zkey
from zerokit_tpu_torch.circuit import witness_host
from zerokit_tpu_torch.circuit.witness_eval import (MESSAGE_INPUTS, WitnessEvaluator,
                                                    compile_graph, unknown_mask)
from zerokit_tpu_torch.constants import NUM_LIMBS, R
from zerokit_tpu_torch.ff.field import FR
from zerokit_tpu_torch.groth16.prover import Groth16Prover, PartialProof, ProverError
from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput

torch.set_num_threads(1)


def member(seed: int) -> RLNPartialWitnessInput:
    rnd = random.Random(seed)
    return RLNPartialWitnessInput.new(rnd.randrange(R), 100, [rnd.randrange(R) for _ in range(20)],
                                      [rnd.randrange(2) for _ in range(20)])


def host_partial(graph, pw):
    return witness_host.calc_witness_partial(pw.named_inputs_partial(graph.max_out), graph)


def test_v2_unknown_mask_and_known_wires_equal_the_interpreter():
    graph = default_graph("single")
    pw = member(2026)
    want = host_partial(graph, pw)
    unknown = unknown_mask(graph)
    assert unknown.tolist() == [v is None for v in want]
    assert int(unknown.sum()) == 505

    named = {name: [[0 if v is None else v] for v in vals]
             for name, vals in pw.named_inputs_partial(graph.max_out).items()}
    ev = WitnessEvaluator(compile_graph(graph), "cpu")
    got = [int(v) for v in FR.decode(ev.evaluate_mont(ev.build_input_buffer(named, 1))[:, :, 0])]
    assert [g for g, u in zip(got, unknown) if not u] == [v for v in want if v is not None]


def test_multi_message_id_unknown_mask_equals_the_interpreter():
    graph = default_graph("multi")
    want = host_partial(graph, member(7))
    assert unknown_mask(graph).tolist() == [v is None for v in want]
    # the mask is the graph's: other message inputs give other wires unknown
    some = unknown_mask(graph, ("x",))
    assert some.sum() < len(want) - sum(v is not None for v in want)
    assert set(MESSAGE_INPUTS) >= {"x", "externalNullifier", "messageId", "selectorUsed"}


def test_finish_points_equal_the_partial_configuration():
    with open(f"{HERE}/configs/rln-v2-depth20-partial.json") as f:
        cfg = json.load(f)
    prover = Groth16Prover(default_zkey("single"), default_graph("single"), "cpu")
    pts = cfg["msm_points"]
    assert prover.finish_points() == pts["a"] + pts["b1"] + 3 * pts["b2"] + pts["l"] + pts["h"]
    assert int((~prover.known_wires).sum()) == cfg["unknown_wires"]
    known, unknown = prover._split()
    for part, counts in ((unknown, pts), (known, cfg["partial_points"])):
        assert {k: m.n_real for k, m in part.msms.items()} == {
            k: v for k, v in counts.items() if k != "h"}


def test_a_partial_of_another_mask_is_refused():
    """A partial proof's mask comes from a client's bytes: the v2 depth-20
    prover refuses every mask but the graph's and keeps its one split."""
    prover = Groth16Prover(default_zkey("single"), default_graph("single"), "cpu")
    parts = prover._split()
    entries = prover.known_wires[1:].tolist()
    some = [k and i % 2 == 0 for i, k in enumerate(entries)]
    assignment = torch.zeros((NUM_LIMBS, prover.n_wires, 1), dtype=torch.int32)
    for mask in ([False] * len(entries), some, entries[:-1]):
        partial = PartialProof(mask, None, None, None, None)
        with pytest.raises(ProverError):
            prover.finish_batch([partial], assignment, [1], [1])
    with pytest.raises(ProverError):
        prover.prove_partial([None] * len(entries))
    assert prover._split() is parts and prover._split(list(entries)) is parts
