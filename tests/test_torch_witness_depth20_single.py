"""The port's plain witness evaluator on the depth-20 single-message graph.

The comparison of tests/test_witness.py::test_device_matches_host (a slow
test in the JAX package, for its XLA compiles): at 2 lanes, every signal
of the evaluator's Montgomery assignment equals the host interpreter's
integer, lane by lane. The multi-message-id graph is in its own file, so
that the test runner's file-level distribution can spread the two.
"""

import random

import torch

from zerokit_tpu_torch.circuit import witness_host, witness_kernels
from zerokit_tpu_torch.circuit.graph import graph_from_file
from zerokit_tpu_torch.circuit.witness_eval import WitnessEvaluator, compile_graph
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import FR
from zerokit_tpu_torch.resources import resource_path

torch.set_num_threads(1)

LANES = 2


def witness_inputs(multi: bool, lanes: int, seed: int = 9):
    """Named inputs of tests/test_witness.py's _witness_inputs, with seeded
    values in place of its keccak-derived ones."""
    rnd = random.Random(seed)
    named = {
        "identitySecret": [[rnd.randrange(R) for _ in range(lanes)]],
        "userMessageLimit": [[100] * lanes],
        "pathElements": [[rnd.randrange(R) for _ in range(lanes)] for _ in range(20)],
        "identityPathIndex": [[rnd.randrange(2) for _ in range(lanes)] for _ in range(20)],
        "x": [[rnd.randrange(R) for _ in range(lanes)]],
        "externalNullifier": [[12345] * lanes],
    }
    if multi:
        named["messageId"] = [[1] * lanes, [2] * lanes, [3] * lanes, [0] * lanes]
        named["selectorUsed"] = [[1] * lanes, [1] * lanes, [0] * lanes, [0] * lanes]
    else:
        named["messageId"] = [[1] * lanes]
    return named


def check_graph_against_host(rel: str, max_out, multi: bool):
    graph = graph_from_file(resource_path(rel), 20, max_out)
    ev = WitnessEvaluator(compile_graph(graph), "cpu")
    named = witness_inputs(multi, LANES)
    witness_kernels.reset_launches()
    out = ev.evaluate_mont(ev.build_input_buffer(named, LANES))
    assert out.shape == (16, len(graph.signals), LANES)
    assert witness_kernels.launches == {"witness_steps": 0, "witness_div": 0}
    for lane in range(LANES):
        host = witness_host.calc_witness({k: [col[lane] for col in v] for k, v in named.items()},
                                         graph)
        assert [int(v) for v in FR.decode(out[:, :, lane])] == host


def test_depth20_single_matches_host():
    check_graph_against_host("tree_depth_20/graph.bin", None, multi=False)
