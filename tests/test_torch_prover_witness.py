"""The prover's witness stage: the device evaluator, with the reference's rules.

At depth 10, batch 1 (padded to the MIN_BATCH class of 4 lanes), the
port's Groth16Prover.full_assignments must equal the JAX package's bit for
bit, padding lanes included (the JAX side is what tests/test_protocol.py
runs in tier-1), without calling the host interpreter, and must scrub the
host input buffer afterwards (mirroring tests/test_protocol.py). A graph
that compile_graph rejects is served by the host interpreter, and that is
decided when the prover is built.
"""

import random

import numpy as np
import pytest
import torch

from zerokit_tpu.circuit import graph as jgm
from zerokit_tpu.circuit.witness_eval import WitnessEvaluator as JaxEvaluator
from zerokit_tpu.groth16.prover import Groth16Prover as JaxProver
from zerokit_tpu_torch.circuit import graph as gm
from zerokit_tpu_torch.circuit import witness_eval as we
from zerokit_tpu_torch.circuit import witness_host
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import FR
from zerokit_tpu_torch.groth16 import prover as prover_mod
from zerokit_tpu_torch.groth16.prover import Groth16Prover, random_batch_inputs
from zerokit_tpu_torch.groth16.setup import groth16_setup
from zerokit_tpu_torch.resources import load_circuit, resource_path

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def depth10():
    zkey, graph = load_circuit(10)
    return zkey, graph, Groth16Prover(zkey, graph, "cpu")


def jax_full_assignments(graph_path, named, batch):
    """The JAX prover's full_assignments (its evaluator on the CPU)."""
    prover = JaxProver.__new__(JaxProver)
    prover.mesh = None
    prover.evaluator = JaxEvaluator(jgm.graph_from_file(graph_path, 10, None))
    return np.asarray(prover.full_assignments(named, batch))


def test_full_assignments_equal_jax(depth10, monkeypatch):
    zkey, graph, prover = depth10
    assert prover.evaluator is not None
    named, _, _ = random_batch_inputs(np.random.default_rng(8), 1, 10)

    def no_host(*args, **kwargs):
        raise AssertionError("the host interpreter was called")

    monkeypatch.setattr(witness_host, "calc_witness", no_host)
    bufs = []
    build = prover.evaluator.build_input_buffer

    def capture(named_inputs, batch):
        bufs.append(build(named_inputs, batch))
        return bufs[-1]

    monkeypatch.setattr(prover.evaluator, "build_input_buffer", capture)
    got = prover.full_assignments(named, 1)
    assert got.shape == (16, prover.n_wires, prover_mod._padded_batch(1))
    want = jax_full_assignments(resource_path("tree_depth_10/graph.bin"), named, 1)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # the padding lanes replicate lane 0
    assert all(torch.equal(got[:, :, lane], got[:, :, 0]) for lane in range(got.shape[2]))
    # the host input buffer (identity-secret limbs) was scrubbed
    assert bufs and all(not b.any() for b in bufs)
    monkeypatch.undo()
    host = witness_host.calc_witness({k: [c[0] for c in v] for k, v in named.items()}, graph)
    assert [int(v) for v in FR.decode(got[:, :, 0])] == host


def test_wide_batches_stream_through_eval_chunks(depth10, monkeypatch):
    _, _, prover = depth10
    monkeypatch.setattr(prover_mod, "EVAL_CHUNK", 4)
    named, _, _ = random_batch_inputs(np.random.default_rng(9), 5, 10)
    got = prover.full_assignments(named, 5)
    # chunks of 4 and 1 lanes, the second padded to 4 (lane 4 replicated)
    assert got.shape[2] == 8
    assert all(torch.equal(got[:, :, lane], got[:, :, 4]) for lane in range(5, 8))
    single = {k: [[c[4]] for c in v] for k, v in named.items()}
    assert torch.equal(prover.full_assignments(single, 1)[:, :, 0], got[:, :, 4])


# public x; witness w1, w2; constraints w1*w1 = w2, w2*w1 = x
MATRICES = ConstraintMatrices(
    num_instance_variables=2, num_witness_variables=2, num_constraints=2,
    a_num_non_zero=2, b_num_non_zero=2, c_num_non_zero=2,
    a=[[(1, 2)], [(1, 3)]], b=[[(1, 2)], [(1, 2)]], c=[[(1, 3)], [(1, 1)]],
)


def pow_graph():
    """Signals (1, x^3, x, x^2) of input x, x^2 through Pow: a witness of
    MATRICES that compile_graph rejects."""
    nodes = [
        gm.Node(kind=gm.K_INPUT, a=1),
        gm.Node(kind=gm.K_CONST, const=1),
        gm.Node(kind=gm.K_CONST, const=2),
        gm.Node(kind=gm.K_DUO, op=gm.OP_POW, a=0, b=2),
        gm.Node(kind=gm.K_DUO, op=gm.OP_MUL, a=3, b=0),
    ]
    return gm.Graph(nodes=nodes, signals=[1, 4, 0, 3], input_mapping={"x": (1, 1)},
                    tree_depth=0, max_out=1)


def test_unsupported_graph_goes_to_the_host_interpreter(monkeypatch):
    zkey = groth16_setup(MATRICES, random.Random(3))
    prover = Groth16Prover(zkey, pow_graph(), "cpu")
    assert prover.evaluator is None  # decided at construction
    with pytest.raises(we.UnsupportedGraph):
        we.compile_graph(pow_graph())

    def no_compile(*args, **kwargs):
        raise AssertionError("compile_graph called after construction")

    monkeypatch.setattr(prover_mod, "compile_graph", no_compile)
    xs = [5, R - 7, 123456789]
    got = prover.full_assignments({"x": [xs]}, len(xs))
    assert got.shape == (16, 4, len(xs))  # the host path pads nothing
    for lane, x in enumerate(xs):
        assert [int(v) for v in FR.decode(got[:, :, lane])] == [1, pow(x, 3, R), x, x * x % R]
