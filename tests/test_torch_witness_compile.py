"""The port's witness-graph compiler against the JAX package's.

compile_graph is the evaluator's state carried across: the slot layout,
the step schedule of every segment and its Div groups. The port copies it,
so on every embedded graph it must give the JAX package's arrays, array for
array; graphs holding ops off the device path raise UnsupportedGraph in
both (mirroring tests/test_witness.py::test_unsupported_ops_route_to_host).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zerokit_tpu.circuit import graph as jgm
from zerokit_tpu.circuit import witness_eval as jwe
from zerokit_tpu_torch.circuit import graph as gm
from zerokit_tpu_torch.circuit import witness_eval as we
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.resources import resource_path
from zerokit_tpu_torch.runtime import profiling

torch.set_num_threads(1)

GRAPHS = [
    ("tree_depth_10/graph.bin", 10, None),
    ("tree_depth_20/graph.bin", 20, None),
    ("tree_depth_20/multi_message_id/max_out_4/graph.bin", 20, 4),
]
SEGMENT_FIELDS = ("kind", "ops", "ia", "ib", "ic", "write_start", "div_ia", "div_ib", "div_out",
                  "node_ids", "div_node_ids")


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("rel,depth,max_out", GRAPHS, ids=["depth10", "depth20", "depth20_multi"])
def test_compile_graph_equals_jax(rel, depth, max_out):
    port = we.compile_graph(gm.graph_from_file(resource_path(rel), depth, max_out))
    ref = jwe.compile_graph(jgm.graph_from_file(resource_path(rel), depth, max_out))
    for f in dataclasses.fields(ref):
        if f.name in ("graph", "segments"):
            continue
        assert _same(getattr(port, f.name), getattr(ref, f.name)), f.name
    assert len(port.segments) == len(ref.segments)
    for i, (ps, rs) in enumerate(zip(port.segments, ref.segments)):
        for name in SEGMENT_FIELDS:
            assert _same(getattr(ps, name), getattr(rs, name)), f"segment {i} {name}"


def test_build_input_buffer_equals_jax():
    rel, depth, _ = GRAPHS[0]
    graph = gm.graph_from_file(resource_path(rel), depth, None)
    jgraph = jgm.graph_from_file(resource_path(rel), depth, None)
    rng = np.random.default_rng(4)
    batch = 3
    named = {
        name: [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(batch)]
               for _ in range(length)]
        for name, (_, length) in graph.input_mapping.items()
    }
    port = we.build_input_buffer(we.compile_graph(graph), named, batch)
    ref = jwe.WitnessEvaluator(jgraph).build_input_buffer(named, batch)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)
    with pytest.raises(ValueError):
        we.build_input_buffer(we.compile_graph(graph), named, batch + 1)


def _graph_with(node, mod):
    nodes = [mod.Node(kind=mod.K_INPUT, a=1), mod.Node(kind=mod.K_INPUT, a=2), node]
    return mod.Graph(nodes=nodes, signals=[2], input_mapping={"x": (1, 2)}, tree_depth=0,
                     max_out=1)


@pytest.mark.parametrize("op", ["pow", "idiv", "mod", "shl", "uno_id"])
def test_unsupported_graph(op):
    def node(mod):
        if op == "uno_id":
            return mod.Node(kind=mod.K_UNO, op=mod.UNO_ID, a=0)
        code = {"pow": mod.OP_POW, "idiv": mod.OP_IDIV, "mod": mod.OP_MOD, "shl": mod.OP_SHL}[op]
        return mod.Node(kind=mod.K_DUO, op=code, a=0, b=1)

    with pytest.raises(we.UnsupportedGraph):
        we.compile_graph(_graph_with(node(gm), gm))
    with pytest.raises(jwe.UnsupportedGraph):
        jwe.compile_graph(_graph_with(node(jgm), jgm))


def test_op_codes_equal_jax():
    names = [n for n in dir(jwe) if n.startswith("F_") or n in ("W", "N_LEAN", "N_RICH")]
    assert {n: getattr(we, n) for n in names} == {n: getattr(jwe, n) for n in names}
    assert we._LEAN_MAP == jwe._LEAN_MAP and we._RICH_MAP == jwe._RICH_MAP


def test_segment_work_counts_the_depth20_graph():
    rel, depth, _ = GRAPHS[1]
    compiled = we.compile_graph(gm.graph_from_file(resource_path(rel), depth, None))
    lean = [s for s in compiled.segments if s.kind == "lean"][0]
    shape = profiling.segment_work(lean, 16)
    assert shape["steps"] == len(lean.ops) and shape["lanes"] == 16
    assert sum(shape["ops"].values()) == int((lean.ops != we.F_NOP).sum())
    assert we.F_NOP not in shape["ops"]
    # every slot read from outside the segment lies before its windows
    assert 0 < shape["reads"] < lean.write_start
