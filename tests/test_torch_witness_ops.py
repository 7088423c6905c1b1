"""The witness evaluator's step semantics, every op, three ways.

On a seeded graph holding every op code the evaluator takes
(tools/witness_graphs.edge_case_graph: edge inputs, Div by zero, lean and rich
segments, three Div groups), the port's plain evaluator (the kernels' plain
versions on CPU tensors) must equal the JAX package's WitnessEvaluator
(XLA on the CPU) on the whole assignment, and the host interpreter
(witness_host) node by node wherever the host defines a result: the host
raises on a bitwise result of exactly p (Bor of p - 1 and 1), which the
JAX package and the port keep as p; those nodes and what depends on them
are left out of the host comparison. Then the plain helpers one by one.
"""

import numpy as np
import pytest
import torch

from zerokit_tpu.circuit import graph as jgm
from zerokit_tpu.circuit.witness_eval import WitnessEvaluator as JaxEvaluator
from zerokit_tpu.ff.field import FrField as JaxFr
from zerokit_tpu_torch.circuit import graph as gm
from zerokit_tpu_torch.circuit import witness_eval as we
from zerokit_tpu_torch.circuit import witness_host as wh
from zerokit_tpu_torch.circuit import witness_kernels as wk
from zerokit_tpu_torch.circuit import witness_plan as wp
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import FR, FrPlain, encode_canonical_fast
from zerokit_tpu_torch.tools.witness_graphs import EDGE_VALUES, edge_case_graph

torch.set_num_threads(1)

LANES = 4


def host_values(graph, values, lane):
    """Each node's value under the host interpreter's semantics, None where
    the host raises or an operand is None."""
    out = []
    for n in graph.nodes:
        try:
            if n.kind == gm.K_INPUT:
                v = int(values[n.a - 1, lane])
            elif n.kind == gm.K_CONST:
                v = n.const % R
            elif n.kind == gm.K_UNO:
                v = None if out[n.a] is None else wh.eval_uno(n.op, out[n.a])
            elif n.kind == gm.K_DUO:
                a, b = out[n.a], out[n.b]
                v = None if a is None or b is None else wh.eval_duo(n.op, a, b)
            else:
                a, b, c = out[n.a], out[n.b], out[n.c]
                v = None if None in (a, b, c) else wh.eval_tres(n.op, a, b, c)
        except wh.WitnessCalcError:
            v = None
        out.append(v)
    return out


@pytest.fixture(scope="module")
def edge():
    graph, values = edge_case_graph(np.random.default_rng(6), LANES)
    compiled = we.compile_graph(graph)
    ev = we.WitnessEvaluator(compiled, "cpu")
    inputs = ev.build_input_buffer({"x": [list(row) for row in values]}, LANES)
    wk.reset_launches()
    out = ev.evaluate_mont(inputs.copy())
    return graph, values, compiled, inputs, out


def test_edge_graph_holds_every_op(edge):
    graph, values, compiled, _, _ = edge
    codes = set()
    for seg in compiled.segments:
        codes |= set(np.unique(seg.ops).tolist())
    assert codes == set(range(we.N_RICH))  # NOP too
    assert sum(s.div_out.size for s in compiled.segments) > 0
    assert {s.kind for s in compiled.segments} == {"lean", "rich"}
    divs = [n for n in graph.nodes if n.kind == gm.K_DUO and n.op == gm.OP_DIV]
    assert any(int(values[graph.nodes[n.b].a - 1, 0]) == 0
               for n in divs if graph.nodes[n.b].kind == gm.K_INPUT)
    assert set(int(v) for v in values[:, 0]) >= set(EDGE_VALUES)


def test_edge_graph_plain_equals_jax(edge):
    graph, _, _, inputs, out = edge
    jgraph = jgm.Graph(nodes=[jgm.Node(**vars(n)) for n in graph.nodes], signals=graph.signals,
                       input_mapping=graph.input_mapping, tree_depth=0, max_out=1)
    want = np.asarray(JaxEvaluator(jgraph).evaluate_mont(inputs))
    assert out.dtype == torch.int32 and out.shape == want.shape
    assert np.array_equal(out.numpy().astype(np.uint32), want)


def test_edge_graph_plain_equals_host(edge):
    graph, values, _, _, out = edge
    undefined = 0
    for lane in range(LANES):
        got = [int(v) for v in FR.decode(out[:, :, lane])]
        want = host_values(graph, values, lane)
        undefined += sum(v is None for v in want)
        assert all(w is None or g == w for g, w in zip(got, want))
    # Bor(p - 1, 1) = p: the host raises there, the evaluator gives 0
    assert 0 < undefined < len(graph.nodes)


def test_edge_graph_ran_no_kernel(edge):
    assert wk.launches == {"witness_steps": 0, "witness_div": 0}


def test_evaluate_leaves_the_caller_buffer_alone():
    graph, values = edge_case_graph(np.random.default_rng(1), 2)
    ev = we.WitnessEvaluator(we.compile_graph(graph), "cpu")
    inputs = ev.build_input_buffer({"x": [list(row) for row in values]}, 2)
    before = inputs.copy()
    ev.load(inputs)
    inputs.fill(0)  # the device copy is independent of the host buffer
    assert int(ev.slot_buffer(2)[:, ev.input_slots].abs().sum()) > 0
    assert np.array_equal(ev.build_input_buffer({"x": [list(r) for r in values]}, 2), before)


# ---------------------------------------------------------------------------
# The plain helpers
# ---------------------------------------------------------------------------

SHIFTS = [0, 1, 31, 32, 33, 100, 253, 254, 255, 1 << 16, (1 << 16) + 1, 1 << 32, R - 1]
VALUES = [0, 1, R - 1, (R - 1) // 2, (R + 1) // 2, (1 << 253) + 12345, 0xDEADBEEF << 140]


def canon(xs):
    return encode_canonical_fast(xs)


@pytest.mark.parametrize("b", SHIFTS)
def test_dynamic_shr(b):
    a = canon(VALUES)
    got = wk._dynamic_shr(a, canon([b] * len(VALUES)))
    assert FR.decode(got, mont=False).tolist() == [wh.eval_duo(gm.OP_SHR, v, b) for v in VALUES]


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 64, 128, 255])
def test_canon_shift_right_const_equals_jax(k):
    a = canon(VALUES)
    got = FrPlain.canon_shift_right_const(a, k)
    want = np.asarray(JaxFr.canon_shift_right_const(a.numpy().astype(np.uint32), k))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_signed_lt_and_bitwise_fix():
    pairs = [(a, b) for a in VALUES for b in VALUES]
    a = canon([p[0] for p in pairs])
    b = canon([p[1] for p in pairs])
    got = wk._signed_lt(a, b).tolist()
    assert got == [wh.eval_duo(gm.OP_LT, x, y) == 1 for x, y in pairs]
    d = canon([R - 1, R, R + 1, (1 << 254) - 1, 5])
    fixed = FR.decode(wk._bitwise_fix(d), mont=False).tolist()
    assert fixed == [R - 1, R, 1, (1 << 254) - 1 - R, 5]  # d = p stays p


def test_eq_is_limbwise():
    a = canon([0, 5, R - 1])
    assert FrPlain.eq(a, canon([0, 5, R - 2])).tolist() == [True, True, False]


def test_layout_round_trip():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 1 << 16, size=(16, 7, 3)).astype(np.int32))
    words = wk.limbs_to_words(x)
    assert words.shape == (3, 7, 8) and words.dtype == torch.int32
    assert torch.equal(wk.words_to_limbs(words), x)
    # word k of a value packs limbs 2k (low) and 2k+1 (high)
    w = int(words[1, 4, 2]) & 0xFFFFFFFF
    assert w == int(x[4, 4, 1]) | (int(x[5, 4, 1]) << 16)


def test_step_plain_rejects_rich_codes_in_a_lean_step():
    z = torch.zeros((16, we.W, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        wk.step_plain(np.array([we.F_SHR, 0, 0, 0]), z, z, z, rich=False)


def test_div_plain_by_zero_is_zero():
    buf = torch.zeros((2, 4, 8), dtype=torch.int32)
    mont = FR.encode([[7, 7], [0, 3]])  # slot 1 = 7, slot 2 = (0, 3) over two lanes
    buf[:, 1:3] = wk.limbs_to_words(mont)
    idx = [torch.tensor([v], dtype=torch.int32) for v in (1, 2, 3)]
    wk.witness_div(buf, *idx)
    got = FR.decode(wk.words_to_limbs(buf)[:, 3])
    assert got.tolist() == [0, 7 * pow(3, -1, R) % R]


@pytest.mark.parametrize("kernel", ["steps", "div"])
@pytest.mark.parametrize("slot", [-1, 4])
def test_wrappers_reject_slots_outside_the_buffer(kernel, slot):
    buf = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="must lie in"):
        if kernel == "steps":
            # one Add of the preloaded slot and constant 0 into slot 1
            records = torch.tensor([[[we.F_ADD | wp.NO_REG << 16, 1, 0, 1]]
                                    + [[we.F_NOP | wp.NO_REG << 16, 0, 0, -1]] * 3],
                                   dtype=torch.int64).to(torch.int32)
            consts = torch.zeros((1, 8), dtype=torch.int32)
            wk.witness_steps(buf, records, torch.tensor([slot], dtype=torch.int32), 0, consts,
                             rich=False)
        else:
            idx = [torch.tensor([v], dtype=torch.int32) for v in (1, slot, 3)]
            wk.witness_div(buf, *idx)
