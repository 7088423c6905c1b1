"""W1's slot-file plan (circuit/witness_plan.py) on the CPU.

The plan moves every operand of W1's steps into shared memory: constants
into a block-wide table, values from outside the segment into a per-lane
preload area, the segment's own values into registers that interval
colouring reuses. This file replays each segment's records and holds them
to compile_graph's schedule: every reference names the value the node
reads (so no register is overwritten while a later reader needs it, and
none is read in the step that writes it), every value read outside the
launch (signals, W2's operands, later segments) has its global store and
no other does, and the files have the sizes stated below. Then the plain
W1 on the plan against the JAX package's evaluator, exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from zerokit_tpu.circuit import graph as jgm
from zerokit_tpu.circuit.witness_eval import WitnessEvaluator as JaxEvaluator
from zerokit_tpu_torch.circuit import graph as gm
from zerokit_tpu_torch.circuit import witness_eval as we
from zerokit_tpu_torch.circuit import witness_kernels as wk
from zerokit_tpu_torch.circuit import witness_plan as wp
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.resources import resource_path
from zerokit_tpu_torch.tools.witness_graphs import edge_case_graph

torch.set_num_threads(1)

GRAPHS = {
    "depth20": ("tree_depth_20/graph.bin", None),
    "depth20_multi": ("tree_depth_20/multi_message_id/max_out_4/graph.bin", 4),
}
# the plan's interval colouring: (registers, preload) of each segment
FILE_SIZES = {
    "depth20": [(29, 4), (27, 47)],
    "depth20_multi": [(19, 11), (19, 101), (0, 80), (75, 58)],
}


def compiled_graph(name):
    rel, max_out = GRAPHS[name]
    return we.compile_graph(gm.graph_from_file(resource_path(rel), 20, max_out))


def check_plan(compiled, plan):
    """Replays every segment's records against compile_graph's schedule."""
    const_slot = compiled.const_slots
    const_index = {int(c): i for i, c in enumerate(const_slot)}
    assert np.array_equal(plan.const_words, wp.const_words(compiled))
    outside = set(compiled.output_slots.tolist())
    for seg in compiled.segments:
        outside |= set(seg.div_ia.tolist()) | set(seg.div_ib.tolist())
    for seg, sp in zip(compiled.segments, plan.segments):
        lo, hi = seg.write_start, seg.write_start + seg.ops.size
        outside |= {int(s) for s in sp.preload}
        # every preload slot lies outside the segment and is no constant
        assert all(not lo <= s < hi and s not in const_index for s in sp.preload)
    n_c = len(const_slot)
    for seg, sp in zip(compiled.segments, plan.segments):
        f = wp.decode(sp.records)
        base = n_c + len(sp.preload)
        holder = {}  # register -> the slot it holds now
        stores = set()
        for t in range(len(seg.ops)):
            written, read = set(), set()
            for w in range(we.W):
                op, slot = int(seg.ops[t, w]), seg.write_start + t * we.W + w
                if op == we.F_NOP:
                    assert f["op"][t, w] == we.F_NOP and f["slot"][t, w] == -1
                    assert f["dst"][t, w] == wp.NO_REG
                    continue
                want = [int(seg.ia[t, w]), int(seg.ib[t, w]), int(seg.ic[t, w])]
                assert f["op"][t, w] == op
                used = {we.F_NEG: [0], we.F_TERN: [0, 1, 2]}.get(op, [0, 1])
                for j in used:
                    ref = int(f["abc"[j]][t, w])
                    if ref < n_c:
                        got = int(const_slot[ref])
                    elif ref < base:
                        got = int(sp.preload[ref - n_c])
                    else:
                        got = holder.get(ref)
                        read.add(ref)
                    # a register still holds the value its reader needs
                    assert got == want[j], (t, w, j)
                dst = int(f["dst"][t, w])
                if dst != wp.NO_REG:
                    assert base <= dst < base + sp.n_regs
                    written.add(dst)
                    holder[dst] = slot
                glob = int(f["slot"][t, w])
                assert glob in (-1, slot)
                assert (glob == slot) == (slot in outside)
                if glob >= 0:
                    stores.add(slot)
            # a step's nodes run side by side: none writes a register another reads
            assert not written & read, t
        assert len(stores) == sp.n_stores
    return plan


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_replays_the_schedule(name):
    compiled = compiled_graph(name)
    plan = check_plan(compiled, wp.plan_slot_file(compiled))
    assert [(s.n_regs, len(s.preload)) for s in plan.segments] == FILE_SIZES[name]
    # the constants and the inputs every lane shares, against the values
    # a lane computes and keeps live at once
    assert plan.n_consts > 970 and max(s.n_regs for s in plan.segments) < 100


def test_every_signal_and_div_operand_is_stored():
    compiled = compiled_graph("depth20_multi")
    plan = wp.plan_slot_file(compiled)
    stored = set()
    for sp in plan.segments:
        stored |= set(wp.decode(sp.records)["slot"][wp.decode(sp.records)["slot"] >= 0].tolist())
    computed = {int(s) for seg in compiled.segments for s in range(seg.write_start,
                                                                 seg.write_start + seg.ops.size)}
    divs = {int(s) for seg in compiled.segments for s in np.concatenate([seg.div_ia, seg.div_ib])}
    assert (set(compiled.output_slots.tolist()) | divs) & computed <= stored
    assert sum(sp.n_stores for sp in plan.segments) == len(stored)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n_inputs=st.integers(1, 3))
def test_plan_invariants_on_seeded_edge_graphs(seed, n_inputs):
    graph, _ = edge_case_graph(np.random.default_rng(seed), 2, n_inputs)
    graph.signals = graph.signals[::5]  # fewer signals: registers carry the rest
    compiled = we.compile_graph(graph)
    check_plan(compiled, wp.plan_slot_file(compiled))


@pytest.mark.parametrize("lanes", [2, 3])
def test_plain_w1_on_the_plan_equals_jax(lanes):
    graph, values = edge_case_graph(np.random.default_rng(40 + lanes), lanes, 6)
    graph.signals = graph.signals[::3]
    ev = we.WitnessEvaluator(we.compile_graph(graph), "cpu")
    assert any(s.n_regs for s in ev.plan.segments)
    inputs = ev.build_input_buffer({"x": [list(row) for row in values]}, lanes)
    wk.reset_launches()
    out = ev.evaluate_mont(inputs.copy())
    assert wk.launches == {"witness_steps": 0, "witness_div": 0}
    jgraph = jgm.Graph(nodes=[jgm.Node(**vars(n)) for n in graph.nodes], signals=graph.signals,
                       input_mapping=graph.input_mapping, tree_depth=0, max_out=1)
    want = np.asarray(JaxEvaluator(jgraph).evaluate_mont(inputs))
    assert np.array_equal(out.numpy().astype(np.uint32), want)


def test_smem_size_matches_the_wrapper():
    # the size the wrapper checks: a 64-step ring of 4 records of 16 B, 32 B
    # a constant, and 32 B a preloaded value or register of each of a
    # block's two lanes; every segment of both depth-20 graphs fits
    for name in ("depth20", "depth20_multi"):
        plan = wp.plan_slot_file(compiled_graph(name))
        for seg in plan.segments:
            n = wk.steps_smem_bytes(len(seg.preload), seg.n_regs, plan.n_consts)
            assert n == 4096 + 32 * plan.n_consts + 64 * (len(seg.preload) + seg.n_regs)
            assert n <= wk.MAX_SMEM
    lean = wp.plan_slot_file(compiled_graph("depth20")).segments[1]
    assert wk.steps_smem_bytes(len(lean.preload), lean.n_regs, 979) == 40160


@pytest.mark.parametrize("field", ["ref", "slot", "dst", "op"])
def test_wrapper_rejects_records_outside_the_file(field):
    buf = torch.zeros((2, 4, 8), dtype=torch.int32)
    consts = torch.zeros((1, 8), dtype=torch.int32)
    # one constant, one preloaded value: references 0 and 1; no registers
    rec = {"ref": [we.F_ADD | wp.NO_REG << 16, 1 | 5 << 16, 1, 1],
           "slot": [we.F_ADD | wp.NO_REG << 16, 1, 1, 4],
           "dst": [we.F_ADD | 1 << 16, 1, 1, 1],
           "op": [we.N_RICH | wp.NO_REG << 16, 1, 1, 1]}[field]
    records = torch.tensor([[rec] + [[wp.NO_REG << 16, 0, 0, -1]] * 3],
                           dtype=torch.int64).to(torch.int32)
    with pytest.raises(RuntimeError, match="outside the slot file"):
        wk.witness_steps(buf, records, torch.tensor([2], dtype=torch.int32), 0, consts,
                         rich=False)


def test_segment_work_counts_the_chain_model_steps():
    from zerokit_tpu_torch.runtime import profiling

    compiled = compiled_graph("depth20")
    plan = wp.plan_slot_file(compiled)
    lean, sp = compiled.segments[1], plan.segments[1]
    shape = profiling.segment_work(lean, 16, sp.records, plan.n_consts)
    # the depth-20 lean segment: 10,590 steps; 4,543 with a variable x
    # variable Mul, 3,016 whose only products are by a constant
    assert (shape["steps"], shape["var_steps"], shape["const_steps"]) == (10590, 4543, 3016)
    assert shape["stores"] == sp.n_stores
    imads, nbytes = profiling.kernel_work("W1", **shape)
    assert nbytes == 10590 * 64 + (shape["reads"] + sp.n_stores) * 16 * 32


def test_kernel_constants_equal_the_plan():
    import os
    import re

    src = open(os.path.join(os.path.dirname(__file__), "..", "zerokit_tpu_torch", "csrc",
                            "witness_kernels.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\w+);", src).group(1).rstrip("u"), 0)

    assert const("kNoReg") == wp.NO_REG
    assert const("kRingSteps") == wp.RING_STEPS
    assert const("kLanes") == wk.LANES_PER_BLOCK
