"""Batched witness evaluation on the card: the step compiler and the evaluator.

Counterpart of zerokit_tpu/circuit/witness_eval.py. The reference evaluates
the circom graph one node at a time for one proof
(rln/src/circuit/iden3calc/graph.rs:246-272); its critical path is ~10K
levels deep (the Poseidon chain), so the card evaluates the whole batch of
proofs at every node instead.

  * compile_graph (copied from the JAX package; it must give the same
    arrays): a slot buffer holds every value, nodes are packed into steps of
    W nodes of one level (NOPs pad a step), each step owns a contiguous
    W-slot window, and levels are grouped into LEAN and RICH segments; a
    level holding Div closes a segment, and its Divs run after the
    segment's steps.
  * WitnessEvaluator: loads the constants and the inputs into the slot
    buffer, runs each segment's steps in one launch of W1 on the segment's
    slot-file plan (circuit/witness_plan.py, made once at construction) and
    its Divs in one launch of W2 (circuit/witness_kernels.py), and gathers
    the signals into the (16, n_signals, B) Montgomery assignment.
  * unknown_mask: the wires that two-phase proving cannot know before the
    message, those reachable from its inputs (MESSAGE_INPUTS). The
    evaluator computes a partial witness as a full one with those inputs
    at 0: the other wires do not depend on them.
  * Pow/Idiv/Mod/Shl never occur in RLN circuits; compile_graph rejects
    graphs holding them (UnsupportedGraph) and the prover then serves such a
    graph with the exact host interpreter (witness_host.py).

The JAX package pads each segment's steps to 64-step size classes for XLA's
compile cache; the kernel takes the step count, so there is no padding.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..constants import NUM_LIMBS, R
from ..ff.field import FR, FrField, encode_canonical_fast, resolve_device
from ..runtime.profiling import span
from . import graph as g
from . import witness_kernels as wk
from . import witness_plan

W = 4  # scan step width (nodes per step); avg level width is ~2.3

# fast-op codes used inside scan bodies
F_NOP = 0
F_MUL = 1
F_ADD = 2
F_SUB = 3
F_NEG = 4
F_EQ = 5
F_NEQ = 6
F_LAND = 7
F_LOR = 8
F_TERN = 9
# rich-only codes
F_SHR = 10
F_BAND = 11
F_BOR = 12
F_BXOR = 13
F_LT = 14
F_GT = 15
F_LEQ = 16
F_GEQ = 17

N_LEAN = 10
N_RICH = 18

_LEAN_MAP = {
    g.OP_MUL: F_MUL,
    g.OP_ADD: F_ADD,
    g.OP_SUB: F_SUB,
    g.OP_EQ: F_EQ,
    g.OP_NEQ: F_NEQ,
    g.OP_LAND: F_LAND,
    g.OP_LOR: F_LOR,
}
_RICH_MAP = {
    g.OP_SHR: F_SHR,
    g.OP_BAND: F_BAND,
    g.OP_BOR: F_BOR,
    g.OP_BXOR: F_BXOR,
    g.OP_LT: F_LT,
    g.OP_GT: F_GT,
    g.OP_LEQ: F_LEQ,
    g.OP_GEQ: F_GEQ,
}
_UNSUPPORTED = {g.OP_POW, g.OP_IDIV, g.OP_MOD, g.OP_SHL}


# the inputs a partial witness leaves unknown (the message's; reference
# witness.rs:887-937, RLNPartialWitnessInput.named_inputs_partial)
MESSAGE_INPUTS = ("messageId", "selectorUsed", "x", "externalNullifier")


def unknown_mask(graph: g.Graph, message_inputs: Sequence[str] = MESSAGE_INPUTS) -> np.ndarray:
    """(n_signals,) bool: the wires that calc_witness_partial leaves None
    when the message inputs are unknown, found from the graph alone: an
    input node is unknown unless it reads position 0 or an input other
    than the message's, and a node is unknown if any operand is (the
    reference propagates None through every operand, graph.rs:274-312)."""
    known_pos = np.zeros(g.inputs_size(graph.nodes), dtype=bool)
    known_pos[0] = True
    for name, (offset, length) in graph.input_mapping.items():
        if name not in message_inputs:
            known_pos[offset:offset + length] = True
    unknown = np.zeros(len(graph.nodes), dtype=bool)
    for i, node in enumerate(graph.nodes):
        if node.kind == g.K_INPUT:
            unknown[i] = node.a >= len(known_pos) or not known_pos[node.a]
        elif node.kind == g.K_UNO:
            unknown[i] = unknown[node.a]
        elif node.kind == g.K_DUO:
            unknown[i] = unknown[node.a] or unknown[node.b]
        elif node.kind != g.K_CONST:
            unknown[i] = unknown[node.a] or unknown[node.b] or unknown[node.c]
    return unknown[np.asarray(graph.signals, dtype=np.int64)]


class UnsupportedGraph(ValueError):
    """Graph uses ops outside the device evaluator; use the host interpreter."""


@dataclass
class Segment:
    kind: str  # "lean" | "rich"
    ops: np.ndarray  # (steps, W) int32
    ia: np.ndarray
    ib: np.ndarray
    ic: np.ndarray
    write_start: int  # first slot of the segment's contiguous step windows
    div_ia: np.ndarray  # Div nodes executed after the scan: (n,) each
    div_ib: np.ndarray
    div_out: np.ndarray
    node_ids: np.ndarray = None  # (steps, W) node index per lane (-1 = NOP pad)
    div_node_ids: np.ndarray = None


@dataclass
class CompiledGraph:
    graph: g.Graph
    n_slots: int
    const_slots: np.ndarray  # (n_consts,)
    const_values: np.ndarray  # (16, n_consts) Montgomery
    input_positions: np.ndarray  # (n_input_nodes,) index into input buffer
    input_slots: np.ndarray  # (n_input_nodes,)
    inputs_size: int
    segments: List[Segment]
    output_slots: np.ndarray  # (n_signals,)
    scratch_write: int = 0  # W-slot window that padded steps write into


def compile_graph(graph: g.Graph) -> CompiledGraph:
    nodes = graph.nodes
    n = len(nodes)
    for node in nodes:
        if node.kind == g.K_DUO and node.op in _UNSUPPORTED:
            raise UnsupportedGraph(f"op {g.DUO_OP_NAMES[node.op]} not on the device path")
        if node.kind == g.K_UNO and node.op == g.UNO_ID:
            raise UnsupportedGraph("UnoOp::Id is an error in the reference interpreter")

    # node levels (operands strictly precede in index order)
    level = [0] * n
    for i, node in enumerate(nodes):
        if node.kind == g.K_UNO:
            level[i] = level[node.a] + 1
        elif node.kind == g.K_DUO:
            level[i] = max(level[node.a], level[node.b]) + 1
        elif node.kind == g.K_TRES:
            level[i] = max(level[node.a], level[node.b], level[node.c]) + 1
    n_levels = max(level) + 1 if n else 0
    by_level: List[List[int]] = [[] for _ in range(n_levels)]
    for i in range(n):
        if nodes[i].kind not in (g.K_INPUT, g.K_CONST):
            by_level[level[i]].append(i)

    def level_kind(lv: List[int]) -> str:
        kind = "lean"
        for i in lv:
            node = nodes[i]
            if node.kind == g.K_DUO and node.op in _RICH_MAP:
                kind = "rich"
            if node.kind == g.K_DUO and node.op == g.OP_DIV:
                return "div"
        return kind

    # group consecutive levels into segments; a level containing Div closes one
    raw_segments: List[Tuple[str, List[int], List[int]]] = []  # (kind, scan_nodes, div_nodes)
    cur_kind = None
    cur_nodes: List[int] = []
    for lv in range(1, n_levels):
        nodes_here = by_level[lv]
        if not nodes_here:
            continue
        k = level_kind(nodes_here)
        if k == "div":
            divs = [i for i in nodes_here if nodes[i].kind == g.K_DUO and nodes[i].op == g.OP_DIV]
            rest = [i for i in nodes_here if i not in set(divs)]
            rk = level_kind(rest) if rest else (cur_kind or "lean")
            merged_kind = "rich" if ("rich" in (cur_kind, rk)) else "lean"
            raw_segments.append((merged_kind, cur_nodes + rest, divs))
            cur_kind, cur_nodes = None, []
        elif cur_kind is None or k == cur_kind:
            cur_kind = k if cur_kind is None else cur_kind
            cur_nodes.extend(nodes_here)
        else:
            raw_segments.append((cur_kind, cur_nodes, []))
            cur_kind, cur_nodes = k, list(nodes_here)
    if cur_nodes:
        raw_segments.append((cur_kind or "lean", cur_nodes, []))

    # Slot allocation is append-only: each step owns a contiguous W-slot
    # window and a node's slot is its window position. Values are never
    # overwritten; the buffer grows to ~W * n_steps slots (~43K for the
    # depth-20 graph). Slot 0 = scratch zero that NOP pad lanes read (never
    # written).
    slot_of = [-1] * n
    next_slot = 1

    const_nodes = [i for i in range(n) if nodes[i].kind == g.K_CONST]
    input_nodes = [i for i in range(n) if nodes[i].kind == g.K_INPUT]
    for i in const_nodes + input_nodes:
        slot_of[i] = next_slot
        next_slot += 1

    segments: List[Segment] = []
    for kind, scan_nodes, div_nodes in raw_segments:
        steps_ops, steps_ia, steps_ib, steps_ic = [], [], [], []
        steps_nid = []
        write_start = next_slot
        # chunk by level boundaries inside the segment: nodes are in level
        # order; nodes of the same level are independent. We must not put a
        # node in the same step as its operand; chunking within a single
        # level is always safe.
        i0 = 0
        while i0 < len(scan_nodes):
            this_level = level[scan_nodes[i0]]
            i1 = i0
            while i1 < len(scan_nodes) and level[scan_nodes[i1]] == this_level:
                i1 += 1
            for c0 in range(i0, i1, W):
                chunk = scan_nodes[c0 : min(c0 + W, i1)]
                ops_row, ia_row, ib_row, ic_row = [], [], [], []
                nid_row = list(chunk)
                for lane, i in enumerate(chunk):
                    node = nodes[i]
                    if node.kind == g.K_UNO:
                        code, a, b, c = F_NEG, node.a, node.a, node.a
                    elif node.kind == g.K_TRES:
                        code, a, b, c = F_TERN, node.a, node.b, node.c
                    elif node.op == g.OP_MUL:
                        code, a, b, c = F_MUL, node.a, node.b, node.a
                    elif node.op in _LEAN_MAP:
                        code, a, b, c = _LEAN_MAP[node.op], node.a, node.b, node.a
                    else:
                        code, a, b, c = _RICH_MAP[node.op], node.a, node.b, node.a
                    ia_row.append(slot_of[a])
                    ib_row.append(slot_of[b])
                    ic_row.append(slot_of[c])
                    ops_row.append(code)
                    slot_of[i] = next_slot + lane
                while len(ops_row) < W:
                    ops_row.append(F_NOP)
                    ia_row.append(0)
                    ib_row.append(0)
                    ic_row.append(0)
                    nid_row.append(-1)
                next_slot += W  # pad lanes own (and zero) their slots
                steps_ops.append(ops_row)
                steps_ia.append(ia_row)
                steps_ib.append(ib_row)
                steps_ic.append(ic_row)
                steps_nid.append(nid_row)
            i0 = i1
        div_ia, div_ib, div_out = [], [], []
        for i in div_nodes:
            node = nodes[i]
            div_ia.append(slot_of[node.a])
            div_ib.append(slot_of[node.b])
            slot_of[i] = next_slot
            div_out.append(next_slot)
            next_slot += 1

        def arr(x, dtype=np.int32):
            return np.asarray(x, dtype=dtype)

        segments.append(
            Segment(
                kind=kind,
                ops=arr(steps_ops),
                ia=arr(steps_ia),
                ib=arr(steps_ib),
                ic=arr(steps_ic),
                write_start=write_start,
                div_ia=arr(div_ia),
                div_ib=arr(div_ib),
                div_out=arr(div_out),
                node_ids=arr(steps_nid, np.int64),
                div_node_ids=arr(div_nodes, np.int64),
            )
        )
    scratch_write = next_slot  # W-slot window that padded-out steps write
    next_slot += W

    const_values = FR.encode([nodes[i].const % R for i in const_nodes]).numpy()
    return CompiledGraph(
        graph=graph,
        n_slots=next_slot,
        const_slots=np.asarray([slot_of[i] for i in const_nodes], dtype=np.int32),
        const_values=const_values.reshape(NUM_LIMBS, len(const_nodes)).astype(np.uint32),
        input_positions=np.asarray([nodes[i].a for i in input_nodes], dtype=np.int32),
        input_slots=np.asarray([slot_of[i] for i in input_nodes], dtype=np.int32),
        inputs_size=g.inputs_size(nodes),
        segments=segments,
        output_slots=np.asarray([slot_of[s] for s in graph.signals], dtype=np.int32),
        scratch_write=scratch_write,
    )


def build_input_buffer(
    compiled: CompiledGraph, named_inputs: Dict[str, Sequence[Sequence[int]]], batch: int
) -> np.ndarray:
    """named_inputs: name -> per-slot list of per-batch ints
    (shape [signal_len][batch]). Returns (16, inputs_size, B) canonical
    uint32 limbs; position 0 holds the constant 1."""
    graph = compiled.graph
    flat_vals: List[int] = []
    positions: List[int] = []
    for name, values in named_inputs.items():
        if name not in graph.input_mapping:
            raise KeyError(f"missing input {name}")
        offset, length = graph.input_mapping[name]
        if length != len(values):
            raise ValueError(
                f"invalid input length for {name}: expected {length}, got {len(values)}"
            )
        for i, per_batch in enumerate(values):
            if len(per_batch) != batch:
                raise ValueError(f"batch mismatch for {name}[{i}]")
            positions.append(offset + i)
            flat_vals.extend(int(v) for v in per_batch)
    out = np.zeros((NUM_LIMBS, compiled.inputs_size, batch), dtype=np.uint32)
    out[0, 0, :] = 1  # constant-1 wire
    if flat_vals:
        enc = encode_canonical_fast(flat_vals).numpy().reshape(NUM_LIMBS, len(positions), batch)
        out[:, np.asarray(positions)] = enc
    return out


@dataclass
class DeviceSegment:
    """A segment's slot-file plan (circuit/witness_plan.py) on the
    evaluator's device."""

    rich: bool
    records: torch.Tensor  # (steps, W, 4) int32
    preload: torch.Tensor  # (n_preload,) int32 slots
    n_regs: int
    div_ia: torch.Tensor  # (n_div,) int32
    div_ib: torch.Tensor
    div_out: torch.Tensor


class WitnessEvaluator:
    """Batched witness evaluation of one compiled graph on one device: the
    card (W1, W2), or the CPU, where the kernels' plain versions run."""

    def __init__(self, compiled: CompiledGraph, device="cuda"):
        self.compiled = cg = compiled
        self.graph = compiled.graph
        self.device = dev = resolve_device(device)
        # the slot buffers are reused by every call of a lane count: one
        # evaluation at a time (the service's worker and its /finish handler
        # evaluate from two threads)
        self._lock = threading.Lock()

        def on_dev(x, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        slots = [cg.const_slots, cg.input_slots, cg.output_slots] + [
            a for seg in cg.segments for a in (seg.ia, seg.ib, seg.ic, seg.div_ia, seg.div_ib,
                                               seg.div_out)]
        if any(a.size and (a.min() < 0 or a.max() >= cg.n_slots) for a in slots):
            raise ValueError(f"a schedule names a slot outside [0, {cg.n_slots})")

        # the slot-file plan goes to the device once (~0.7 MB at depth 20)
        self.plan = plan = witness_plan.plan_slot_file(cg)
        self.segments = [
            DeviceSegment(
                rich=sp.rich, records=on_dev(sp.records), preload=on_dev(sp.preload),
                n_regs=sp.n_regs, div_ia=on_dev(seg.div_ia), div_ib=on_dev(seg.div_ib),
                div_out=on_dev(seg.div_out),
            )
            for seg, sp in zip(cg.segments, plan.segments)
        ]
        self.consts = on_dev(plan.const_words.view(np.int32))  # (n_consts, 8) words
        self.const_slots = on_dev(cg.const_slots, torch.int64)
        self.input_positions = on_dev(cg.input_positions, torch.int64)
        self.input_slots = on_dev(cg.input_slots, torch.int64)
        self.output_slots = on_dev(cg.output_slots, torch.int64)
        self.steps = sum(int(s.records.shape[0]) for s in self.segments)
        self._buffers: Dict[int, torch.Tensor] = {}

    def build_input_buffer(
        self, named_inputs: Dict[str, Sequence[Sequence[int]]], batch: int
    ) -> np.ndarray:
        return build_input_buffer(self.compiled, named_inputs, batch)

    def slot_buffer(self, lanes: int) -> torch.Tensor:
        """The (lanes, n_slots, 8) int32 slot buffer of W1 and W2, allocated
        (zeroed) once per lane count and reused: 22 MB at 16 lanes, 356 MB at
        256 for the depth-20 graph."""
        buf = self._buffers.get(lanes)
        if buf is None:
            buf = torch.zeros((lanes, self.compiled.n_slots, 8), dtype=torch.int32,
                              device=self.device)
            self._buffers[lanes] = buf
        return buf

    def load(self, input_buffer_canon: np.ndarray) -> torch.Tensor:
        """Copies the canonical input buffer to the device (a blocking copy:
        it has completed when this returns, so the caller may scrub its host
        buffer), and writes the constants and the inputs (to_mont, by
        input_positions) into the lanes' slot buffer, which it returns."""
        cg = self.compiled
        x = input_buffer_canon
        if (x.dtype != np.uint32 or x.ndim != 3 or x.shape[:2] != (NUM_LIMBS, cg.inputs_size)
                or not x.flags.c_contiguous):
            # (a copy made here to fix the layout would escape the caller's scrub)
            raise ValueError(f"expected a C-contiguous (16, {cg.inputs_size}, B) uint32 "
                             f"buffer of canonical limbs, got {x.shape} {x.dtype}")
        batch = x.shape[2]
        host = torch.from_numpy(x.view(np.int32))
        inp = host.to(self.device, copy=True)
        buf = self.slot_buffer(batch)
        if self.const_slots.numel():
            buf[:, self.const_slots] = self.consts
        mont = FrField.to_mont(inp[:, self.input_positions].contiguous())
        buf[:, self.input_slots] = wk.limbs_to_words(mont)
        return buf

    def run(self, buf: torch.Tensor) -> torch.Tensor:
        """Every segment in order on the slot buffer: its steps (W1), then
        its Divs (W2), which read the steps' values."""
        for seg in self.segments:
            if seg.records.shape[0]:
                self.steps_of(buf, seg)
            if seg.div_out.numel():
                wk.witness_div(buf, seg.div_ia, seg.div_ib, seg.div_out)
        return buf

    def steps_of(self, buf: torch.Tensor, seg: DeviceSegment, plain: bool = False) -> torch.Tensor:
        """W1 (or, with plain, its plain version) over one segment's steps."""
        args = (buf, seg.records, seg.preload, seg.n_regs, self.consts, seg.rich)
        if plain:
            return wk.witness_steps_plain(*args)
        return wk.witness_steps(*args)

    def evaluate_mont(self, input_buffer_canon: np.ndarray) -> torch.Tensor:
        """input_buffer_canon: (16, inputs_size, B) canonical uint32 limbs
        (position 0 holds the constant 1). Returns the full assignment
        (16, n_signals, B) int32 in Montgomery form on the device."""
        with self._lock, span("witness.eval"):
            buf = self.run(self.load(input_buffer_canon))
            return wk.words_to_limbs(buf[:, self.output_slots])
