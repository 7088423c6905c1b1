"""W1's slot-file plan: a pass after compile_graph for csrc/witness_kernels.cu.

compile_graph gives every node a slot of the global (lanes, n_slots, 8) slot
buffer and packs the nodes into steps of W. W1 runs a segment's steps as a
chain whose length is the graph's depth, so each step's latency is its time.
This pass moves every operand read of a step into shared memory:

  * a block-wide constant table: every constant's Montgomery value, loaded
    once per block (the same for every lane);
  * a per-lane preload area: the inputs and the values of earlier segments
    and of W2 that the segment reads, copied from the slot buffer at launch
    start;
  * a per-lane register file: every value the segment computes and reads
    again inside the segment, in a register that interval colouring over
    the step order assigns; a register is reused from the step after its
    last reader (a step's nodes run side by side, so a register read in
    step t is free for a value written in step t + 1);
  * a global store for every value that something outside the launch reads:
    the signals (the output gather), W2's operands and the values of later
    segments. The kernel never reads them back inside the launch.

Operands name one space of 16-bit references: [0, n_consts) the constant
table, then the lane's preload area, then its registers. One record a node,
four int32 words:

    word 0   op | dst << 16     dst: a register reference, or NO_REG
    word 1   a | b << 16        operand references
    word 2   c                  the third operand (TernCond)
    word 3   the global slot the value is stored to, or -1

A NOP (step padding) reads and writes nothing.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import witness_eval as we

NO_REG = 0xFFFF
MAX_REFS = NO_REG  # references are 16-bit; NO_REG is not one
RECORD_WORDS = 4
RING_STEPS = 64  # W1's schedule ring in shared memory: two halves of 32 steps
SLOT_WORDS = 8  # 32-bit words of one value


class SlotFileTooLarge(ValueError):
    """The plan does not fit W1's references or its shared memory."""


@dataclass
class SegmentPlan:
    rich: bool
    records: np.ndarray  # (steps, W, 4) int32
    preload: np.ndarray  # (n_preload,) int32 global slots, in reference order
    n_regs: int  # the register file's size a lane
    n_stores: int  # nodes stored to the slot buffer


@dataclass
class SlotPlan:
    const_words: np.ndarray  # (n_consts, 8) uint32: Montgomery values
    segments: List[SegmentPlan]

    @property
    def n_consts(self) -> int:
        return len(self.const_words)


def const_words(compiled: we.CompiledGraph) -> np.ndarray:
    """(n_consts, 8) uint32 Montgomery words of compile_graph's constants."""
    limbs = compiled.const_values.astype(np.uint32)  # (16, n) 16-bit limbs
    return (limbs[0::2] | (limbs[1::2] << 16)).T.copy()


def _reads(op: int, a: int, b: int, c: int) -> List[int]:
    """The slots a node of this op code reads (compile_graph fills unused
    operands with a)."""
    if op == we.F_NOP:
        return []
    if op == we.F_NEG:
        return [a]
    if op == we.F_TERN:
        return [a, b, c]
    return [a, b]


def plan_slot_file(compiled: we.CompiledGraph) -> SlotPlan:
    """The slot-file plan of every segment of a compiled graph."""
    const_index = {int(s): i for i, s in enumerate(compiled.const_slots)}
    n_consts = len(const_index)

    # slots something outside a segment's launch reads: the output gather,
    # W2's operands, and (below) every later segment's preload
    outside = set(compiled.output_slots.tolist())
    for seg in compiled.segments:
        outside.update(seg.div_ia.tolist())
        outside.update(seg.div_ib.tolist())

    seg_reads = []
    for seg in compiled.segments:
        lo, hi = seg.write_start, seg.write_start + seg.ops.size
        pre: Dict[int, int] = {}
        last: Dict[int, int] = {}  # slot written here -> last step reading it
        for t in range(len(seg.ops)):
            for w in range(we.W):
                for s in _reads(int(seg.ops[t, w]), int(seg.ia[t, w]), int(seg.ib[t, w]),
                                int(seg.ic[t, w])):
                    if lo <= s < hi:
                        last[s] = t
                    elif s not in const_index:
                        pre.setdefault(s, len(pre))
        seg_reads.append((pre, last))
        outside.update(pre)

    plans = []
    for seg, (pre, last) in zip(compiled.segments, seg_reads):
        n_pre = len(pre)
        base = n_consts + n_pre
        reg: Dict[int, int] = {}
        free: List[int] = []  # registers free for the current step (a min-heap)
        releases: Dict[int, List[int]] = {}  # step -> registers free from then on
        n_regs = 0

        def ref(s: int) -> int:
            if s in const_index:
                return const_index[s]
            if s in pre:
                return n_consts + pre[s]
            return base + reg[s]

        steps = len(seg.ops)
        rec = np.zeros((steps, we.W, RECORD_WORDS), dtype=np.int64)
        stores = 0
        for t in range(steps):
            for r in releases.pop(t, []):
                heapq.heappush(free, r)
            for w in range(we.W):
                op = int(seg.ops[t, w])
                slot = seg.write_start + t * we.W + w
                if op == we.F_NOP:
                    rec[t, w] = (we.F_NOP | NO_REG << 16, 0, 0, -1)
                    continue
                a, b, c = int(seg.ia[t, w]), int(seg.ib[t, w]), int(seg.ic[t, w])
                refs = (ref(a), ref(b), ref(c))
                dst = NO_REG
                if slot in last:
                    if free:
                        r = heapq.heappop(free)
                    else:
                        r, n_regs = n_regs, n_regs + 1
                    reg[slot] = r
                    releases.setdefault(last[slot] + 1, []).append(r)
                    dst = base + r
                glob = slot if slot in outside else -1
                stores += glob >= 0
                rec[t, w] = (op | dst << 16, refs[0] | refs[1] << 16, refs[2], glob)
        if base + n_regs > MAX_REFS:
            raise SlotFileTooLarge(f"{base + n_regs} shared values exceed W1's 16-bit "
                                   f"references ({MAX_REFS})")
        plans.append(SegmentPlan(
            rich=seg.kind == "rich",
            records=(rec & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
            preload=np.asarray(sorted(pre, key=pre.get), dtype=np.int32),
            n_regs=n_regs, n_stores=int(stores)))
    return SlotPlan(const_words=const_words(compiled), segments=plans)


def decode(records: np.ndarray) -> Dict[str, np.ndarray]:
    """The fields of (..., 4) int32 records as int64 arrays."""
    r = records.astype(np.int64) & 0xFFFFFFFF
    return {"op": r[..., 0] & 0xFFFF, "dst": r[..., 0] >> 16, "a": r[..., 1] & 0xFFFF,
            "b": r[..., 1] >> 16, "c": r[..., 2], "slot": records[..., 3].astype(np.int64)}

