"""circom-witnesscalc execution-graph (.bin, `wtns.graph.001`) loader.

File format (reference: rln/src/circuit/iden3calc/storage.rs:16-22):
    magic "wtns.graph.001"
    u64 LE: number of nodes
    nodes: varint-length-delimited protobuf `Node` messages
    protobuf `GraphMetadata` (witness signal indices; input name -> (offset,len))
    u64 LE: byte offset of the metadata message

Protobuf schema (reference: rln/src/circuit/iden3calc/proto.rs):
    Node = oneof { 1: Input{1: idx u32}, 2: Constant{1: BigUInt{1: bytes le}},
                   3: UnoOp{1: op, 2: a}, 4: DuoOp{1: op, 2: a, 3: b},
                   5: TresOp{1: op, 2: a, 3: b, 4: c} }
    GraphMetadata = { 1: repeated u32 witness_signals,
                      2: map<string, SignalDescription{1: offset, 2: len}> }

The decoder below is a minimal hand-rolled protobuf reader (wire types 0/2
only, which is all the schema uses) — no protobuf runtime dependency.

On load the graph is topologically layered for the vectorized TPU interpreter:
nodes are evaluated level by level, where a node's level is
1 + max(level of operands); Input/Constant nodes are level 0.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MAGIC = b"wtns.graph.001"

# Node kinds
K_INPUT = 0
K_CONST = 1
K_UNO = 2
K_DUO = 3
K_TRES = 4

# Duo op codes (reference proto.rs:84-106; order is part of the wire format)
OP_MUL = 0
OP_DIV = 1
OP_ADD = 2
OP_SUB = 3
OP_POW = 4
OP_IDIV = 5
OP_MOD = 6
OP_EQ = 7
OP_NEQ = 8
OP_LT = 9
OP_GT = 10
OP_LEQ = 11
OP_GEQ = 12
OP_LAND = 13
OP_LOR = 14
OP_SHL = 15
OP_SHR = 16
OP_BOR = 17
OP_BAND = 18
OP_BXOR = 19

UNO_NEG = 0
UNO_ID = 1

TRES_TERNCOND = 0

DUO_OP_NAMES = {
    OP_MUL: "Mul", OP_DIV: "Div", OP_ADD: "Add", OP_SUB: "Sub", OP_POW: "Pow",
    OP_IDIV: "Idiv", OP_MOD: "Mod", OP_EQ: "Eq", OP_NEQ: "Neq", OP_LT: "Lt",
    OP_GT: "Gt", OP_LEQ: "Leq", OP_GEQ: "Geq", OP_LAND: "Land", OP_LOR: "Lor",
    OP_SHL: "Shl", OP_SHR: "Shr", OP_BOR: "Bor", OP_BAND: "Band", OP_BXOR: "Bxor",
}


class GraphReadError(ValueError):
    pass


@dataclass
class Node:
    kind: int
    op: int = 0          # duo/uno/tres op code
    a: int = 0           # input index for K_INPUT; operand index otherwise
    b: int = 0
    c: int = 0
    const: int = 0       # constant value for K_CONST (canonical integer)


@dataclass
class Graph:
    nodes: List[Node]
    signals: List[int]                      # witness output wire -> node index
    input_mapping: Dict[str, Tuple[int, int]]  # name -> (offset, len)
    tree_depth: int
    max_out: int
    # topological layering for vectorized evaluation (computed at load)
    levels: List[List[int]] = field(default_factory=list)


# -- minimal protobuf decoding ----------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise GraphReadError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise GraphReadError("varint too long")


def _decode_fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decodes a protobuf message into (field_no, wire_type, value) triples."""
    out = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            if len(val) != ln:
                raise GraphReadError("truncated length-delimited field")
            pos += ln
        else:
            raise GraphReadError(f"unsupported protobuf wire type {wt}")
        out.append((fno, wt, val))
    return out


def _decode_node(buf: bytes) -> Node:
    fields = _decode_fields(buf)
    if not fields:
        # Node with all-default oneof content (e.g. Input{idx:0} encodes empty)
        raise GraphReadError("empty Node message")
    fno, _, val = fields[-1]
    sub = _decode_fields(val) if isinstance(val, (bytes, bytearray)) else []
    vals: Dict[int, object] = {f: v for f, _, v in sub}
    if fno == 1:  # Input
        return Node(kind=K_INPUT, a=int(vals.get(1, 0)))
    if fno == 2:  # Constant (BigUInt bytes, little-endian)
        inner = vals.get(1, b"")
        le = b""
        if isinstance(inner, (bytes, bytearray)):
            for f2, _, v2 in _decode_fields(inner):
                if f2 == 1:
                    le = v2
        return Node(kind=K_CONST, const=int.from_bytes(le, "little"))
    if fno == 3:  # UnoOp
        return Node(kind=K_UNO, op=int(vals.get(1, 0)), a=int(vals.get(2, 0)))
    if fno == 4:  # DuoOp
        return Node(
            kind=K_DUO, op=int(vals.get(1, 0)), a=int(vals.get(2, 0)), b=int(vals.get(3, 0))
        )
    if fno == 5:  # TresOp
        return Node(
            kind=K_TRES,
            op=int(vals.get(1, 0)),
            a=int(vals.get(2, 0)),
            b=int(vals.get(3, 0)),
            c=int(vals.get(4, 0)),
        )
    raise GraphReadError(f"unknown Node oneof field {fno}")


def _decode_metadata(buf: bytes):
    witness_signals: List[int] = []
    inputs: Dict[str, Tuple[int, int]] = {}
    for fno, wt, val in _decode_fields(buf):
        if fno == 1:
            if wt == 2:  # packed repeated u32
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    witness_signals.append(v)
            else:
                witness_signals.append(int(val))
        elif fno == 2:  # map entry: {1: key string, 2: SignalDescription}
            key = ""
            offset = 0
            length = 0
            for f2, _, v2 in _decode_fields(val):
                if f2 == 1:
                    key = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    for f3, _, v3 in _decode_fields(v2):
                        if f3 == 1:
                            offset = int(v3)
                        elif f3 == 2:
                            length = int(v3)
            inputs[key] = (offset, length)
    return witness_signals, inputs


# -- graph file parsing ------------------------------------------------------


def _compute_levels(nodes: List[Node]) -> List[List[int]]:
    level = [0] * len(nodes)
    for i, n in enumerate(nodes):
        if n.kind in (K_INPUT, K_CONST):
            level[i] = 0
        elif n.kind == K_UNO:
            level[i] = level[n.a] + 1
        elif n.kind == K_DUO:
            level[i] = max(level[n.a], level[n.b]) + 1
        else:
            level[i] = max(level[n.a], level[n.b], level[n.c]) + 1
    depth = max(level) + 1 if nodes else 0
    buckets: List[List[int]] = [[] for _ in range(depth)]
    for i, lv in enumerate(level):
        buckets[lv].append(i)
    return buckets


def graph_from_bytes(
    data: bytes,
    expected_tree_depth: int | None = None,
    expected_max_out: int | None = None,
) -> Graph:
    """Parses a graph file (reference: graph_from_raw, circuit/mod.rs:151-203)."""
    if not data:
        raise GraphReadError("empty graph bytes")
    if data[: len(MAGIC)] != MAGIC:
        raise GraphReadError("invalid magic")
    pos = len(MAGIC)
    (num_nodes,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    nodes: List[Node] = []
    for _ in range(num_nodes):
        ln, pos = _read_varint(data, pos)
        nodes.append(_decode_node(data[pos : pos + ln]))
        pos += ln
    ln, pos = _read_varint(data, pos)
    witness_signals, inputs = _decode_metadata(data[pos : pos + ln])

    tree_depth = inputs.get("pathElements", (0, 0))[1]
    if expected_tree_depth is not None and expected_tree_depth != tree_depth:
        raise GraphReadError(
            f"tree depth mismatch: expected {expected_tree_depth}, actual {tree_depth}"
        )
    if "messageId" in inputs:
        max_out = inputs["messageId"][1]
        if expected_max_out is not None and expected_max_out != max_out:
            raise GraphReadError(
                f"max_out mismatch: expected {expected_max_out}, actual {max_out}"
            )
    else:
        max_out = 1

    return Graph(
        nodes=nodes,
        signals=witness_signals,
        input_mapping=inputs,
        tree_depth=tree_depth,
        max_out=max_out,
        levels=_compute_levels(nodes),
    )


def graph_from_file(
    path: str,
    expected_tree_depth: int | None = None,
    expected_max_out: int | None = None,
) -> Graph:
    with open(path, "rb") as f:
        return graph_from_bytes(f.read(), expected_tree_depth, expected_max_out)


def inputs_size(nodes: List[Node]) -> int:
    """Size of the input buffer (reference: iden3calc.rs:106-120)."""
    start = False
    max_index = 0
    for n in nodes:
        if n.kind == K_INPUT:
            max_index = max(max_index, n.a)
            start = True
        elif start:
            break
    return max_index + 1
