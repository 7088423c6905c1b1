"""Host (exact-semantics) witness-graph interpreter over Python ints.

Operator semantics match the reference interpreter bit-for-bit
(rln/src/circuit/iden3calc/graph.rs:72-226):
  * Div/Idiv/Mod return 0 on zero divisor,
  * Pow is modular exponentiation over the Fr modulus,
  * comparisons are signed with the negative range above (p-1)/2,
  * Shl errors if the shifted value leaves the field; Shr drops to 0 at >= 254,
  * bitwise ops subtract p once when the raw result exceeds p (strictly),
  * TernCond selects on a == 0; partial evaluation propagates None.

This is the capability-complete fallback and the parity oracle for the
vectorized TPU interpreter (witness_eval.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .constants import R
from . import graph as g

HALF = (R - 1) // 2
MASK256 = (1 << 256) - 1


class WitnessCalcError(ValueError):
    pass


def _is_neg(a: int) -> bool:
    return a > HALF


def _cmp_signed(a: int, b: int) -> int:
    """-1/0/1 under the signed interpretation (graph.rs:417-466)."""
    an, bn = _is_neg(a), _is_neg(b)
    if an and not bn:
        return -1
    if not an and bn:
        return 1
    return (a > b) - (a < b)


def _shl(a: int, b: int) -> int:
    if b == 0:
        return a
    if b >= 254:
        return 0
    v = (a << b) & MASK256
    if v >= R:
        raise WitnessCalcError("Failed to compute left shift")
    return v


def _shr(a: int, b: int) -> int:
    if b == 0:
        return a
    if b >= 254:
        return 0
    return a >> b


def _bit_result(d: int) -> int:
    if d > R:
        d -= R
    if d >= R:
        raise WitnessCalcError("bitwise op left the field")
    return d


def eval_duo(op: int, a: int, b: int) -> int:
    if op == g.OP_MUL:
        return a * b % R
    if op == g.OP_DIV:
        return 0 if b == 0 else a * pow(b, -1, R) % R
    if op == g.OP_ADD:
        return (a + b) % R
    if op == g.OP_SUB:
        return (a - b) % R
    if op == g.OP_POW:
        return pow(a, b, R)
    if op == g.OP_IDIV:
        return 0 if b == 0 else a // b
    if op == g.OP_MOD:
        return 0 if b == 0 else a % b
    if op == g.OP_EQ:
        return 1 if a == b else 0
    if op == g.OP_NEQ:
        return 0 if a == b else 1
    if op == g.OP_LT:
        return 1 if _cmp_signed(a, b) < 0 else 0
    if op == g.OP_GT:
        return 1 if _cmp_signed(a, b) > 0 else 0
    if op == g.OP_LEQ:
        return 1 if _cmp_signed(a, b) <= 0 else 0
    if op == g.OP_GEQ:
        return 1 if _cmp_signed(a, b) >= 0 else 0
    if op == g.OP_LAND:
        return 0 if (a == 0 or b == 0) else 1
    if op == g.OP_LOR:
        return 0 if (a == 0 and b == 0) else 1
    if op == g.OP_SHL:
        return _shl(a, b)
    if op == g.OP_SHR:
        return _shr(a, b)
    if op == g.OP_BOR:
        return _bit_result(a | b)
    if op == g.OP_BAND:
        return _bit_result(a & b)
    if op == g.OP_BXOR:
        return _bit_result(a ^ b)
    raise WitnessCalcError(f"unknown duo op {op}")


def eval_uno(op: int, a: int) -> int:
    if op == g.UNO_NEG:
        return 0 if a == 0 else R - a
    raise WitnessCalcError(f"uno operator {op} not implemented")


def eval_tres(op: int, a: int, b: int, c: int) -> int:
    if op == g.TRES_TERNCOND:
        return c if a == 0 else b
    raise WitnessCalcError(f"unknown tres op {op}")


def _populate(
    inputs: Dict[str, Sequence[object]],
    mapping: Dict[str, Tuple[int, int]],
    buffer: List[Optional[int]],
) -> None:
    for name, values in inputs.items():
        if name not in mapping:
            raise WitnessCalcError(f"missing input {name}")
        offset, length = mapping[name]
        if length != len(values):
            raise WitnessCalcError(
                f"invalid input length for {name}: expected {length}, got {len(values)}"
            )
        for i, v in enumerate(values):
            if v is not None:
                buffer[offset + i] = int(v)


def calc_witness(inputs: Dict[str, Sequence[int]], graph: g.Graph) -> List[int]:
    """Full witness evaluation (reference iden3calc.rs:20-60)."""
    size = g.inputs_size(graph.nodes)
    buffer: List[Optional[int]] = [0] * size
    buffer[0] = 1
    _populate(inputs, graph.input_mapping, buffer)

    values: List[int] = []
    for node in graph.nodes:
        if node.kind == g.K_CONST:
            values.append(node.const % R)
        elif node.kind == g.K_INPUT:
            v = buffer[node.a]
            if v >= R:
                raise WitnessCalcError("Failed to convert U256 to Fr")
            values.append(v)
        elif node.kind == g.K_UNO:
            values.append(eval_uno(node.op, values[node.a]))
        elif node.kind == g.K_DUO:
            values.append(eval_duo(node.op, values[node.a], values[node.b]))
        else:
            values.append(eval_tres(node.op, values[node.a], values[node.b], values[node.c]))
    out = [values[s] for s in graph.signals]
    # Zeroize the populated input buffer (identity-secret copies included)
    # once evaluation is done — reference iden3calc.rs:44-57 scrubs the same
    # buffer. Python ints are immutable so this drops references promptly
    # rather than overwriting memory; the bulk scrub-able copies live in the
    # device-path numpy buffers (witness_eval / prover.full_assignments).
    for i in range(len(buffer)):
        buffer[i] = 0
    return out


def calc_witness_partial(
    inputs: Dict[str, Sequence[Optional[int]]], graph: g.Graph
) -> List[Optional[int]]:
    """None-propagating partial evaluation (reference graph.rs:274-312)."""
    size = g.inputs_size(graph.nodes)
    buffer: List[Optional[int]] = [None] * size
    buffer[0] = 1
    _populate(inputs, graph.input_mapping, buffer)

    values: List[Optional[int]] = []
    for node in graph.nodes:
        if node.kind == g.K_CONST:
            values.append(node.const % R)
        elif node.kind == g.K_INPUT:
            v = buffer[node.a] if node.a < len(buffer) else None
            if v is not None and v >= R:
                raise WitnessCalcError("Failed to convert U256 to Fr")
            values.append(v)
        elif node.kind == g.K_UNO:
            va = values[node.a]
            values.append(None if va is None else eval_uno(node.op, va))
        elif node.kind == g.K_DUO:
            va, vb = values[node.a], values[node.b]
            values.append(None if va is None or vb is None else eval_duo(node.op, va, vb))
        else:
            va, vb, vc = values[node.a], values[node.b], values[node.c]
            values.append(
                None
                if va is None or vb is None or vc is None
                else eval_tres(node.op, va, vb, vc)
            )
    return [values[s] for s in graph.signals]
