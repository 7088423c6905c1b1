"""Witness graphs for checks and measurements, never built by the prover.

  * edge_case_graph: a seeded graph holding every op code the evaluator
    takes, with edge inputs. chip_smoke.py holds W1 and W2 against their
    plain versions on it, and tests/test_torch_witness_ops.py holds the
    plain evaluator against the JAX package's evaluator and the host
    interpreter on it.
  * chain_graph: one dependent chain of one op class, one node a level, so
    one W1 step a node: tools/microbench.measure_w1_steps times W1's step
    by op class on it.
"""

from __future__ import annotations

import numpy as np

from ..circuit import graph as gm
from ..circuit import witness_eval as we
from ..constants import R

# operands at the step semantics' edges: the signed split ((p-1)/2 and
# (p+1)/2), Shr's clamp (253, 254, 255, and shifts with bits above limb 0),
# p - 1 (whose Bor with 1 is exactly p), and the Div-by-zero divisor 0
EDGE_VALUES = (0, 1, R - 1, (R - 1) // 2, (R + 1) // 2, 253, 254, 255, 1 << 16,
               (1 << 16) + 1, 1 << 32, R - 2)
EDGE_CONSTS = (0, 1, R - 1, 254, 1 << 32)
_DUO_OPS = tuple(range(20))  # graph.OP_MUL .. OP_BXOR


def edge_case_graph(rng: np.random.Generator, lanes: int, n_inputs: int = 16):
    """(graph, input values (n_inputs, lanes) as ints) of a seeded graph that
    holds every op code the evaluator takes, in lean and rich segments and
    two Div groups. Level 1 applies each duo op the evaluator takes to every
    pair of a pool of inputs and constants, Neg to each and TernCond to
    seeded triples; lane 0's inputs are EDGE_VALUES (the rest random), lane
    1's the same reversed, other lanes' a seeded mix. Later levels combine
    computed values: Eq/Neq of equal products, Land/Lor/TernCond on
    computed zeros, seeded ops of each kind. Every node is a signal."""
    def fr():
        return int.from_bytes(rng.bytes(32), "little") % R

    edge = list(EDGE_VALUES)
    values = np.empty((n_inputs, lanes), dtype=object)
    for lane in range(lanes):
        col = edge + [fr() for _ in range(n_inputs - len(edge))]
        if lane == 1:
            col = col[::-1]
        elif lane > 1:
            col = [edge[int(rng.integers(len(edge)))] if rng.random() < 0.5 else fr()
                   for _ in range(n_inputs)]
        values[:, lane] = col[:n_inputs]

    nodes = [gm.Node(kind=gm.K_INPUT, a=1 + i) for i in range(n_inputs)]
    nodes += [gm.Node(kind=gm.K_CONST, const=v) for v in EDGE_CONSTS]
    pool = list(range(len(nodes)))
    levels = [pool]
    supported = [op for op in _DUO_OPS if op not in we._UNSUPPORTED]
    rich_ops = sorted(we._RICH_MAP)
    lean_ops = sorted(we._LEAN_MAP)

    def add(kind, op=0, a=0, b=0, c=0):
        nodes.append(gm.Node(kind=kind, op=op, a=a, b=b, c=c))
        return len(nodes) - 1

    def pick(ids):
        return int(ids[int(rng.integers(len(ids)))])

    # level 1: every supported duo op on every pair of the pool; Neg; TernCond
    lv1, muls = [], {}
    for op in supported:
        for i in pool:
            for j in pool:
                k = add(gm.K_DUO, op, i, j)
                lv1.append(k)
                if op == gm.OP_MUL:
                    muls[(i, j)] = k
    lv1 += [add(gm.K_UNO, gm.UNO_NEG, i) for i in pool]
    lv1 += [add(gm.K_TRES, gm.TRES_TERNCOND, i, pick(pool), pick(pool)) for i in pool]
    levels.append(lv1)
    subs = [k for k in lv1 if nodes[k].op == gm.OP_SUB and nodes[k].kind == gm.K_DUO
            and nodes[k].a == nodes[k].b]  # computed zeros
    earlier = pool + lv1

    def level(ops, count, extra=()):
        prev = levels[-1]
        out = list(extra)
        for _ in range(count):
            op = ops[int(rng.integers(len(ops)))]
            if op == "neg":
                out.append(add(gm.K_UNO, gm.UNO_NEG, pick(prev)))
            elif op == "tern":
                out.append(add(gm.K_TRES, gm.TRES_TERNCOND, pick(prev), pick(earlier),
                               pick(earlier)))
            else:
                out.append(add(gm.K_DUO, op, pick(prev), pick(earlier)))
        levels.append(out)
        earlier.extend(out)

    # level 2: computed values at the comparisons' edges, then seeded ops
    extra = []
    for (i, j), k in list(muls.items())[:: max(1, len(muls) // 24)]:
        extra.append(add(gm.K_DUO, gm.OP_EQ, k, muls[(j, i)]))
        extra.append(add(gm.K_DUO, gm.OP_NEQ, k, muls[(j, i)]))
    for z in subs[:8]:
        extra.append(add(gm.K_DUO, gm.OP_LAND, z, pick(lv1)))
        extra.append(add(gm.K_DUO, gm.OP_LOR, z, subs[0]))
        extra.append(add(gm.K_TRES, gm.TRES_TERNCOND, z, pick(lv1), pick(lv1)))
        extra.append(add(gm.K_DUO, gm.OP_GEQ, z, pick(lv1)))
    level(supported + ["neg", "tern"], 128, extra)
    level(lean_ops + ["neg", "tern"], 96)  # a lean segment
    level(rich_ops, 64)  # a rich one
    level([gm.OP_DIV] * 3 + lean_ops, 32)  # a second Div group
    level(lean_ops, 32)
    graph = gm.Graph(nodes=nodes, signals=list(range(len(nodes))),
                     input_mapping={"x": (1, n_inputs)}, tree_depth=0, max_out=1)
    return graph, values


CHAIN_KINDS = {  # op cycle of each chain_graph kind
    "mul": ("mul",), "mul_const": ("mul_const",), "add": ("add",),
    "mix": ("mul", "add", "mul_const", "sub"),
}
CHAIN_CONST = 0x2F0B3C5A6D7E8F90A1B2C3D4E5F60718293A4B5C6D7E8F90A1B2C3D4E5F6071


def chain_graph(kind: str, steps: int) -> gm.Graph:
    """A chain of `steps` dependent nodes on input x, one a level: Mul of
    the previous value by itself ("mul"), by a constant ("mul_const"), Add
    of it to itself ("add"), or the cycle Mul, Add, Mul by a constant, Sub
    of x ("mix"). The last node is the one signal."""
    nodes = [gm.Node(kind=gm.K_INPUT, a=1), gm.Node(kind=gm.K_CONST, const=CHAIN_CONST)]
    prev = 0
    cycle = CHAIN_KINDS[kind]
    for k in range(steps):
        op = cycle[k % len(cycle)]
        a, b, code = prev, prev, {"mul": gm.OP_MUL, "mul_const": gm.OP_MUL, "add": gm.OP_ADD,
                                  "sub": gm.OP_SUB}[op]
        if op == "mul_const":
            b = 1
        elif op == "sub":
            b = 0
        nodes.append(gm.Node(kind=gm.K_DUO, op=code, a=a, b=b))
        prev = len(nodes) - 1
    return gm.Graph(nodes=nodes, signals=[prev], input_mapping={"x": (1, 1)}, tree_depth=0,
                    max_out=1)
