"""The plain reference of zerokit's two-phase proof (rln/src/partial_proof.rs:
108-299), in Python integers, over the same circuit as reference/prover.py:

    partial (the wires known before the message: those calc_witness_partial
    gives when the message inputs are unknown):
        pi_a = alpha_1 + sum_known z_i A_i      rho  = beta_1 + sum_known z_i B1_i
        pi_b = beta_2  + sum_known z_i B2_i     pi_c = sum_known_aux z_i L_i
    finish (the rest, the witness map's h, the blinding):
        g_a  = pi_a + sum_unknown z_i A_i + r delta_1
        g1_b = rho  + sum_unknown z_i B1_i + s delta_1
        g2_b = pi_b + sum_unknown z_i B2_i + s delta_2
        g_c  = s g_a + r g1_b - r s delta_1 + pi_c + sum_unknown_aux z_i L_i
               + sum_j h_j H_j

The finish equals reference/prover.prove's proof at the same (r, s): the
sums over the known and the unknown wires are the whole MSMs. Nothing here
imports the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import msm as M
from .constants import R
from .prover import Circuit
from .qap import witness_map
from .witness import calc_witness_partial

# the inputs a partial witness leaves unknown (zerokit witness.rs:887-937)
MESSAGE_INPUTS = ("messageId", "selectorUsed", "x", "externalNullifier")


@dataclass
class Partial:
    mask: List[bool]  # over the whole assignment, wire 0 (the constant 1) known
    pi_a: object
    rho: object
    pi_b: object
    pi_c: object


def partial_assignment(circuit: Circuit, named_inputs: Dict[str, List[int]]) -> List[Optional[int]]:
    """The assignment of a witness as far as it is known before the message:
    None at every wire the message inputs reach."""
    named = {name: ([None] * len(vals) if name in MESSAGE_INPUTS else vals)
             for name, vals in named_inputs.items()}
    return calc_witness_partial(named, circuit.graph)


def _over(points: Sequence, z: Sequence[int], on: Sequence[bool], g2: bool = False):
    """sum_i z_i points_i over the positions where `on` holds."""
    return M.msm([p for p, k in zip(points, on) if k], [v for v, k in zip(z, on) if k], g2=g2)


def partial(circuit: Circuit, z_partial: Sequence[Optional[int]]) -> Partial:
    """The partial proof of an assignment whose unknown wires are None."""
    pk = circuit.zkey.pk
    mask = [v is not None for v in z_partial]
    z = [0 if v is None else v for v in z_partial]
    n = circuit.num_inputs
    return Partial(
        mask=mask,
        pi_a=M.sum_points([pk.vk.alpha_g1, _over(pk.a_query, z, mask)]),
        rho=M.sum_points([pk.beta_g1, _over(pk.b_g1_query, z, mask)]),
        pi_b=M.sum_points([pk.vk.beta_g2, _over(pk.b_g2_query, z, mask, g2=True)], g2=True),
        pi_c=_over(pk.l_query, z[n:], mask[n:]),
    )


def finish(circuit: Circuit, part: Partial, z: Sequence[int], r: int, s: int):
    """(g_a, g2_b, g_c) affine from the partial proof and the full
    assignment z at the blinding (r, s)."""
    pk = circuit.zkey.pk
    rest = [not k for k in part.mask]
    n = circuit.num_inputs
    h = witness_map(circuit.zkey.matrices, z)
    r, s = r % R, s % R
    g_a = M.sum_points([part.pi_a, _over(pk.a_query, z, rest), M.mul(pk.delta_g1, r)])
    g1_b = M.sum_points([part.rho, _over(pk.b_g1_query, z, rest), M.mul(pk.delta_g1, s)])
    g2_b = M.sum_points([part.pi_b, _over(pk.b_g2_query, z, rest, g2=True),
                         M.mul(pk.vk.delta_g2, s, g2=True)], g2=True)
    g_c = M.sum_points([
        M.mul(g_a, s), M.mul(g1_b, r), M.mul(pk.delta_g1, (-r * s) % R), part.pi_c,
        _over(pk.l_query, z[n:], rest[n:]), M.msm(pk.h_query, h),
    ])
    return (g_a, g2_b, g_c)
