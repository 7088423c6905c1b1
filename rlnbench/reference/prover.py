"""The plain reference of one RLN proof: witness, witness map, the five
MSMs and the blinding, in Python integers (ark-groth16
create_proof_with_reduction_and_matrices with CircomReduction):

    g_a  = alpha_1 + sum_i z_i A_i + r delta_1
    g1_b = beta_1 + sum_i z_i B1_i + s delta_1
    g2_b = beta_2 + sum_i z_i B2_i + s delta_2
    g_c  = s g_a + r g1_b - r s delta_1 + sum_aux z_i L_i + sum_j h_j H_j

It reads the circuit's artifacts itself (frozen copies of the arkzkey and
graph readers and of the host witness interpreter) and takes nothing from
the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import msm as M
from .constants import R
from .graph import graph_from_bytes
from .qap import witness_map
from .witness import calc_witness
from .zkey import zkey_from_bytes

# the control: every MSM scalar cut to its low 248 bits (the top byte gone)
CONTROL_MASK = (1 << 248) - 1


@dataclass
class Circuit:
    zkey: object
    graph: object

    @property
    def num_inputs(self) -> int:
        return self.zkey.matrices.num_instance_variables


def load_circuit(zkey_path: str, graph_path: str, tree_depth: int,
                 max_out: Optional[int]) -> Circuit:
    with open(zkey_path, "rb") as f:
        zkey = zkey_from_bytes(f.read())
    with open(graph_path, "rb") as f:
        graph = graph_from_bytes(f.read(), tree_depth, max_out)
    return Circuit(zkey, graph)


def assignment(circuit: Circuit, named_inputs: Dict[str, List[int]]) -> List[int]:
    """The full assignment [1, public inputs..., the rest] of one witness."""
    return calc_witness(named_inputs, circuit.graph)


def public_inputs(circuit: Circuit, z: Sequence[int]) -> List[int]:
    return list(z[1:circuit.num_inputs])


def prove(circuit: Circuit, z: Sequence[int], r: int, s: int,
          scalar_mask: Optional[int] = None):
    """(g_a, g2_b, g_c) affine, for the assignment z and the blinding (r, s)."""
    pk = circuit.zkey.pk
    h = witness_map(circuit.zkey.matrices, z)
    aux = z[circuit.num_inputs:]
    kw = {"scalar_mask": scalar_mask}
    a = M.msm(pk.a_query, z, **kw)
    b1 = M.msm(pk.b_g1_query, z, **kw)
    b2 = M.msm(pk.b_g2_query, z, g2=True, **kw)
    l_acc = M.msm(pk.l_query, aux, **kw)
    h_acc = M.msm(pk.h_query, h, **kw)
    r, s = r % R, s % R
    g_a = M.sum_points([pk.vk.alpha_g1, a, M.mul(pk.delta_g1, r)])
    g1_b = M.sum_points([pk.beta_g1, b1, M.mul(pk.delta_g1, s)])
    g2_b = M.sum_points([pk.vk.beta_g2, b2, M.mul(pk.vk.delta_g2, s, g2=True)], g2=True)
    g_c = M.sum_points([
        M.mul(g_a, s), M.mul(g1_b, r), M.mul(pk.delta_g1, (-r * s) % R), l_acc, h_acc,
    ])
    return (g_a, g2_b, g_c)
