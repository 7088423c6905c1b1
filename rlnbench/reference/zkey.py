"""arkzkey (.arkzkey) proving-key loader.

File layout matches the reference's `read_arkzkey_from_bytes_uncompressed`
(rln/src/circuit/mod.rs:256-305): an ark-serialize *uncompressed, unchecked*
dump of

    SerializableProvingKey(ProvingKey<Bn254>)
    SerializableConstraintMatrices<Fr> {
        num_instance_variables: u64, num_witness_variables: u64,
        num_constraints: u64, a/b/c_num_non_zero: u64,
        a, b, c: Vec<Vec<(Fr, u64)>>,
    }

ProvingKey field order (ark-groth16 data_structures):
    vk { alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1: Vec<G1> },
    beta_g1, delta_g1,
    a_query: Vec<G1>, b_g1_query: Vec<G1>, b_g2_query: Vec<G2>,
    h_query: Vec<G1>, l_query: Vec<G1>.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .arkserde import ArkReader

SparseRow = List[Tuple[int, int]]  # [(coefficient, wire_index), ...]


@dataclass
class VerifyingKey:
    alpha_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_abc_g1: List[object]


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: object
    delta_g1: object
    a_query: List[object]
    b_g1_query: List[object]
    b_g2_query: List[object]
    h_query: List[object]
    l_query: List[object]


@dataclass
class ConstraintMatrices:
    num_instance_variables: int
    num_witness_variables: int
    num_constraints: int
    a_num_non_zero: int
    b_num_non_zero: int
    c_num_non_zero: int
    a: List[SparseRow]
    b: List[SparseRow]
    c: List[SparseRow]


@dataclass
class Zkey:
    pk: ProvingKey
    matrices: ConstraintMatrices


class ZkeyError(ValueError):
    pass


def zkey_from_bytes(data: bytes) -> Zkey:
    """Parses an arkzkey byte blob (reference: zkey_from_raw, circuit/mod.rs:140)."""
    if not data:
        raise ZkeyError("empty zkey bytes")
    r = ArkReader(data)
    vk = VerifyingKey(
        alpha_g1=r.g1(),
        beta_g2=r.g2(),
        gamma_g2=r.g2(),
        delta_g2=r.g2(),
        gamma_abc_g1=r.vec(r.g1),
    )
    pk = ProvingKey(
        vk=vk,
        beta_g1=r.g1(),
        delta_g1=r.g1(),
        a_query=r.vec(r.g1),
        b_g1_query=r.vec(r.g1),
        b_g2_query=r.vec(r.g2),
        h_query=r.vec(r.g1),
        l_query=r.vec(r.g1),
    )

    def pair():
        coeff = r.fr()
        index = r.u64()
        return (coeff, index)

    def row():
        return r.vec(pair)

    num_instance = r.u64()
    num_witness = r.u64()
    num_constraints = r.u64()
    a_nnz = r.u64()
    b_nnz = r.u64()
    c_nnz = r.u64()
    a = r.vec(row)
    b = r.vec(row)
    c = r.vec(row)
    if not r.done():
        raise ZkeyError(f"trailing bytes in zkey: {len(data) - r.pos}")
    matrices = ConstraintMatrices(
        num_instance_variables=num_instance,
        num_witness_variables=num_witness,
        num_constraints=num_constraints,
        a_num_non_zero=a_nnz,
        b_num_non_zero=b_nnz,
        c_num_non_zero=c_nnz,
        a=a,
        b=b,
        c=c,
    )
    return Zkey(pk=pk, matrices=matrices)


def zkey_from_file(path: str) -> Zkey:
    with open(path, "rb") as f:
        return zkey_from_bytes(f.read())
