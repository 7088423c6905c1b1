"""RLN proof values and proof container (reference: rln/src/protocol/proof.rs).

proof_values_from_witness reproduces witness.rs:759-828 / proof.rs:991-1079:
root recomputed along the Merkle path, Shamir share y = a0 + x*a1 with
a1 = H(a0, external_nullifier, message_id), nullifier = H(a1); multi mode
multiplies each slot by its selector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..constants import R
from ..hash.poseidon import poseidon_hash
from .witness import MODE_MULTI, MODE_SINGLE, RLNWitnessInput, compute_tree_root


@dataclass
class RLNProofValues:
    root: int
    x: int
    external_nullifier: int
    # single
    y: Optional[int] = None
    nullifier: Optional[int] = None
    # multi
    ys: Optional[List[int]] = None
    nullifiers: Optional[List[int]] = None
    selector_used: Optional[List[bool]] = None

    @property
    def is_single(self) -> bool:
        return self.y is not None

    def version_byte(self) -> int:
        return MODE_SINGLE if self.is_single else MODE_MULTI

    @classmethod
    def new_single(cls, root, x, external_nullifier, y, nullifier):
        return cls(
            root=root % R,
            x=x % R,
            external_nullifier=external_nullifier % R,
            y=y % R,
            nullifier=nullifier % R,
        )

    @classmethod
    def new_multi(cls, root, x, external_nullifier, ys, nullifiers, selector_used):
        return cls(
            root=root % R,
            x=x % R,
            external_nullifier=external_nullifier % R,
            ys=[v % R for v in ys],
            nullifiers=[v % R for v in nullifiers],
            selector_used=[bool(s) for s in selector_used],
        )


def proof_values_from_witness(witness: RLNWitnessInput) -> RLNProofValues:
    root = compute_tree_root(
        witness.identity_secret,
        witness.user_message_limit,
        witness.path_elements,
        witness.identity_path_index,
    )
    a0 = witness.identity_secret
    if witness.is_single:
        a1 = poseidon_hash([a0, witness.external_nullifier, witness.message_id])
        y = (a0 + witness.x * a1) % R
        nullifier = poseidon_hash([a1])
        return RLNProofValues.new_single(root, witness.x, witness.external_nullifier, y, nullifier)
    ys, nullifiers = [], []
    for mid, used in zip(witness.message_ids, witness.selector_used):
        a1 = poseidon_hash([a0, witness.external_nullifier, mid])
        sel = 1 if used else 0
        ys.append((a0 + witness.x * a1) * sel % R)
        nullifiers.append(poseidon_hash([a1]) * sel % R)
    return RLNProofValues.new_multi(
        root, witness.x, witness.external_nullifier, ys, nullifiers, witness.selector_used
    )


@dataclass
class RLNProof:
    """Groth16 proof + its public values (reference proof.rs:49-60)."""

    proof: tuple  # (a: G1 affine, b: G2 affine, c: G1 affine)
    proof_values: RLNProofValues

    def version_byte(self) -> int:
        return self.proof_values.version_byte()
