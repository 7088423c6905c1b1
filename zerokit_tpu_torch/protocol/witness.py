"""RLN witness input types with validation (reference: rln/src/protocol/witness.rs).

One witness type shaped like the reference's V3 (`RLNWitnessInputV3`
Single/Multi), carrying the v2 validation rules (witness.rs:76-180 =
V3's 1015-1115: nonzero limit, path-length match, message_id < limit,
non-empty/unique active multi ids, >= 1 active selector).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .. import errors
from ..constants import R
from ..hash.poseidon import poseidon_hash, poseidon_hash_pair

MODE_SINGLE = 0x00  # wire version byte (reference mode.rs:88-95)
MODE_MULTI = 0x01


def _validate_common(user_message_limit, path_elements, identity_path_index):
    if user_message_limit % R == 0:
        raise errors.ZeroUserMessageLimit("user_message_limit must be nonzero")
    if len(path_elements) != len(identity_path_index):
        raise errors.InvalidMerkleProofLength(
            f"path_elements has {len(path_elements)} entries, "
            f"identity_path_index has {len(identity_path_index)}"
        )


def _secret_to_int(identity_secret) -> int:
    """Accepts a raw int or an IdSecret (reference FrOrSecret, utils.rs:440+).

    Converting to a Python int is the documented leak point (like the
    reference's IdSecret::to_u256); callers holding an IdSecret keep their
    zeroizable copy and may scrub the witness with .zeroize() after proving.
    """
    from .identity import IdSecret

    if isinstance(identity_secret, IdSecret):
        return identity_secret.to_int()
    return int(identity_secret)


@dataclass
class RLNWitnessInput:
    """Single- or multi-message-id witness. Use new_single / new_multi."""

    identity_secret: int
    user_message_limit: int
    path_elements: List[int]
    identity_path_index: List[int]
    x: int
    external_nullifier: int
    # single mode
    message_id: Optional[int] = None
    # multi mode
    message_ids: Optional[List[int]] = None
    selector_used: Optional[List[bool]] = None

    @property
    def is_single(self) -> bool:
        return self.message_id is not None

    def version_byte(self) -> int:
        return MODE_SINGLE if self.is_single else MODE_MULTI

    @property
    def max_out(self) -> int:
        return 1 if self.is_single else len(self.message_ids)

    def zeroize(self) -> None:
        """Best-effort scrub: drops the witness's secret reference. (Python
        ints are immutable; the scrubbable copies are the device-path numpy
        buffers, which the prover zeroizes — see prover.full_assignments.)"""
        object.__setattr__(self, "identity_secret", 0)

    @classmethod
    def new_single(
        cls,
        identity_secret,
        user_message_limit: int,
        message_id: int,
        path_elements: Sequence[int],
        identity_path_index: Sequence[int],
        x: int,
        external_nullifier: int,
    ) -> "RLNWitnessInput":
        identity_secret = _secret_to_int(identity_secret)
        _validate_common(user_message_limit, path_elements, identity_path_index)
        if message_id % R >= user_message_limit % R:
            raise errors.InvalidMessageId(
                f"message_id {message_id} >= limit {user_message_limit}"
            )
        return cls(
            identity_secret=identity_secret % R,
            user_message_limit=user_message_limit % R,
            path_elements=[p % R for p in path_elements],
            identity_path_index=[int(i) for i in identity_path_index],
            x=x % R,
            external_nullifier=external_nullifier % R,
            message_id=message_id % R,
        )

    @classmethod
    def new_multi(
        cls,
        identity_secret,
        user_message_limit: int,
        message_ids: Sequence[int],
        path_elements: Sequence[int],
        identity_path_index: Sequence[int],
        x: int,
        external_nullifier: int,
        selector_used: Sequence[bool],
    ) -> "RLNWitnessInput":
        identity_secret = _secret_to_int(identity_secret)
        _validate_common(user_message_limit, path_elements, identity_path_index)
        if len(message_ids) == 0:
            raise errors.EmptyMessageIds("message_ids must be non-empty")
        if len(selector_used) != len(message_ids):
            raise errors.FieldLengthMismatch(
                f"message_ids has {len(message_ids)}, selector_used has {len(selector_used)}"
            )
        if not any(selector_used):
            raise errors.NoActiveSelectorUsed("at least one selector must be active")
        seen = set()
        for mid, used in zip(message_ids, selector_used):
            if used and mid % R in seen:
                raise errors.DuplicateMessageIds(f"duplicate active message id {mid}")
            if used:
                seen.add(mid % R)
        for mid, used in zip(message_ids, selector_used):
            if used and mid % R >= user_message_limit % R:
                raise errors.InvalidMessageId(f"message_id {mid} >= limit")
        return cls(
            identity_secret=identity_secret % R,
            user_message_limit=user_message_limit % R,
            path_elements=[p % R for p in path_elements],
            identity_path_index=[int(i) for i in identity_path_index],
            x=x % R,
            external_nullifier=external_nullifier % R,
            message_ids=[m % R for m in message_ids],
            selector_used=[bool(s) for s in selector_used],
        )

    # -- witness-calculator inputs ------------------------------------------

    def named_inputs(self) -> Dict[str, List[int]]:
        """Inputs for the witness calculator (reference witness.rs:832-881)."""
        inputs = {
            "identitySecret": [self.identity_secret],
            "userMessageLimit": [self.user_message_limit],
        }
        if self.is_single:
            inputs["messageId"] = [self.message_id]
        else:
            inputs["messageId"] = list(self.message_ids)
            inputs["selectorUsed"] = [1 if s else 0 for s in self.selector_used]
        inputs["pathElements"] = list(self.path_elements)
        inputs["identityPathIndex"] = list(self.identity_path_index)
        inputs["x"] = [self.x]
        inputs["externalNullifier"] = [self.external_nullifier]
        return inputs

    def validate_against_graph(self, graph) -> None:
        """reference witness.rs:1118-1158."""
        if len(self.path_elements) != graph.tree_depth:
            raise errors.GenerateProofError(
                f"path_elements length {len(self.path_elements)} != depth {graph.tree_depth}"
            )
        if len(self.identity_path_index) != graph.tree_depth:
            raise errors.GenerateProofError(
                f"identity_path_index length != depth {graph.tree_depth}"
            )
        if self.is_single and graph.max_out != 1:
            raise errors.GenerateProofError(f"graph expects {graph.max_out} message ids")
        if not self.is_single:
            if len(self.message_ids) != graph.max_out:
                raise errors.GenerateProofError(
                    f"message_ids length {len(self.message_ids)} != max_out {graph.max_out}"
                )
            if len(self.selector_used) != graph.max_out:
                raise errors.GenerateProofError("selector_used length != max_out")


@dataclass
class RLNPartialWitnessInput:
    """Static witness part for two-phase proving (reference witness.rs:248-303)."""

    identity_secret: int
    user_message_limit: int
    path_elements: List[int]
    identity_path_index: List[int]

    @classmethod
    def new(
        cls,
        identity_secret,
        user_message_limit: int,
        path_elements: Sequence[int],
        identity_path_index: Sequence[int],
    ) -> "RLNPartialWitnessInput":
        identity_secret = _secret_to_int(identity_secret)
        _validate_common(user_message_limit, path_elements, identity_path_index)
        return cls(
            identity_secret=identity_secret % R,
            user_message_limit=user_message_limit % R,
            path_elements=[p % R for p in path_elements],
            identity_path_index=[int(i) for i in identity_path_index],
        )

    @classmethod
    def from_witness(cls, w: RLNWitnessInput) -> "RLNPartialWitnessInput":
        return cls(
            identity_secret=w.identity_secret,
            user_message_limit=w.user_message_limit,
            path_elements=list(w.path_elements),
            identity_path_index=list(w.identity_path_index),
        )

    def version_byte(self) -> int:
        return MODE_SINGLE

    def named_inputs_partial(self, max_out: int) -> Dict[str, List[Optional[int]]]:
        """Unknown dynamic fields are None (reference witness.rs:887-937)."""
        inputs: Dict[str, List[Optional[int]]] = {
            "identitySecret": [self.identity_secret],
            "userMessageLimit": [self.user_message_limit],
        }
        if max_out == 1:
            inputs["messageId"] = [None]
        else:
            inputs["messageId"] = [None] * max_out
            inputs["selectorUsed"] = [None] * max_out
        inputs["pathElements"] = list(self.path_elements)
        inputs["identityPathIndex"] = list(self.identity_path_index)
        inputs["x"] = [None]
        inputs["externalNullifier"] = [None]
        return inputs

    def validate_against_graph(self, graph) -> None:
        if len(self.path_elements) != graph.tree_depth:
            raise errors.GenerateProofError(
                f"path_elements length {len(self.path_elements)} != depth {graph.tree_depth}"
            )
        if len(self.identity_path_index) != graph.tree_depth:
            raise errors.GenerateProofError(
                f"identity_path_index length != depth {graph.tree_depth}"
            )


def compute_tree_root(
    identity_secret: int,
    user_message_limit: int,
    path_elements: Sequence[int],
    identity_path_index: Sequence[int],
) -> int:
    """reference witness.rs:807-828."""
    id_commitment = poseidon_hash([identity_secret])
    root = poseidon_hash_pair(id_commitment, user_message_limit)
    for bit, elem in zip(identity_path_index, path_elements):
        if bit == 0:
            root = poseidon_hash_pair(root, elem)
        else:
            root = poseidon_hash_pair(elem, root)
    return root
