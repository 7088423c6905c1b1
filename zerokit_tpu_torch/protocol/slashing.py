"""Identity-secret recovery from rate-limit violations
(reference: rln/src/protocol/slashing.rs).
"""

from __future__ import annotations

from .. import errors
from ..constants import R
from .proof import RLNProofValues


def compute_id_secret(share1, share2) -> int:
    """Recovers a0 from two (x, y) shares on the same line y = a0 + x*a1
    (reference slashing.rs:12-36)."""
    x1, y1 = share1
    x2, y2 = share2
    if (x1 - x2) % R == 0:
        raise errors.DivisionByZero("shares have equal x coordinates")
    a1 = (y1 - y2) * pow((x1 - x2) % R, -1, R) % R
    return (y1 - x1 * a1) % R


def recover_id_secret(v1: RLNProofValues, v2: RLNProofValues) -> int:
    """Same-mode convenience recovery (reference slashing.rs:43-100);
    `recover_secret` below also handles cross-mode pairs (proof.rs:1015-1143).
    """
    if v1.external_nullifier != v2.external_nullifier:
        raise errors.ExternalNullifierMismatch(
            f"{v1.external_nullifier} != {v2.external_nullifier}"
        )
    if v1.is_single and v2.is_single:
        return compute_id_secret((v1.x, v1.y), (v2.x, v2.y))
    if not v1.is_single and not v2.is_single:
        for i, (n_i, u_i) in enumerate(zip(v1.nullifiers, v1.selector_used)):
            if not u_i:
                continue
            for j, (n_j, u_j) in enumerate(zip(v2.nullifiers, v2.selector_used)):
                if not u_j:
                    continue
                if n_i == n_j:
                    return compute_id_secret((v1.x, v1.ys[i]), (v2.x, v2.ys[j]))
        raise errors.NoMatchingNullifier("no shared active nullifier")
    raise errors.NoMatchingNullifier("mixed-mode pairs: use recover_secret")


def recover_secret(v1: RLNProofValues, v2: RLNProofValues) -> int:
    """Full V3 semantics incl. cross-mode Single x Multi (proof.rs:969-1143)."""
    if v1.external_nullifier != v2.external_nullifier:
        raise errors.ExternalNullifierMismatch(
            f"{v1.external_nullifier} != {v2.external_nullifier}"
        )
    if v1.is_single and v2.is_single:
        if v1.nullifier != v2.nullifier:
            raise errors.NoMatchingNullifier("nullifiers differ")
        return compute_id_secret((v1.x, v1.y), (v2.x, v2.y))
    if not v1.is_single and not v2.is_single:
        return recover_id_secret(v1, v2)
    single, multi = (v1, v2) if v1.is_single else (v2, v1)
    for i, (n_i, u_i) in enumerate(zip(multi.nullifiers, multi.selector_used)):
        if u_i and n_i == single.nullifier:
            return compute_id_secret((multi.x, multi.ys[i]), (single.x, single.y))
    raise errors.NoMatchingNullifier("no shared active nullifier")
