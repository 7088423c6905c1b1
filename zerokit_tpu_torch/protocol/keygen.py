"""RLN identity generation (reference: rln/src/protocol/keygen.rs).

  * keygen: random identity secret + Poseidon commitment
  * extended_keygen: Semaphore-compatible (trapdoor, nullifier, secret, commitment)
  * seeded variants: Keccak-256(seed) -> ChaCha20 -> ark-compatible Fr sampling
    (bit-exact with the reference; golden vectors rln/tests/protocol.rs:461-507)
  * hash_to_field_{le,be}: Keccak-256 into Fr (reference rln/src/hashers.rs:73-93)
"""

from __future__ import annotations

import secrets
from typing import Tuple

from ..constants import R
from ..hash.chacha import ChaCha20Rng, ark_fr_rand
from ..hash.keccak import keccak256
from ..hash.poseidon import poseidon_hash, poseidon_hash_pair
from .identity import IdSecret


def hash_to_field_le(signal: bytes) -> int:
    return int.from_bytes(keccak256(signal), "little") % R


def hash_to_field_be(signal: bytes) -> int:
    digest = bytearray(keccak256(signal))
    digest.reverse()
    return int.from_bytes(bytes(digest), "big") % R


def keygen() -> Tuple[IdSecret, int]:
    """(identity_secret, id_commitment = Poseidon(secret)); the secret is a
    zeroizing IdSecret (utils.rs:440-545)."""
    secret = secrets.randbelow(R)
    return IdSecret(secret), poseidon_hash([secret])


def extended_keygen() -> Tuple[int, int, IdSecret, int]:
    """(trapdoor, nullifier, secret = H(t, n), commitment = H(secret))."""
    trapdoor = secrets.randbelow(R)
    nullifier = secrets.randbelow(R)
    secret = poseidon_hash_pair(trapdoor, nullifier)
    return trapdoor, nullifier, IdSecret(secret), poseidon_hash([secret])


def seeded_keygen(signal: bytes) -> Tuple[IdSecret, int]:
    rng = ChaCha20Rng(keccak256(signal))
    secret = ark_fr_rand(rng)
    return IdSecret(secret), poseidon_hash([secret])


def extended_seeded_keygen(signal: bytes) -> Tuple[int, int, IdSecret, int]:
    rng = ChaCha20Rng(keccak256(signal))
    trapdoor = ark_fr_rand(rng)
    nullifier = ark_fr_rand(rng)
    secret = poseidon_hash_pair(trapdoor, nullifier)
    return trapdoor, nullifier, IdSecret(secret), poseidon_hash([secret])
