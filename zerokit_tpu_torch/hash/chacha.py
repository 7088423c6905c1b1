"""ChaCha20 RNG + ark-compatible Fr sampling for deterministic keygen.

Reproduces rand_chacha's ChaCha20Rng stream (as used by the reference's
seeded keygen, rln/src/protocol/keygen.rs:50-92) and ark-ff's UniformRand
for Fr: sample 4 u64 limbs (low limb first, each from two LE u32 draws),
mask the top REPR_SHAVE_BITS = 2 bits, retry until below the modulus.

Verified against the hardcoded seeded-keygen vectors in
rln/tests/protocol.rs:461-507.
"""

from __future__ import annotations

import struct
from typing import List

from ..constants import R

_MASK32 = 0xFFFFFFFF


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def _quarter_round(s: List[int], a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 7)


class ChaCha20Rng:
    """rand_chacha-compatible: 64-bit block counter starting at 0, nonce 0."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.counter = 0
        self._buf: List[int] = []

    def _block(self) -> List[int]:
        state = (
            [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
            + self.key
            + [self.counter & _MASK32, (self.counter >> 32) & _MASK32, 0, 0]
        )
        work = list(state)
        for _ in range(10):
            _quarter_round(work, 0, 4, 8, 12)
            _quarter_round(work, 1, 5, 9, 13)
            _quarter_round(work, 2, 6, 10, 14)
            _quarter_round(work, 3, 7, 11, 15)
            _quarter_round(work, 0, 5, 10, 15)
            _quarter_round(work, 1, 6, 11, 12)
            _quarter_round(work, 2, 7, 8, 13)
            _quarter_round(work, 3, 4, 9, 14)
        out = [(w + s) & _MASK32 for w, s in zip(work, state)]
        self.counter += 1
        return out

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = self._block()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def ark_fr_rand(rng: ChaCha20Rng) -> int:
    """ark_ff UniformRand for BN254 Fr (rejection sampling, 2 shave bits).

    ark samples the raw *Montgomery representation* uniformly, so the field
    value is raw * 2^-256 mod r.
    """
    from ..constants import MONT_R

    shave_mask = (1 << 62) - 1  # u64::MAX >> 2
    while True:
        limbs = [rng.next_u64() for _ in range(4)]
        limbs[3] &= shave_mask
        raw = sum(l << (64 * i) for i, l in enumerate(limbs))
        if raw < R:
            return raw * pow(MONT_R, -1, R) % R
