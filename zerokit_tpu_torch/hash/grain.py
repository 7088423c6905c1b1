"""Grain-LFSR generation of Poseidon round constants and MDS matrices.

Behavioral parity with the reference's generator
(utils/src/poseidon/poseidon_constants.rs, itself derived from the Poseidon
paper's generate_parameters_grain.sage): an 80-bit Grain LFSR seeded from
(field tag, sbox tag, prime bits, t, RF, RP), round constants drawn by
rejection sampling, MDS built as the Cauchy matrix 1/(x_i + y_j) from
mod-p-sampled vectors, with `skip_matrices` discarded candidate matrices.

Verified against the hardcoded vectors in utils/tests/poseidon_constants.rs.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from ..constants import R


class GrainLFSR:
    def __init__(
        self,
        is_field: int,
        is_sbox_inverse: int,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        assert is_field == 1
        state = [False] * 80
        state[1] = is_field == 1
        state[5] = is_sbox_inverse == 1

        def fill(lo: int, hi: int, value: int):
            cur = value
            for i in range(hi, lo - 1, -1):
                state[i] = (cur & 1) == 1
                cur >>= 1

        fill(6, 17, prime_num_bits)
        fill(18, 29, state_len)
        fill(30, 39, num_full_rounds)
        fill(40, 49, num_partial_rounds)
        for i in range(50, 80):
            state[i] = True

        self.prime_num_bits = prime_num_bits
        self.state = state
        self.head = 0
        for _ in range(160):
            self._update()

    def _update(self) -> bool:
        s = self.state
        h = self.head
        new_bit = (
            s[(h + 62) % 80]
            ^ s[(h + 51) % 80]
            ^ s[(h + 38) % 80]
            ^ s[(h + 23) % 80]
            ^ s[(h + 13) % 80]
            ^ s[h]
        )
        s[h] = new_bit
        self.head = (h + 1) % 80
        return new_bit

    def get_bits(self, num_bits: int) -> List[bool]:
        res = []
        for _ in range(num_bits):
            new_bit = self._update()
            while not new_bit:
                self._update()  # discard the second bit
                new_bit = self._update()
            res.append(self._update())
        return res

    def _bits_to_int(self) -> int:
        bits = self.get_bits(self.prime_num_bits)
        bits.reverse()
        val = 0
        # pack 8-bit chunks LSB-first within each byte, bytes little-endian
        for byte_idx in range(0, len(bits), 8):
            chunk = bits[byte_idx : byte_idx + 8]
            b = 0
            for i, bit in enumerate(chunk):
                b |= int(bit) << i
            val |= b << (byte_idx)
        return val

    def field_elements_rejection_sampling(self, num: int, modulus: int) -> List[int]:
        res = []
        while len(res) < num:
            v = self._bits_to_int()
            if v < modulus:
                res.append(v)
        return res

    def field_elements_mod_p(self, num: int, modulus: int) -> List[int]:
        return [self._bits_to_int() % modulus for _ in range(num)]


@functools.lru_cache(maxsize=None)
def find_poseidon_ark_and_mds(
    prime_bits: int,
    t: int,
    full_rounds: int,
    partial_rounds: int,
    skip_matrices: int = 0,
    modulus: int = R,
) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """Returns (ark, mds): ark has (RF+RP)*t constants; mds is t x t."""
    lfsr = GrainLFSR(1, 0, prime_bits, t, full_rounds, partial_rounds)
    ark: List[int] = []
    for _ in range(full_rounds + partial_rounds):
        ark.extend(lfsr.field_elements_rejection_sampling(t, modulus))
    for _ in range(skip_matrices):
        lfsr.field_elements_mod_p(2 * t, modulus)
    xs = lfsr.field_elements_mod_p(t, modulus)
    ys = lfsr.field_elements_mod_p(t, modulus)
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % modulus, -1, modulus) for j in range(t)) for i in range(t)
    )
    return tuple(ark), mds
