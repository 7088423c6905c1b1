"""ark-serialize compatible byte codecs for BN254 field elements and points.

Wire behavior mirrors arkworks' CanonicalSerialize for short-Weierstrass
curves (the reference consumes these through ark-serialize; e.g. proof
(de)serialization at rln/src/protocol/proof.rs:424,469 and the arkzkey loader
at rln/src/circuit/mod.rs:277-305):

  * Fp: 32-byte little-endian canonical integer.
  * G1 uncompressed:  x || y, 64 bytes; infinity flag (0b01 << 6) in the top
    bits of the last byte of y.
  * G1 compressed: x, 32 bytes; 2-bit SW flags in the top bits of the last
    byte (infinity = 0b01 << 6, y-is-negative = 0b10 << 6, positive = 0).
  * G2: same with Fq2 coordinates serialized c0 || c1, flags on c1's last byte.
  * "negative" means y > -y in the canonical integer ordering; Fq2 ordering is
    lexicographic on (c1, c0).
  * Vec<T>: u64 LE length prefix then items. usize: u64 LE.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .constants import B_G2, Q
from . import bn254

FLAG_INFINITY = 1 << 6
FLAG_Y_NEG = 1 << 7
FLAG_MASK = 0b11 << 6


# -- field elements ---------------------------------------------------------


def fq_to_bytes(a: int) -> bytes:
    return int(a % Q).to_bytes(32, "little")


def fq_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


# -- sign / sqrt helpers ----------------------------------------------------


def _fq_is_neg(y: int) -> bool:
    # ark: YIsNegative iff y > -y in canonical ordering
    return y > (Q - y) % Q


def _fq2_is_neg(y: Tuple[int, int]) -> bool:
    # Fq2 ordering: lexicographic on (c1, c0)
    ny = bn254.fq2_neg(y)
    return (y[1], y[0]) > (ny[1], ny[0])


_SQRT_EXP = (Q + 1) // 4  # valid since Q % 4 == 3


def fq_sqrt(a: int) -> Optional[int]:
    a %= Q
    r = pow(a, _SQRT_EXP, Q)
    if r * r % Q == a:
        return r
    return None


def fq2_sqrt(a: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    a0, a1 = a[0] % Q, a[1] % Q
    if a1 == 0:
        r = fq_sqrt(a0)
        if r is not None:
            return (r, 0)
        # sqrt(-a0) * u since u^2 = -1
        r = fq_sqrt((-a0) % Q)
        if r is None:
            return None
        return (0, r)
    norm = (a0 * a0 + a1 * a1) % Q
    s = fq_sqrt(norm)
    if s is None:
        return None
    two_inv = pow(2, -1, Q)
    x2 = (a0 + s) * two_inv % Q
    x = fq_sqrt(x2)
    if x is None:
        x2 = (a0 - s) * two_inv % Q
        x = fq_sqrt(x2)
        if x is None:
            return None
    y = a1 * pow(2 * x % Q, -1, Q) % Q
    cand = (x, y)
    if bn254.fq2_sqr(cand) != (a0, a1):
        return None
    return cand


# -- G1 ---------------------------------------------------------------------


def g1_to_uncompressed(p) -> bytes:
    if p is None:
        return b"\x00" * 63 + bytes([FLAG_INFINITY])
    x, y = p
    yb = bytearray(fq_to_bytes(y))
    if _fq_is_neg(y):
        yb[-1] |= FLAG_Y_NEG
    return fq_to_bytes(x) + bytes(yb)


def g1_from_uncompressed(b: bytes):
    assert len(b) == 64
    flags = b[63] & FLAG_MASK
    yb = bytearray(b[32:64])
    yb[-1] &= ~FLAG_MASK & 0xFF
    if flags & FLAG_INFINITY:
        return None
    x = fq_from_bytes(b[0:32])
    y = fq_from_bytes(bytes(yb))
    return (x, y)


def g1_to_compressed(p) -> bytes:
    if p is None:
        return b"\x00" * 31 + bytes([FLAG_INFINITY])
    x, y = p
    xb = bytearray(fq_to_bytes(x))
    if _fq_is_neg(y):
        xb[-1] |= FLAG_Y_NEG
    return bytes(xb)


def g1_from_compressed(b: bytes):
    assert len(b) == 32
    flags = b[31] & FLAG_MASK
    xb = bytearray(b)
    xb[-1] &= ~FLAG_MASK & 0xFF
    if flags & FLAG_INFINITY:
        return None
    x = fq_from_bytes(bytes(xb))
    y = fq_sqrt((x * x % Q * x + 3) % Q)
    if y is None:
        raise ValueError("invalid G1 compressed point: no square root")
    if bool(flags & FLAG_Y_NEG) != _fq_is_neg(y):
        y = (Q - y) % Q
    return (x, y)


# -- G2 ---------------------------------------------------------------------


def fq2_to_bytes(a: Tuple[int, int]) -> bytes:
    return fq_to_bytes(a[0]) + fq_to_bytes(a[1])


def fq2_from_bytes(b: bytes) -> Tuple[int, int]:
    return (fq_from_bytes(b[0:32]), fq_from_bytes(b[32:64]))


def g2_to_uncompressed(p) -> bytes:
    if p is None:
        return b"\x00" * 127 + bytes([FLAG_INFINITY])
    x, y = p
    yb = bytearray(fq2_to_bytes(y))
    if _fq2_is_neg(y):
        yb[-1] |= FLAG_Y_NEG
    return fq2_to_bytes(x) + bytes(yb)


def g2_from_uncompressed(b: bytes):
    assert len(b) == 128
    flags = b[127] & FLAG_MASK
    yb = bytearray(b[64:128])
    yb[-1] &= ~FLAG_MASK & 0xFF
    if flags & FLAG_INFINITY:
        return None
    x = fq2_from_bytes(b[0:64])
    y = fq2_from_bytes(bytes(yb))
    return (x, y)


def g2_to_compressed(p) -> bytes:
    if p is None:
        return b"\x00" * 63 + bytes([FLAG_INFINITY])
    x, y = p
    xb = bytearray(fq2_to_bytes(x))
    if _fq2_is_neg(y):
        xb[-1] |= FLAG_Y_NEG
    return bytes(xb)


def g2_from_compressed(b: bytes):
    assert len(b) == 64
    flags = b[63] & FLAG_MASK
    xb = bytearray(b)
    xb[-1] &= ~FLAG_MASK & 0xFF
    if flags & FLAG_INFINITY:
        return None
    x = fq2_from_bytes(bytes(xb))
    rhs = bn254.fq2_add(bn254.fq2_mul(bn254.fq2_sqr(x), x), B_G2)
    y = fq2_sqrt(rhs)
    if y is None:
        raise ValueError("invalid G2 compressed point: no square root")
    if bool(flags & FLAG_Y_NEG) != _fq2_is_neg(y):
        y = bn254.fq2_neg(y)
    return (x, y)


# -- Groth16 proof (compressed, 128 bytes; rln/src/circuit/mod.rs:82) -------


def proof_to_bytes(proof) -> bytes:
    """proof = (a: G1, b: G2, c: G1) -> 128-byte ark compressed encoding."""
    a, b, c = proof
    return g1_to_compressed(a) + g2_to_compressed(b) + g1_to_compressed(c)


def proof_from_bytes(data: bytes):
    if len(data) < 128:
        raise ValueError(f"proof needs 128 bytes, got {len(data)}")
    a = g1_from_compressed(data[0:32])
    b = g2_from_compressed(data[32:96])
    c = g1_from_compressed(data[96:128])
    return (a, b, c)


# -- stream reader for ark uncompressed structures --------------------------


class ArkReader:
    """Sequential reader over ark-serialize uncompressed bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("unexpected end of ark-serialized data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def fr(self) -> int:
        return int.from_bytes(self._take(32), "little")

    def g1(self):
        return g1_from_uncompressed(self._take(64))

    def g2(self):
        return g2_from_uncompressed(self._take(128))

    def vec(self, item_fn) -> List:
        n = self.u64()
        return [item_fn() for _ in range(n)]

    def done(self) -> bool:
        return self.pos == len(self.data)
