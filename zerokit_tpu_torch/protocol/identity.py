"""Zeroizing identity-secret wrapper (reference: rln/src/utils.rs:440-545).

The reference wraps the identity secret in `IdSecret`, a zeroize-on-drop
newtype whose escape hatches (`to_u256`) carry explicit leak warnings.
Python cannot scrub immutable ints, so the secret is held in a mutable
bytearray that is overwritten on `zeroize()` (also called on GC). Arithmetic
interop (`%`, `int()`, equality) is provided so the secret can flow into the
witness pipeline, at which point — like the reference, which copies the
secret into the witness buffer and zeroizes the copies
(iden3calc.rs:44-57) — the value escapes the wrapper.
"""

from __future__ import annotations

import hmac
import secrets as _secrets

from ..constants import R

_FR_BYTES = 32


class IdSecret:
    """Identity secret held in a zeroizable buffer."""

    __slots__ = ("_buf",)

    def __init__(self, value: int):
        self._buf = bytearray(int(value % R).to_bytes(_FR_BYTES, "little"))

    # -- constructors (reference utils.rs IdSecret::rand / from_bytes) -------

    @classmethod
    def rand(cls) -> "IdSecret":
        return cls(_secrets.randbelow(R))

    @classmethod
    def from_bytes_le(cls, data: bytes) -> "IdSecret":
        v = int.from_bytes(data[:_FR_BYTES], "little")
        return cls(v)

    @classmethod
    def from_bytes_be(cls, data: bytes) -> "IdSecret":
        v = int.from_bytes(data[:_FR_BYTES], "big")
        return cls(v)

    # -- zeroization ----------------------------------------------------------

    def zeroize(self) -> None:
        for i in range(len(self._buf)):
            self._buf[i] = 0

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.zeroize()
        except Exception:
            pass

    # -- leaking accessors (reference to_u256: "leaks the secret") ------------

    def to_int(self) -> int:
        """LEAKS the secret into an unscrubbed Python int."""
        return int.from_bytes(bytes(self._buf), "little")

    def to_bytes_le(self) -> bytes:
        return bytes(self._buf)

    def to_bytes_be(self) -> bytes:
        return bytes(reversed(self._buf))

    # -- int interop ----------------------------------------------------------

    def __int__(self) -> int:
        return self.to_int()

    def __index__(self) -> int:
        return self.to_int()

    def __mod__(self, other) -> int:
        return self.to_int() % other

    def __eq__(self, other) -> bool:
        if isinstance(other, IdSecret):
            return hmac.compare_digest(bytes(self._buf), bytes(other._buf))
        if isinstance(other, int):
            return self.to_int() == other
        return NotImplemented

    def __hash__(self):
        return hash(self.to_int())

    def __repr__(self) -> str:  # never print the secret
        return "IdSecret(<hidden>)"
