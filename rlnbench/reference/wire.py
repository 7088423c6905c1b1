"""zerokit's v2 little-endian wire formats, as far as the benchmark speaks
them: the witness a client sends to POST /prove, and the proof it gets back
(reference rln/src/protocol/witness.rs, proof.rs; ark compressed points).

    witness  version byte, identity secret, user message limit, then for a
             single message id: message id, Vec<Fr> path, Vec<u8> index
             bits, x, external nullifier; for several: Vec<Fr> path,
             Vec<u8> index bits, x, external nullifier, Vec<Fr> message
             ids, Vec<bool> selectors
    proof    version byte, 128-byte compressed Groth16 proof, then the
             values: version byte, root, external nullifier, x, and y,
             nullifier (single) or Vec<Fr> ys, Vec<Fr> nullifiers,
             Vec<bool> selectors
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .arkserde import proof_from_bytes, proof_to_bytes
from .constants import R


def _fr(v: int) -> bytes:
    return int(v % R).to_bytes(32, "little")


def _vec(items: List[bytes]) -> bytes:
    return struct.pack("<Q", len(items)) + b"".join(items)


def witness_to_bytes(w: Dict) -> bytes:
    single = "message_id" in w
    out = bytes([0 if single else 1]) + _fr(w["identity_secret"]) + _fr(w["user_message_limit"])
    path = _vec([_fr(p) for p in w["path_elements"]])
    bits = _vec([bytes([b]) for b in w["identity_path_index"]])
    tail = _fr(w["x"]) + _fr(w["external_nullifier"])
    if single:
        return out + _fr(w["message_id"]) + path + bits + tail
    return (out + path + bits + tail + _vec([_fr(m) for m in w["message_ids"]])
            + _vec([bytes([1 if u else 0]) for u in w["selector_used"]]))


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("proof bytes end early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def fr(self) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= R:
            raise ValueError("non-canonical field element")
        return v

    def count(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def proof_from_wire(data: bytes) -> Tuple[tuple, Dict]:
    """(proof (a, b, c) affine, values) of a v2 proof; values holds root,
    external_nullifier, x and y, nullifier or ys, nullifiers,
    selector_used."""
    rd = _Reader(data)
    version = rd.take(1)[0]
    proof = proof_from_bytes(rd.take(128))
    if rd.take(1)[0] != version:
        raise ValueError("proof and values disagree on the version byte")
    values = {"root": rd.fr(), "external_nullifier": rd.fr(), "x": rd.fr()}
    if version == 0:
        values["y"] = rd.fr()
        values["nullifier"] = rd.fr()
    else:
        values["ys"] = [rd.fr() for _ in range(rd.count())]
        values["nullifiers"] = [rd.fr() for _ in range(rd.count())]
        values["selector_used"] = [b != 0 for b in rd.take(rd.count())]
    if rd.pos != len(data):
        raise ValueError("trailing proof bytes")
    return proof, values


def proof_to_wire(proof, values: Dict) -> bytes:
    """The v2 bytes of a proof and its values (the control's replies)."""
    single = "y" in values
    v = bytes([0 if single else 1]) + _fr(values["root"]) + _fr(values["external_nullifier"])
    v += _fr(values["x"])
    if single:
        v += _fr(values["y"]) + _fr(values["nullifier"])
    else:
        v += _vec([_fr(y) for y in values["ys"]]) + _vec([_fr(n) for n in values["nullifiers"]])
        v += _vec([bytes([1 if u else 0]) for u in values["selector_used"]])
    return v[:1] + proof_to_bytes(proof) + v


def public_inputs(values: Dict, order: List[str]) -> List[int]:
    """The circuit's public inputs from proof values, in the order the
    configuration names them (lists flattened, selectors as 0 / 1)."""
    out: List[int] = []
    for name in order:
        v = values[name]
        for item in (v if isinstance(v, list) else [v]):
            out.append(int(item) % R)
    return out


def values_from_public(public: List[int], order: List[str], max_out) -> Dict:
    """Proof values by name from the circuit's public inputs in order (the
    inverse of public_inputs)."""
    out, i = {}, 0
    for name in order:
        if name in ("ys", "nullifiers", "selector_used"):
            out[name] = list(public[i:i + max_out])
            i += max_out
        else:
            out[name] = public[i]
            i += 1
    if "selector_used" in out:
        out["selector_used"] = [bool(u) for u in out["selector_used"]]
    return out
