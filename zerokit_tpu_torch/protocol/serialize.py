"""Byte-exact wire formats for RLN protocol types.

Implements BOTH serialization generations of the reference:

  * v2 function-style codecs with a leading version byte (0x00 Single /
    0x01 Multi) and mode-dependent layouts — reference
    rln/src/protocol/{witness,proof}.rs with primitives from rln/src/utils.rs
    (LE and BE variants; lengths are 8-byte prefixes; Fr is canonical 32-byte).
  * V3 enum codecs with a 1-byte enum tag and ark-serialize-style struct
    bodies — reference rln/src/protocol/serialize.rs (LE via arkworks derive,
    BE hand-written; bools are strictly 0/1 in V3).

Proofs serialize as the 128-byte ark compressed Groth16 encoding (always LE)
followed by proof values in the requested endianness ("mixed-endian" BE mode,
serialize.rs:672-714). Partial proofs follow partial_proof.rs's ark derive:
mask Vec<bool> + 3 G1 + 1 G2 compressed.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from .. import errors
from ..constants import COMPRESS_PROOF_SIZE, FR_BYTE_SIZE, R, VEC_LEN_BYTE_SIZE
from ..hostmath import arkserde
from .proof import RLNProof, RLNProofValues
from .witness import MODE_MULTI, MODE_SINGLE, RLNPartialWitnessInput, RLNWitnessInput

# ---------------------------------------------------------------------------
# primitives (reference rln/src/utils.rs)
# ---------------------------------------------------------------------------


def fr_to_bytes(v: int, be: bool) -> bytes:
    return int(v % R).to_bytes(FR_BYTE_SIZE, "big" if be else "little")


def bytes_to_fr(data: bytes, be: bool) -> Tuple[int, int]:
    if len(data) < FR_BYTE_SIZE:
        raise errors.InsufficientData(FR_BYTE_SIZE, len(data))
    v = int.from_bytes(data[:FR_BYTE_SIZE], "big" if be else "little")
    if v >= R:
        raise errors.NonCanonicalFieldElement(hex(v))
    return v, FR_BYTE_SIZE


def _len_prefix(n: int, be: bool) -> bytes:
    return struct.pack(">Q" if be else "<Q", n)


def _read_len(data: bytes, be: bool) -> Tuple[int, int]:
    if len(data) < VEC_LEN_BYTE_SIZE:
        raise errors.InsufficientData(VEC_LEN_BYTE_SIZE, len(data))
    (n,) = struct.unpack(">Q" if be else "<Q", data[:VEC_LEN_BYTE_SIZE])
    return n, VEC_LEN_BYTE_SIZE


def vec_fr_to_bytes(vals, be: bool) -> bytes:
    return _len_prefix(len(vals), be) + b"".join(fr_to_bytes(v, be) for v in vals)


def bytes_to_vec_fr(data: bytes, be: bool) -> Tuple[List[int], int]:
    n, read = _read_len(data, be)
    if n > (len(data) - read) // FR_BYTE_SIZE:
        raise errors.InsufficientData(read + n * FR_BYTE_SIZE, len(data))
    out = []
    for _ in range(n):
        v, sz = bytes_to_fr(data[read:], be)
        out.append(v)
        read += sz
    return out, read


def vec_u8_to_bytes(vals, be: bool) -> bytes:
    return _len_prefix(len(vals), be) + bytes(vals)


def bytes_to_vec_u8(data: bytes, be: bool) -> Tuple[List[int], int]:
    n, read = _read_len(data, be)
    if n > len(data) - read:
        raise errors.InsufficientData(read + n, len(data))
    return list(data[read : read + n]), read + n


def vec_bool_to_bytes(vals, be: bool) -> bytes:
    return _len_prefix(len(vals), be) + bytes(1 if v else 0 for v in vals)


def bytes_to_vec_bool(data: bytes, be: bool, strict: bool = False) -> Tuple[List[bool], int]:
    n, read = _read_len(data, be)
    if n > len(data) - read:
        raise errors.InsufficientData(read + n, len(data))
    raw = data[read : read + n]
    if strict:
        for b in raw:
            if b not in (0, 1):
                raise errors.NonCanonicalBool(f"bool byte {b}")
    return [b != 0 for b in raw], read + n


def _check_fully_read(read: int, total: int) -> None:
    if read != total:
        raise errors.InvalidReadLen(read, total)


def _mode_from_byte(b: int) -> int:
    if b not in (MODE_SINGLE, MODE_MULTI):
        raise errors.UnknownVersionByte(f"version byte {b:#x}")
    return b


# ---------------------------------------------------------------------------
# v2 witness codecs (reference witness.rs:369-628; layouts mode.rs:28-43)
# ---------------------------------------------------------------------------


def rln_witness_to_bytes(w: RLNWitnessInput, be: bool = False) -> bytes:
    out = bytes([w.version_byte()])
    out += fr_to_bytes(w.identity_secret, be)
    out += fr_to_bytes(w.user_message_limit, be)
    if w.is_single:
        out += fr_to_bytes(w.message_id, be)
        out += vec_fr_to_bytes(w.path_elements, be)
        out += vec_u8_to_bytes(w.identity_path_index, be)
        out += fr_to_bytes(w.x, be)
        out += fr_to_bytes(w.external_nullifier, be)
    else:
        out += vec_fr_to_bytes(w.path_elements, be)
        out += vec_u8_to_bytes(w.identity_path_index, be)
        out += fr_to_bytes(w.x, be)
        out += fr_to_bytes(w.external_nullifier, be)
        out += vec_fr_to_bytes(w.message_ids, be)
        out += vec_bool_to_bytes(w.selector_used, be)
    return out


def bytes_to_rln_witness(data: bytes, be: bool = False) -> Tuple[RLNWitnessInput, int]:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    mode = _mode_from_byte(data[0])
    read = 1
    secret, sz = bytes_to_fr(data[read:], be)
    read += sz
    limit, sz = bytes_to_fr(data[read:], be)
    read += sz
    if mode == MODE_SINGLE:
        message_id, sz = bytes_to_fr(data[read:], be)
        read += sz
        path, sz = bytes_to_vec_fr(data[read:], be)
        read += sz
        idx, sz = bytes_to_vec_u8(data[read:], be)
        read += sz
        x, sz = bytes_to_fr(data[read:], be)
        read += sz
        ext, sz = bytes_to_fr(data[read:], be)
        read += sz
        _check_fully_read(read, len(data))
        return (
            RLNWitnessInput.new_single(secret, limit, message_id, path, idx, x, ext),
            read,
        )
    path, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    idx, sz = bytes_to_vec_u8(data[read:], be)
    read += sz
    x, sz = bytes_to_fr(data[read:], be)
    read += sz
    ext, sz = bytes_to_fr(data[read:], be)
    read += sz
    mids, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    sels, sz = bytes_to_vec_bool(data[read:], be)
    read += sz
    if len(sels) != len(mids):
        raise errors.FieldLengthMismatch(
            f"message_ids has {len(mids)}, selector_used has {len(sels)}"
        )
    _check_fully_read(read, len(data))
    return (
        RLNWitnessInput.new_multi(secret, limit, mids, path, idx, x, ext, sels),
        read,
    )


def rln_partial_witness_to_bytes(w: RLNPartialWitnessInput, be: bool = False) -> bytes:
    out = bytes([w.version_byte()])
    out += fr_to_bytes(w.identity_secret, be)
    out += fr_to_bytes(w.user_message_limit, be)
    out += vec_fr_to_bytes(w.path_elements, be)
    out += vec_u8_to_bytes(w.identity_path_index, be)
    return out


def bytes_to_rln_partial_witness(
    data: bytes, be: bool = False
) -> Tuple[RLNPartialWitnessInput, int]:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    _mode_from_byte(data[0])
    read = 1
    secret, sz = bytes_to_fr(data[read:], be)
    read += sz
    limit, sz = bytes_to_fr(data[read:], be)
    read += sz
    path, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    idx, sz = bytes_to_vec_u8(data[read:], be)
    read += sz
    _check_fully_read(read, len(data))
    return RLNPartialWitnessInput.new(secret, limit, path, idx), read


# ---------------------------------------------------------------------------
# v2 proof values codecs (reference proof.rs:192-407; layout mode.rs:45-50)
# v2 order: root, external_nullifier, x, then mode outputs
# ---------------------------------------------------------------------------


def rln_proof_values_to_bytes(v: RLNProofValues, be: bool = False) -> bytes:
    out = bytes([v.version_byte()])
    out += fr_to_bytes(v.root, be)
    out += fr_to_bytes(v.external_nullifier, be)
    out += fr_to_bytes(v.x, be)
    if v.is_single:
        out += fr_to_bytes(v.y, be)
        out += fr_to_bytes(v.nullifier, be)
    else:
        out += vec_fr_to_bytes(v.ys, be)
        out += vec_fr_to_bytes(v.nullifiers, be)
        out += vec_bool_to_bytes(v.selector_used, be)
    return out


def bytes_to_rln_proof_values(data: bytes, be: bool = False) -> Tuple[RLNProofValues, int]:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    mode = _mode_from_byte(data[0])
    read = 1
    root, sz = bytes_to_fr(data[read:], be)
    read += sz
    ext, sz = bytes_to_fr(data[read:], be)
    read += sz
    x, sz = bytes_to_fr(data[read:], be)
    read += sz
    if mode == MODE_SINGLE:
        y, sz = bytes_to_fr(data[read:], be)
        read += sz
        nullifier, sz = bytes_to_fr(data[read:], be)
        read += sz
        _check_fully_read(read, len(data))
        return RLNProofValues.new_single(root, x, ext, y, nullifier), read
    ys, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    nullifiers, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    sels, sz = bytes_to_vec_bool(data[read:], be)
    read += sz
    if len(sels) != len(ys):
        raise errors.FieldLengthMismatch(f"ys {len(ys)} vs selector_used {len(sels)}")
    if len(nullifiers) != len(ys):
        raise errors.FieldLengthMismatch(f"ys {len(ys)} vs nullifiers {len(nullifiers)}")
    _check_fully_read(read, len(data))
    return RLNProofValues.new_multi(root, x, ext, ys, nullifiers, sels), read


# ---------------------------------------------------------------------------
# proof codecs (reference proof.rs:409-525): version byte + 128-byte
# compressed Groth16 (always LE) + proof values
# ---------------------------------------------------------------------------


def rln_proof_to_bytes(p: RLNProof, be: bool = False) -> bytes:
    return (
        bytes([p.version_byte()])
        + arkserde.proof_to_bytes(p.proof)
        + rln_proof_values_to_bytes(p.proof_values, be)
    )


def bytes_to_rln_proof(data: bytes, be: bool = False) -> Tuple[RLNProof, int]:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    _mode_from_byte(data[0])
    read = 1
    if len(data) < read + COMPRESS_PROOF_SIZE:
        raise errors.InvalidReadLen(read + COMPRESS_PROOF_SIZE, len(data))
    proof = arkserde.proof_from_bytes(data[read : read + COMPRESS_PROOF_SIZE])
    read += COMPRESS_PROOF_SIZE
    values, sz = bytes_to_rln_proof_values(data[read:], be)
    read += sz
    _check_fully_read(read, len(data))
    return RLNProof(proof=proof, proof_values=values), read


# ---------------------------------------------------------------------------
# partial proof codec (reference proof.rs:527-588; always ark LE):
# version byte + mask Vec<bool> + pi_a G1 + rho G1 + pi_b G2 + pi_c G1
# ---------------------------------------------------------------------------


def rln_partial_proof_to_bytes(partial) -> bytes:
    out = bytes([MODE_SINGLE])
    out += struct.pack("<Q", len(partial.mask))
    out += bytes(1 if m else 0 for m in partial.mask)
    out += arkserde.g1_to_compressed(partial.partial_pi_a)
    out += arkserde.g1_to_compressed(partial.partial_rho)
    out += arkserde.g2_to_compressed(partial.partial_pi_b)
    out += arkserde.g1_to_compressed(partial.partial_pi_c)
    return out


def bytes_to_rln_partial_proof(data: bytes):
    from ..groth16.prover import PartialProof

    if not data:
        raise errors.InvalidReadLen(1, 0)
    _mode_from_byte(data[0])
    read = 1
    (n,) = struct.unpack("<Q", data[read : read + 8])
    read += 8
    mask = [b != 0 for b in data[read : read + n]]
    read += n
    pi_a = arkserde.g1_from_compressed(data[read : read + 32])
    read += 32
    rho = arkserde.g1_from_compressed(data[read : read + 32])
    read += 32
    pi_b = arkserde.g2_from_compressed(data[read : read + 64])
    read += 64
    pi_c = arkserde.g1_from_compressed(data[read : read + 32])
    read += 32
    _check_fully_read(read, len(data))
    return (
        PartialProof(
            mask=mask,
            partial_pi_a=pi_a,
            partial_rho=rho,
            partial_pi_b=pi_b,
            partial_pi_c=pi_c,
        ),
        read,
    )


# ---------------------------------------------------------------------------
# V3 enum codecs (reference serialize.rs): 1-byte enum tag + struct body.
#
# The two endiannesses are DIFFERENT codecs in the reference, not one layout
# with flipped byte order:
#   * LE follows the arkworks CanonicalSerialize derive, i.e. struct field
#     order. Single: secret, limit, path, index, x, ext, message_id (LAST) —
#     rln/src/protocol/witness.rs:1288-1296 field order.
#   * BE is hand-written (serialize.rs:352-366): Single puts message_id THIRD
#     (secret, limit, message_id, path, index, x, ext).
# Multi witness body is the same both ways: secret, limit, path, index, x,
# ext, message_ids, selector_used.
# Proof values Single body: y, root, nullifier, x, ext.
# Proof values Multi body: ys, root, nullifiers, x, ext, selector_used.
# V3 bools are strictly 0/1 (serialize.rs:236-244).
# ---------------------------------------------------------------------------


def witness_v3_to_bytes(w: RLNWitnessInput, be: bool = False) -> bytes:
    tag = bytes([0 if w.is_single else 1])
    out = tag + fr_to_bytes(w.identity_secret, be) + fr_to_bytes(w.user_message_limit, be)
    if w.is_single:
        if be:
            out += fr_to_bytes(w.message_id, be)
        out += vec_fr_to_bytes(w.path_elements, be)
        out += vec_u8_to_bytes(w.identity_path_index, be)
        out += fr_to_bytes(w.x, be)
        out += fr_to_bytes(w.external_nullifier, be)
        if not be:
            out += fr_to_bytes(w.message_id, be)
    else:
        out += vec_fr_to_bytes(w.path_elements, be)
        out += vec_u8_to_bytes(w.identity_path_index, be)
        out += fr_to_bytes(w.x, be)
        out += fr_to_bytes(w.external_nullifier, be)
        out += vec_fr_to_bytes(w.message_ids, be)
        out += vec_bool_to_bytes(w.selector_used, be)
    return out


def bytes_to_witness_v3(data: bytes, be: bool = False) -> RLNWitnessInput:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    tag = data[0]
    if tag not in (0, 1):
        raise errors.SerializationError(f"invalid enum tag {tag}")
    read = 1
    secret, sz = bytes_to_fr(data[read:], be)
    read += sz
    limit, sz = bytes_to_fr(data[read:], be)
    read += sz
    if tag == 0:
        message_id = None
        if be:
            message_id, sz = bytes_to_fr(data[read:], be)
            read += sz
        path, sz = bytes_to_vec_fr(data[read:], be)
        read += sz
        idx, sz = bytes_to_vec_u8(data[read:], be)
        read += sz
        x, sz = bytes_to_fr(data[read:], be)
        read += sz
        ext, sz = bytes_to_fr(data[read:], be)
        read += sz
        if not be:
            message_id, sz = bytes_to_fr(data[read:], be)
            read += sz
        _check_fully_read(read, len(data))
        return RLNWitnessInput.new_single(secret, limit, message_id, path, idx, x, ext)
    path, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    idx, sz = bytes_to_vec_u8(data[read:], be)
    read += sz
    x, sz = bytes_to_fr(data[read:], be)
    read += sz
    ext, sz = bytes_to_fr(data[read:], be)
    read += sz
    mids, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    sels, sz = bytes_to_vec_bool(data[read:], be, strict=True)
    read += sz
    if len(sels) != len(mids):
        raise errors.FieldLengthMismatch(
            f"message_ids has {len(mids)}, selector_used has {len(sels)}"
        )
    _check_fully_read(read, len(data))
    return RLNWitnessInput.new_multi(secret, limit, mids, path, idx, x, ext, sels)


def partial_witness_v3_to_bytes(w: RLNPartialWitnessInput, be: bool = False) -> bytes:
    """RLNPartialWitnessInputV3 is a plain struct (no enum tag byte); LE derive
    order and the hand-written BE order coincide (serialize.rs:449-487)."""
    return (
        fr_to_bytes(w.identity_secret, be)
        + fr_to_bytes(w.user_message_limit, be)
        + vec_fr_to_bytes(w.path_elements, be)
        + vec_u8_to_bytes(w.identity_path_index, be)
    )


def bytes_to_partial_witness_v3(data: bytes, be: bool = False) -> RLNPartialWitnessInput:
    read = 0
    secret, sz = bytes_to_fr(data[read:], be)
    read += sz
    limit, sz = bytes_to_fr(data[read:], be)
    read += sz
    path, sz = bytes_to_vec_fr(data[read:], be)
    read += sz
    idx, sz = bytes_to_vec_u8(data[read:], be)
    read += sz
    _check_fully_read(read, len(data))
    return RLNPartialWitnessInput.new(secret, limit, path, idx)


def proof_values_v3_to_bytes(v: RLNProofValues, be: bool = False) -> bytes:
    tag = bytes([0 if v.is_single else 1])
    if v.is_single:
        return (
            tag
            + fr_to_bytes(v.y, be)
            + fr_to_bytes(v.root, be)
            + fr_to_bytes(v.nullifier, be)
            + fr_to_bytes(v.x, be)
            + fr_to_bytes(v.external_nullifier, be)
        )
    return (
        tag
        + vec_fr_to_bytes(v.ys, be)
        + fr_to_bytes(v.root, be)
        + vec_fr_to_bytes(v.nullifiers, be)
        + fr_to_bytes(v.x, be)
        + fr_to_bytes(v.external_nullifier, be)
        + vec_bool_to_bytes(v.selector_used, be)
    )


def bytes_to_proof_values_v3(data: bytes, be: bool = False) -> RLNProofValues:
    if not data:
        raise errors.InvalidReadLen(1, 0)
    tag = data[0]
    read = 1
    if tag == 0:
        y, sz = bytes_to_fr(data[read:], be)
        read += sz
        root, sz = bytes_to_fr(data[read:], be)
        read += sz
        nullifier, sz = bytes_to_fr(data[read:], be)
        read += sz
        x, sz = bytes_to_fr(data[read:], be)
        read += sz
        ext, sz = bytes_to_fr(data[read:], be)
        read += sz
        _check_fully_read(read, len(data))
        return RLNProofValues.new_single(root, x, ext, y, nullifier)
    if tag == 1:
        ys, sz = bytes_to_vec_fr(data[read:], be)
        read += sz
        root, sz = bytes_to_fr(data[read:], be)
        read += sz
        nullifiers, sz = bytes_to_vec_fr(data[read:], be)
        read += sz
        x, sz = bytes_to_fr(data[read:], be)
        read += sz
        ext, sz = bytes_to_fr(data[read:], be)
        read += sz
        sels, sz = bytes_to_vec_bool(data[read:], be, strict=True)
        read += sz
        _check_fully_read(read, len(data))
        return RLNProofValues.new_multi(root, x, ext, ys, nullifiers, sels)
    raise errors.SerializationError(f"invalid enum tag {tag}")


def proof_v3_to_bytes(proof, values: RLNProofValues) -> bytes:
    """Mixed-endian RLNProofV3 (serialize.rs:692-703): LE compressed proof +
    BE proof values."""
    return arkserde.proof_to_bytes(proof) + proof_values_v3_to_bytes(values, be=True)


def bytes_to_proof_v3(data: bytes):
    proof = arkserde.proof_from_bytes(data[:COMPRESS_PROOF_SIZE])
    values = bytes_to_proof_values_v3(data[COMPRESS_PROOF_SIZE:], be=True)
    return proof, values
