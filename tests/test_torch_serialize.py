"""The port's wire formats (zerokit_tpu_torch/protocol/serialize.py) against
golden layouts and against the JAX package's codecs.

The golden-vector cases are tests/test_serialize.py's, run on the port's
modules: the expected buffers are built here from the reference layouts
(rln/src/protocol/{witness,proof,serialize}.rs), independently of either
package's primitives. Then tests/test_protocol.py's serde roundtrips (its
lines 161-204) on the port's witnesses, whose Merkle paths come from the
port's tree. Then cross-package checks: the same seeded values give equal
bytes in both packages' encoders, and each package decodes the other's
bytes to the same values.
"""

import dataclasses
import random
import struct

import pytest
import torch

import zerokit_tpu.groth16.prover as j_prover
import zerokit_tpu.protocol.proof as j_proof
import zerokit_tpu.protocol.serialize as j_ser
import zerokit_tpu.protocol.witness as j_witness
from zerokit_tpu_torch import errors
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.groth16.prover import PartialProof
from zerokit_tpu_torch.hash.poseidon import poseidon_hash, poseidon_hash_pair
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.protocol import serialize as ser
from zerokit_tpu_torch.protocol.keygen import hash_to_field_le
from zerokit_tpu_torch.protocol.proof import RLNProof, RLNProofValues, proof_values_from_witness
from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput, RLNWitnessInput
from zerokit_tpu_torch.tree.merkle import OptimalMerkleTree

torch.set_num_threads(1)

DEPTH = 4

SECRET = 0x1234567890ABCDEF_FEDCBA0987654321_0011223344556677_0123456789ABCDEF % R
LIMIT = 100
MSG_ID = 7
PATH = [(i * 0x1111111111111111222222) % R for i in range(1, DEPTH + 1)]
IDX = [0, 1, 1, 0]
X = 0x0A0B0C0D0E0F_102030405060708090A0B0C0 % R
EXT = 0xDEADBEEF_CAFEBABE_12345678 % R


def fr(v, be):
    return int(v).to_bytes(32, "big" if be else "little")


def u64(n, be):
    return struct.pack(">Q" if be else "<Q", n)


def vec_fr(vals, be):
    return u64(len(vals), be) + b"".join(fr(v, be) for v in vals)


def vec_u8(vals, be):
    return u64(len(vals), be) + bytes(vals)


def vec_bool(vals, be):
    return u64(len(vals), be) + bytes(1 if v else 0 for v in vals)


def witness_single():
    return RLNWitnessInput.new_single(SECRET, LIMIT, MSG_ID, PATH, IDX, X, EXT)


def witness_multi():
    return RLNWitnessInput.new_multi(
        SECRET, LIMIT, [3, 0, 9, 0], PATH, IDX, X, EXT, [True, False, True, False]
    )


# -- v2 witness: version byte; Single has message_id THIRD (witness.rs:376) --


@pytest.mark.parametrize("be", [False, True])
def test_v2_witness_single_layout(be):
    expected = (
        bytes([0x00])
        + fr(SECRET, be)
        + fr(LIMIT, be)
        + fr(MSG_ID, be)
        + vec_fr(PATH, be)
        + vec_u8(IDX, be)
        + fr(X, be)
        + fr(EXT, be)
    )
    got = ser.rln_witness_to_bytes(witness_single(), be)
    assert got == expected
    w, n = ser.bytes_to_rln_witness(expected, be)
    assert n == len(expected) and w == witness_single()


@pytest.mark.parametrize("be", [False, True])
def test_v2_witness_multi_layout(be):
    expected = (
        bytes([0x01])
        + fr(SECRET, be)
        + fr(LIMIT, be)
        + vec_fr(PATH, be)
        + vec_u8(IDX, be)
        + fr(X, be)
        + fr(EXT, be)
        + vec_fr([3, 0, 9, 0], be)
        + vec_bool([True, False, True, False], be)
    )
    got = ser.rln_witness_to_bytes(witness_multi(), be)
    assert got == expected
    w, _ = ser.bytes_to_rln_witness(expected, be)
    assert w == witness_multi()


@pytest.mark.parametrize("be", [False, True])
def test_v2_partial_witness_layout(be):
    pw = RLNPartialWitnessInput.new(SECRET, LIMIT, PATH, IDX)
    expected = (
        bytes([0x00]) + fr(SECRET, be) + fr(LIMIT, be) + vec_fr(PATH, be) + vec_u8(IDX, be)
    )
    assert ser.rln_partial_witness_to_bytes(pw, be) == expected
    got, _ = ser.bytes_to_rln_partial_witness(expected, be)
    assert got == pw


# -- v2 proof values: root, ext_nullifier, x, then outputs (proof.rs:213-234) --


@pytest.mark.parametrize("be", [False, True])
def test_v2_proof_values_single_layout(be):
    v = RLNProofValues.new_single(11, X, EXT, 22, 33)
    expected = (
        bytes([0x00]) + fr(11, be) + fr(EXT, be) + fr(X, be) + fr(22, be) + fr(33, be)
    )
    assert ser.rln_proof_values_to_bytes(v, be) == expected
    got, _ = ser.bytes_to_rln_proof_values(expected, be)
    assert got == v


@pytest.mark.parametrize("be", [False, True])
def test_v2_proof_values_multi_layout(be):
    v = RLNProofValues.new_multi(11, X, EXT, [1, 2], [3, 4], [True, False])
    expected = (
        bytes([0x01])
        + fr(11, be)
        + fr(EXT, be)
        + fr(X, be)
        + vec_fr([1, 2], be)
        + vec_fr([3, 4], be)
        + vec_bool([True, False], be)
    )
    assert ser.rln_proof_values_to_bytes(v, be) == expected
    got, _ = ser.bytes_to_rln_proof_values(expected, be)
    assert got == v


# -- V3 witness: LE = derive order (message_id LAST, witness.rs:1288-1296);
#    BE = hand-written order (message_id THIRD, serialize.rs:352-366) ---------


def test_v3_witness_single_le_layout():
    expected = (
        bytes([0])
        + fr(SECRET, False)
        + fr(LIMIT, False)
        + vec_fr(PATH, False)
        + vec_u8(IDX, False)
        + fr(X, False)
        + fr(EXT, False)
        + fr(MSG_ID, False)  # message_id LAST in the ark derive order
    )
    assert ser.witness_v3_to_bytes(witness_single(), be=False) == expected
    assert ser.bytes_to_witness_v3(expected, be=False) == witness_single()


def test_v3_witness_single_be_layout():
    expected = (
        bytes([0])
        + fr(SECRET, True)
        + fr(LIMIT, True)
        + fr(MSG_ID, True)  # message_id THIRD in the hand-written BE codec
        + vec_fr(PATH, True)
        + vec_u8(IDX, True)
        + fr(X, True)
        + fr(EXT, True)
    )
    assert ser.witness_v3_to_bytes(witness_single(), be=True) == expected
    assert ser.bytes_to_witness_v3(expected, be=True) == witness_single()


@pytest.mark.parametrize("be", [False, True])
def test_v3_witness_multi_layout(be):
    expected = (
        bytes([1])
        + fr(SECRET, be)
        + fr(LIMIT, be)
        + vec_fr(PATH, be)
        + vec_u8(IDX, be)
        + fr(X, be)
        + fr(EXT, be)
        + vec_fr([3, 0, 9, 0], be)
        + vec_bool([True, False, True, False], be)
    )
    assert ser.witness_v3_to_bytes(witness_multi(), be) == expected
    assert ser.bytes_to_witness_v3(expected, be) == witness_multi()


@pytest.mark.parametrize("be", [False, True])
def test_v3_witness_roundtrip(be):
    for w in (witness_single(), witness_multi()):
        assert ser.bytes_to_witness_v3(ser.witness_v3_to_bytes(w, be), be) == w


@pytest.mark.parametrize("be", [False, True])
def test_v3_partial_witness_layout(be):
    pw = RLNPartialWitnessInput.new(SECRET, LIMIT, PATH, IDX)
    # no enum tag byte: RLNPartialWitnessInputV3 is a plain struct
    expected = fr(SECRET, be) + fr(LIMIT, be) + vec_fr(PATH, be) + vec_u8(IDX, be)
    assert ser.partial_witness_v3_to_bytes(pw, be) == expected
    assert ser.bytes_to_partial_witness_v3(expected, be) == pw


# -- V3 proof values: Single = y, root, nullifier, x, ext (proof.rs:983-989
#    field order == BE hand order, serialize.rs:594-600) ----------------------


@pytest.mark.parametrize("be", [False, True])
def test_v3_proof_values_single_layout(be):
    v = RLNProofValues.new_single(11, X, EXT, 22, 33)
    expected = (
        bytes([0]) + fr(22, be) + fr(11, be) + fr(33, be) + fr(X, be) + fr(EXT, be)
    )
    assert ser.proof_values_v3_to_bytes(v, be) == expected
    assert ser.bytes_to_proof_values_v3(expected, be) == v


@pytest.mark.parametrize("be", [False, True])
def test_v3_proof_values_multi_layout(be):
    v = RLNProofValues.new_multi(11, X, EXT, [1, 2], [3, 4], [True, False])
    expected = (
        bytes([1])
        + vec_fr([1, 2], be)
        + fr(11, be)
        + vec_fr([3, 4], be)
        + fr(X, be)
        + fr(EXT, be)
        + vec_bool([True, False], be)
    )
    assert ser.proof_values_v3_to_bytes(v, be) == expected
    assert ser.bytes_to_proof_values_v3(expected, be) == v


# -- rejection cases (reference serialize.rs canonicality rules) --------------


@pytest.mark.parametrize("be", [False, True])
def test_non_canonical_fr_rejected(be):
    bad = int(R).to_bytes(32, "big" if be else "little")
    with pytest.raises(errors.NonCanonicalFieldElement):
        ser.bytes_to_fr(bad, be)


def test_v3_bad_enum_tag_rejected():
    with pytest.raises(errors.SerializationError):
        ser.bytes_to_witness_v3(bytes([2]) + b"\x00" * 64, be=False)
    with pytest.raises(errors.SerializationError):
        ser.bytes_to_proof_values_v3(bytes([9]) + b"\x00" * 160, be=True)


def test_v3_non_canonical_bool_rejected():
    data = ser.witness_v3_to_bytes(witness_multi(), be=True)
    bad = data[:-1] + bytes([2])  # last selector byte -> 2
    with pytest.raises(errors.NonCanonicalBool):
        ser.bytes_to_witness_v3(bad, be=True)


@pytest.mark.parametrize("be", [False, True])
def test_trailing_bytes_rejected(be):
    data = ser.rln_witness_to_bytes(witness_single(), be) + b"\x00"
    with pytest.raises(errors.InvalidReadLen):
        ser.bytes_to_rln_witness(data, be)
    data = ser.witness_v3_to_bytes(witness_single(), be) + b"\x00"
    with pytest.raises(errors.InvalidReadLen):
        ser.bytes_to_witness_v3(data, be)


def test_truncated_rejected():
    data = ser.witness_v3_to_bytes(witness_single(), be=False)
    with pytest.raises(errors.UtilsError):
        ser.bytes_to_witness_v3(data[:40], be=False)


# -- tests/test_protocol.py's serde cases (lines 161-204), on the port -------


def _test_witness(multi=False):
    """tests/test_protocol.py's witness, its path from the port's depth-20 tree."""
    secret = hash_to_field_le(b"test-secret")
    limit = 100
    tree = OptimalMerkleTree(20, device="cpu")
    rate = poseidon_hash_pair(poseidon_hash([secret]), limit)
    tree.set(3, rate)
    proof = tree.proof(3)
    x = hash_to_field_le(b"hey hey")
    ext = poseidon_hash_pair(hash_to_field_le(b"test-epoch"),
                             hash_to_field_le(b"test-rln-identifier"))
    if multi:
        return RLNWitnessInput.new_multi(
            secret, limit, [1, 2, 0, 0], proof.get_path_elements(),
            proof.get_path_index(), x, ext, [True, True, False, False],
        ), tree.root()
    return RLNWitnessInput.new_single(
        secret, limit, 1, proof.get_path_elements(), proof.get_path_index(), x, ext
    ), tree.root()


@pytest.mark.parametrize("be", [False, True], ids=["le", "be"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_witness_serde_roundtrip(be, multi):
    w, _ = _test_witness(multi)
    data = ser.rln_witness_to_bytes(w, be)
    assert data[0] == (0x01 if multi else 0x00)
    back, read = ser.bytes_to_rln_witness(data, be)
    assert read == len(data)
    assert back == w
    # trailing bytes rejected
    with pytest.raises(errors.InvalidReadLen):
        ser.bytes_to_rln_witness(data + b"\x00", be)
    # unknown version byte
    with pytest.raises(errors.UnknownVersionByte):
        ser.bytes_to_rln_witness(b"\x07" + data[1:], be)


@pytest.mark.parametrize("be", [False, True], ids=["le", "be"])
def test_partial_witness_serde_roundtrip(be):
    w, _ = _test_witness()
    pw = RLNPartialWitnessInput.from_witness(w)
    data = ser.rln_partial_witness_to_bytes(pw, be)
    back, read = ser.bytes_to_rln_partial_witness(data, be)
    assert read == len(data)
    assert back == pw


@pytest.mark.parametrize("be", [False, True], ids=["le", "be"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_proof_values_serde_roundtrip(be, multi):
    w, _ = _test_witness(multi)
    v = proof_values_from_witness(w)
    data = ser.rln_proof_values_to_bytes(v, be)
    back, read = ser.bytes_to_rln_proof_values(data, be)
    assert read == len(data)
    assert back == v
    # v3 codec roundtrip
    d3 = ser.proof_values_v3_to_bytes(v, be)
    assert ser.bytes_to_proof_values_v3(d3, be) == v


def test_non_canonical_fr_in_vec_rejected():
    data = ser._len_prefix(1, False) + (R).to_bytes(32, "little")
    with pytest.raises(errors.NonCanonicalFieldElement):
        ser.bytes_to_vec_fr(data, False)


# -- cross-package: the same seeded values, equal bytes both ways ------------


def _seeded(seed: int, multi: bool):
    """Field values from a seed, as plain ints, for both packages' types."""
    rnd = random.Random(seed)

    def f():
        return rnd.randrange(R)

    depth = 4 + seed % 4
    vals = dict(
        secret=f(), limit=rnd.randrange(1, 1 << 16), path=[f() for _ in range(depth)],
        idx=[rnd.randrange(2) for _ in range(depth)], x=f(), ext=f(),
    )
    if multi:
        vals["ids"] = [rnd.randrange(vals["limit"]) for _ in range(4)]
        vals["sel"] = [bool(rnd.randrange(2)) for _ in range(4)]
    else:
        vals["mid"] = rnd.randrange(vals["limit"])
    return vals


def _witness_pair(seed: int, multi: bool):
    v = _seeded(seed, multi)
    out = []
    for cls in (j_witness.RLNWitnessInput, RLNWitnessInput):
        if multi:
            out.append(cls.new_multi(v["secret"], v["limit"], v["ids"], v["path"], v["idx"],
                                     v["x"], v["ext"], v["sel"]))
        else:
            out.append(cls.new_single(v["secret"], v["limit"], v["mid"], v["path"], v["idx"],
                                      v["x"], v["ext"]))
    return out


def _points(seed: int):
    rnd = random.Random(seed)
    g1 = [bn254.G1.mul(bn254.G1_GENERATOR, rnd.randrange(1, R)) for _ in range(3)]
    g2 = bn254.G2.mul(bn254.G2_GENERATOR, rnd.randrange(1, R))
    return (g1[0], g2, g1[1]), g1, g2


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("be", [False, True], ids=["le", "be"])
def test_cross_package_bytes(seed, multi, be):
    jw, tw = _witness_pair(seed, multi)
    pairs = [
        (j_ser.rln_witness_to_bytes(jw, be), ser.rln_witness_to_bytes(tw, be)),
        (j_ser.witness_v3_to_bytes(jw, be), ser.witness_v3_to_bytes(tw, be)),
    ]
    jpw = j_witness.RLNPartialWitnessInput.from_witness(jw)
    tpw = RLNPartialWitnessInput.from_witness(tw)
    pairs += [
        (j_ser.rln_partial_witness_to_bytes(jpw, be), ser.rln_partial_witness_to_bytes(tpw, be)),
        (j_ser.partial_witness_v3_to_bytes(jpw, be), ser.partial_witness_v3_to_bytes(tpw, be)),
    ]
    jv = j_proof.proof_values_from_witness(jw)
    tv = proof_values_from_witness(tw)
    proof, _, _ = _points(seed)
    pairs += [
        (j_ser.rln_proof_values_to_bytes(jv, be), ser.rln_proof_values_to_bytes(tv, be)),
        (j_ser.proof_values_v3_to_bytes(jv, be), ser.proof_values_v3_to_bytes(tv, be)),
        (j_ser.rln_proof_to_bytes(j_proof.RLNProof(proof=proof, proof_values=jv), be),
         ser.rln_proof_to_bytes(RLNProof(proof=proof, proof_values=tv), be)),
        (j_ser.proof_v3_to_bytes(proof, jv), ser.proof_v3_to_bytes(proof, tv)),
        (j_ser.vec_fr_to_bytes(tw.path_elements, be), ser.vec_fr_to_bytes(tw.path_elements, be)),
        (j_ser.vec_u8_to_bytes(tw.identity_path_index, be),
         ser.vec_u8_to_bytes(tw.identity_path_index, be)),
    ]
    for j_bytes, t_bytes in pairs:
        assert t_bytes == j_bytes
    # each package decodes the other's bytes to the same values
    wire = ser.rln_witness_to_bytes(tw, be)
    j_back, _ = j_ser.bytes_to_rln_witness(wire, be)
    t_back, _ = ser.bytes_to_rln_witness(j_ser.rln_witness_to_bytes(jw, be), be)
    assert dataclasses.astuple(j_back) == dataclasses.astuple(tw)
    assert t_back == tw
    pv_wire = j_ser.proof_v3_to_bytes(proof, jv)
    t_proof, t_vals = ser.bytes_to_proof_v3(pv_wire)
    assert t_proof == proof and t_vals == tv


@pytest.mark.parametrize("seed", [1, 2])
def test_cross_package_partial_proof(seed):
    """Partial proofs decode into each package's own PartialProof."""
    _, g1, g2 = _points(seed)
    rnd = random.Random(seed)
    mask = [bool(rnd.randrange(2)) for _ in range(5 + seed)]
    tp = PartialProof(mask=mask, partial_pi_a=g1[0], partial_rho=g1[1], partial_pi_b=g2,
                      partial_pi_c=g1[2])
    jp = j_prover.PartialProof(mask=mask, partial_pi_a=g1[0], partial_rho=g1[1],
                               partial_pi_b=g2, partial_pi_c=g1[2])
    wire = ser.rln_partial_proof_to_bytes(tp)
    assert wire == j_ser.rln_partial_proof_to_bytes(jp)
    back, read = ser.bytes_to_rln_partial_proof(wire)
    assert read == len(wire) and isinstance(back, PartialProof)
    assert dataclasses.astuple(back) == dataclasses.astuple(tp)
    j_back, _ = j_ser.bytes_to_rln_partial_proof(wire)
    assert dataclasses.astuple(j_back) == dataclasses.astuple(tp)
