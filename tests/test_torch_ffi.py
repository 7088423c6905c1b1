"""The port's C ABI (zerokit_tpu_torch/native/rln_ffi.cpp, built by
runtime/build.build_ffi) on tests/test_ffi.py's cases, against the JAX
package's shim.

tests/test_ffi.py's cases drive the port's librln_ffi.so in-process through
ctypes, with ZEROKIT_TORCH_DEVICE=cpu (the C ABI has no device argument):
merkle ops, proofs, verify_with_roots, recover_id_secret, metadata, the
codecs, builders and Fr helpers, checked against the port's Python API;
the two that prove at depth 10 are `slow`, as the reference marks them.
Then cross-package checks: the port's shim and the JAX package's
(native/librln_ffi.so) give equal output bytes for the same deterministic
calls, and (`slow`) equal proofs through rln_generate_proof_with_rs at
the same witness and (r, s). Without a card and without the variable,
rln_new fails with the device error.
"""

import ctypes
import os
import random

import pytest
import torch

from zerokit_tpu_torch import errors
from zerokit_tpu_torch.ff.field import DEVICE_ENV
from zerokit_tpu_torch.hash.poseidon import poseidon_hash, poseidon_hash_pair
from zerokit_tpu_torch.protocol import serialize as ser
from zerokit_tpu_torch.protocol.keygen import hash_to_field_le, seeded_keygen
from zerokit_tpu_torch.resources import load_resource
from zerokit_tpu_torch.runtime.build import build_ffi
from zerokit_tpu_torch.tree.merkle import OptimalMerkleTree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIB = os.path.join(REPO, "native", "librln_ffi.so")


class RlnBuffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.POINTER(ctypes.c_uint8)), ("len", ctypes.c_size_t)]


def _bind(lib):
    lib.rln_last_error.restype = ctypes.c_char_p
    lib.rln_new.restype = ctypes.c_uint64
    lib.rln_new.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
    ]
    lib.rln_leaves_set.restype = ctypes.c_int64
    assert lib.rln_init() == 0, lib.rln_last_error()
    return lib


@pytest.fixture(scope="module")
def cpu_device():
    """The C ABI has no device argument: its engines take the environment's."""
    before = os.environ.get(DEVICE_ENV)
    os.environ[DEVICE_ENV] = "cpu"
    yield
    if before is None:
        del os.environ[DEVICE_ENV]
    else:
        os.environ[DEVICE_ENV] = before


@pytest.fixture(scope="module")
def lib(cpu_device):
    """The port's shim, built from zerokit_tpu_torch/native/rln_ffi.cpp."""
    return _bind(ctypes.CDLL(build_ffi()))


@pytest.fixture(scope="module")
def ref_lib():
    """The JAX package's shim (native/librln_ffi.so), for cross-package checks."""
    return _bind(ctypes.CDLL(REF_LIB))


def take(lib, buf: RlnBuffer) -> bytes:
    out = ctypes.string_at(buf.ptr, buf.len)
    lib.rln_buffer_free(ctypes.byref(buf))
    return out


def fr(v: int) -> bytes:
    return ser.fr_to_bytes(v, False)


def from_fr(data: bytes) -> int:
    return ser.bytes_to_fr(data, False)[0]


@pytest.fixture(scope="module")
def engine(lib):
    """Stateful engine over the depth-10 circuit (small => fast tests)."""
    zkey = load_resource("tree_depth_10/rln_final.arkzkey")
    graph = load_resource("tree_depth_10/graph.bin")
    h = lib.rln_new(1, b"single", b"optimal", zkey, len(zkey), graph, len(graph), None)
    assert h != 0, lib.rln_last_error()
    yield h
    lib.rln_free(h)


def test_keygen_and_hash(lib):
    buf = RlnBuffer()
    assert lib.rln_seeded_keygen(b"ffi-seed", 8, ctypes.byref(buf)) == 0
    data = take(lib, buf)
    assert len(data) == 64
    sk, pk = seeded_keygen(b"ffi-seed")
    assert from_fr(data[:32]) == int(sk)
    assert from_fr(data[32:]) == pk

    assert lib.rln_hash_to_field(b"hello", 5, 0, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == hash_to_field_le(b"hello")

    inputs = ser.vec_fr_to_bytes([1, 2], False)
    assert lib.rln_poseidon_hash(inputs, len(inputs), ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == poseidon_hash_pair(1, 2)


def test_tree_ops_match_python(lib, engine):
    assert lib.rln_tree_depth(engine) == 10
    ref = OptimalMerkleTree(10, device="cpu")
    leaves = [poseidon_hash([i]) for i in range(8)]
    for i, leaf in enumerate(leaves):
        ref.set(i, leaf)
    blob = ser.vec_fr_to_bytes(leaves, False)
    assert lib.rln_set_leaves_from(engine, 0, blob, len(blob)) == 0
    buf = RlnBuffer()
    assert lib.rln_get_root(engine, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == ref.root()
    assert lib.rln_leaves_set(engine) == 8

    # merkle proof serialization: vec<Fr> elements + vec<u8> index
    assert lib.rln_get_merkle_proof(engine, 3, ctypes.byref(buf)) == 0
    data = take(lib, buf)
    elements, used = ser.bytes_to_vec_fr(data, False)
    indices, _ = ser.bytes_to_vec_u8(data[used:], False)
    proof = ref.proof(3)
    assert elements == proof.get_path_elements()
    assert indices == proof.get_path_index()

    # single leaf roundtrip + subtree root + delete
    assert lib.rln_set_leaf(engine, 9, fr(42)) == 0
    ref.set(9, 42)
    assert lib.rln_get_leaf(engine, 9, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == 42
    assert lib.rln_get_subtree_root(engine, 1, 0, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == ref.get_subtree_root(1, 0)
    assert lib.rln_delete_leaf(engine, 9) == 0
    ref.delete(9)
    assert lib.rln_get_root(engine, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == ref.root()

    # atomic op: overwrite 2 leaves, remove index 0
    new_leaves = ser.vec_fr_to_bytes([111, 222], False)
    idx = (ctypes.c_uint64 * 1)(0)
    assert lib.rln_atomic_operation(engine, 1, new_leaves, len(new_leaves), idx, 1) == 0
    ref.override_range(1, [111, 222], [0])
    assert lib.rln_get_root(engine, ctypes.byref(buf)) == 0
    assert from_fr(take(lib, buf)) == ref.root()


def test_metadata_roundtrip(lib, engine):
    buf = RlnBuffer()
    assert lib.rln_set_metadata(engine, b"ffi-meta", 8) == 0
    assert lib.rln_get_metadata(engine, ctypes.byref(buf)) == 0
    assert take(lib, buf) == b"ffi-meta"


def test_error_reporting(lib):
    buf = RlnBuffer()
    assert lib.rln_get_root(999999, ctypes.byref(buf)) == -1
    assert b"handle" in lib.rln_last_error()


@pytest.mark.slow
def test_proof_roundtrip_and_slashing(lib, engine):
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

    buf = RlnBuffer()
    limit = 100
    sk, pk = seeded_keygen(b"ffi-prover")
    rate_commitment = poseidon_hash_pair(pk, limit)
    assert lib.rln_set_leaf(engine, 5, fr(rate_commitment)) == 0

    assert lib.rln_get_merkle_proof(engine, 5, ctypes.byref(buf)) == 0
    data = take(lib, buf)
    elements, used = ser.bytes_to_vec_fr(data, False)
    indices, _ = ser.bytes_to_vec_u8(data[used:], False)

    ext = hash_to_field_le(b"ffi-epoch")

    def witness_bytes(signal: bytes, message_id: int = 1) -> bytes:
        w = RLNWitnessInput.new_single(
            sk, limit, message_id, elements, indices, hash_to_field_le(signal), ext
        )
        return ser.rln_witness_to_bytes(w, False)

    wb = witness_bytes(b"sig-1")
    assert lib.rln_generate_proof(engine, wb, len(wb), 0, ctypes.byref(buf)) == 0, (
        lib.rln_last_error()
    )
    proof1 = take(lib, buf)

    ok = ctypes.c_int(-1)
    assert lib.rln_verify(engine, proof1, len(proof1), ctypes.byref(ok)) == 0
    assert ok.value == 1

    x = fr(hash_to_field_le(b"sig-1"))
    assert lib.rln_verify_rln_proof(engine, proof1, len(proof1), x, ctypes.byref(ok)) == 0
    assert ok.value == 1
    # wrong signal is a semantic rejection, not an error
    bad_x = fr(hash_to_field_le(b"other"))
    assert (
        lib.rln_verify_rln_proof(engine, proof1, len(proof1), bad_x, ctypes.byref(ok))
        == 0
    )
    assert ok.value == 0

    _, root_used = ser.bytes_to_proof_v3(proof1)
    roots = ser.vec_fr_to_bytes([root_used.root], False)
    assert (
        lib.rln_verify_with_roots(
            engine, proof1, len(proof1), x, roots, len(roots), ctypes.byref(ok)
        )
        == 0
    )
    assert ok.value == 1

    # double-signal in the same epoch -> secret recovery through the C ABI
    wb2 = witness_bytes(b"sig-2")
    assert lib.rln_generate_proof(engine, wb2, len(wb2), 0, ctypes.byref(buf)) == 0
    proof2 = take(lib, buf)
    assert (
        lib.rln_recover_id_secret(
            proof1, len(proof1), proof2, len(proof2), ctypes.byref(buf)
        )
        == 0
    ), lib.rln_last_error()
    assert from_fr(take(lib, buf)) == int(sk)


@pytest.mark.slow
def test_prove_with_witness_ffi(lib, engine):
    """External-witness proving through the C ABI (rln_prove_with_witness):
    witness vector computed by the host interpreter outside the engine."""
    from zerokit_tpu_torch.circuit import witness_host
    from zerokit_tpu_torch.circuit.graph import graph_from_bytes
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

    buf = RlnBuffer()
    limit = 4
    sk, pk = seeded_keygen(b"ffi-ext-witness")
    rate_commitment = poseidon_hash_pair(pk, limit)
    assert lib.rln_set_leaf(engine, 2, fr(rate_commitment)) == 0
    assert lib.rln_get_merkle_proof(engine, 2, ctypes.byref(buf)) == 0
    data = take(lib, buf)
    elements, used = ser.bytes_to_vec_fr(data, False)
    indices, _ = ser.bytes_to_vec_u8(data[used:], False)

    w = RLNWitnessInput.new_single(
        sk, limit, 1, elements, indices,
        hash_to_field_le(b"ext-sig"), hash_to_field_le(b"ext-epoch"),
    )
    graph = graph_from_bytes(load_resource("tree_depth_10/graph.bin"), 10, None)
    calculated = witness_host.calc_witness(w.named_inputs(), graph)
    calc_le = b"".join(fr(v) for v in calculated)
    wb = ser.rln_witness_to_bytes(w, False)
    assert (
        lib.rln_prove_with_witness(
            engine, calc_le, len(calc_le), wb, len(wb), 0, ctypes.byref(buf)
        )
        == 0
    ), lib.rln_last_error()
    proof = take(lib, buf)
    ok = ctypes.c_int(-1)
    assert lib.rln_verify(engine, proof, len(proof), ctypes.byref(ok)) == 0
    assert ok.value == 1


def test_ffi_codecs_and_vec_builders(lib):
    """Round-3 surface: standalone codecs, accessors, vec builders, BE
    keygen (reference ffi_rln.rs codec exports + ffi_utils.rs builders)."""
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput
    from zerokit_tpu_torch.protocol.proof import proof_values_from_witness

    tree = OptimalMerkleTree(10, device="cpu")
    sk, pk = seeded_keygen(b"ffi-codec-seed")
    tree.set(0, poseidon_hash_pair(poseidon_hash([int(sk)]), 7))
    mp = tree.proof(0)
    w = RLNWitnessInput.new_single(
        int(sk), 7, 2, mp.get_path_elements(), mp.get_path_index(),
        hash_to_field_le(b"sig"), hash_to_field_le(b"en"),
    )
    wire_le = ser.rln_witness_to_bytes(w, False)

    # recode LE -> BE -> LE roundtrips through the C surface
    buf = RlnBuffer()
    assert lib.rln_recode_witness(wire_le, len(wire_le), 0, 1, ctypes.byref(buf)) == 0
    wire_be = take(lib, buf)
    assert wire_be == ser.rln_witness_to_bytes(w, True)
    assert lib.rln_recode_witness(wire_be, len(wire_be), 1, 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == wire_le

    # v2 <-> V3 witness wires
    assert lib.rln_witness_to_v3(wire_le, len(wire_le), 0, 0, ctypes.byref(buf)) == 0
    v3 = take(lib, buf)
    assert v3 == ser.witness_v3_to_bytes(w, False)
    assert lib.rln_v3_to_witness(v3, len(v3), 0, 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == wire_le

    # proof values from witness + accessors
    values = proof_values_from_witness(w)
    assert lib.rln_proof_values_from_witness(wire_le, len(wire_le), 0, ctypes.byref(buf)) == 0
    vals_wire = take(lib, buf)
    assert vals_wire == ser.rln_proof_values_to_bytes(values, False)
    assert lib.rln_proof_values_root(vals_wire, len(vals_wire), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(values.root)
    assert lib.rln_proof_values_x(vals_wire, len(vals_wire), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(values.x)
    assert lib.rln_proof_values_external_nullifier(vals_wire, len(vals_wire), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(values.external_nullifier)
    assert lib.rln_proof_values_nullifiers(vals_wire, len(vals_wire), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == ser.vec_fr_to_bytes([values.nullifier], False)
    assert lib.rln_recode_proof_values(vals_wire, len(vals_wire), 0, 1, ctypes.byref(buf)) == 0
    assert take(lib, buf) == ser.rln_proof_values_to_bytes(values, True)

    # partial witness recode
    from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput

    pw = RLNPartialWitnessInput.from_witness(w)
    pw_wire = ser.rln_partial_witness_to_bytes(pw, False)
    assert lib.rln_recode_partial_witness(pw_wire, len(pw_wire), 0, 1, ctypes.byref(buf)) == 0
    assert take(lib, buf) == ser.rln_partial_witness_to_bytes(pw, True)

    # vec<Fr> builders
    vals = [1, 2, int(pk)]
    concat = b"".join(fr(v) for v in vals)
    assert lib.rln_vec_fr_build(concat, len(concat), 0, ctypes.byref(buf)) == 0
    vec_wire = take(lib, buf)
    assert vec_wire == ser.vec_fr_to_bytes(vals, False)
    count = ctypes.c_size_t()
    assert lib.rln_vec_fr_len(vec_wire, len(vec_wire), 0, ctypes.byref(count)) == 0
    assert count.value == 3
    assert lib.rln_vec_fr_get(vec_wire, len(vec_wire), 0, 2, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(int(pk))
    assert lib.rln_vec_fr_get(vec_wire, len(vec_wire), 0, 5, ctypes.byref(buf)) != 0

    # vec<u8> builders
    raw = b"\x01\x02\xfe"
    assert lib.rln_vec_u8_build(raw, len(raw), 0, ctypes.byref(buf)) == 0
    u8_wire = take(lib, buf)
    assert u8_wire == ser.vec_u8_to_bytes(list(raw), False)
    assert lib.rln_vec_u8_read(u8_wire, len(u8_wire), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == raw

    # BE keygen variants (seeded: deterministic vs the Python API)
    assert lib.rln_seeded_keygen_be(b"seed-be", 7, ctypes.byref(buf)) == 0
    out = take(lib, buf)
    sk2, pk2 = seeded_keygen(b"seed-be")
    assert out == ser.fr_to_bytes(int(sk2), True) + ser.fr_to_bytes(pk2, True)
    assert lib.rln_keygen_be(ctypes.byref(buf)) == 0
    assert len(take(lib, buf)) == 64
    assert lib.rln_extended_keygen_be(ctypes.byref(buf)) == 0
    assert len(take(lib, buf)) == 128
    assert lib.rln_extended_seeded_keygen_be(b"x", 1, ctypes.byref(buf)) == 0
    assert len(take(lib, buf)) == 128

    # hashers
    a, b = 12345, 67890
    assert lib.rln_poseidon_hash_pair(fr(a), fr(b), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(poseidon_hash_pair(a, b))
    assert lib.rln_id_commitment(fr(int(sk)), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(poseidon_hash([int(sk)]))


def test_ffi_config_file_ctor_and_leaves(lib, tmp_path):
    """rln_new_with_config_file (1 MB cap, ffi_rln_v3.rs:18) + get_leaves."""
    zkey = load_resource("tree_depth_10/rln_final.arkzkey")
    graph = load_resource("tree_depth_10/graph.bin")
    cfg = tmp_path / "config.json"
    cfg.write_text('{"cache_capacity": 10000, "mode": "high_throughput"}')
    lib.rln_new_with_config_file.restype = ctypes.c_uint64
    lib.rln_new_with_config_file.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    h = lib.rln_new_with_config_file(
        1, b"single", b"pmtree", zkey, len(zkey), graph, len(graph),
        str(cfg).encode(),
    )
    assert h > 0, lib.rln_last_error()
    try:
        assert lib.rln_set_leaf(h, 0, fr(111)) == 0
        assert lib.rln_set_leaf(h, 1, fr(222)) == 0
        buf = RlnBuffer()
        assert lib.rln_get_leaves(h, ctypes.byref(buf)) == 0
        assert take(lib, buf) == ser.vec_fr_to_bytes([111, 222], False)
    finally:
        lib.rln_free(h)

    # over-cap config rejected
    big = tmp_path / "big.json"
    big.write_bytes(b"x" * ((1 << 20) + 1))
    h2 = lib.rln_new_with_config_file(
        1, b"single", b"pmtree", zkey, len(zkey), graph, len(graph),
        str(big).encode(),
    )
    assert h2 == 0


def test_ffi_witness_accessors_and_builders(lib):
    """Component-wise witness construction + per-field getters must
    round-trip against the Python wire codec (reference ffi_rln_v3.rs
    per-field ergonomics)."""
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

    secret = hash_to_field_le(b"ffi-breadth-secret")
    limit, mid = 7, 3
    elems = [poseidon_hash([i]) for i in range(4)]
    idxs = [0, 1, 1, 0]
    x = hash_to_field_le(b"ffi-x")
    ext = hash_to_field_le(b"ffi-ext")

    # vec wire helpers
    elems_flat = b"".join(fr(e) for e in elems)
    buf = RlnBuffer()
    assert lib.rln_vec_fr_build(elems_flat, len(elems_flat), 0, ctypes.byref(buf)) == 0
    elems_vec = take(lib, buf)
    assert lib.rln_vec_u8_build(bytes(idxs), len(idxs), 0, ctypes.byref(buf)) == 0
    idx_vec = take(lib, buf)

    assert (
        lib.rln_witness_build_single(
            fr(secret), ctypes.c_uint64(limit), ctypes.c_uint64(mid),
            elems_vec, ctypes.c_size_t(len(elems_vec)),
            idx_vec, ctypes.c_size_t(len(idx_vec)),
            fr(x), fr(ext), 0, ctypes.byref(buf),
        )
        == 0
    ), lib.rln_last_error()
    wire = take(lib, buf)
    want = ser.rln_witness_to_bytes(
        RLNWitnessInput.new_single(secret, limit, mid, elems, idxs, x, ext), False
    )
    assert wire == want

    # per-field getters
    def get(name, expect):
        fn = getattr(lib, name)
        b = RlnBuffer()
        assert fn(wire, len(wire), 0, ctypes.byref(b)) == 0, lib.rln_last_error()
        assert take(lib, b) == expect, name

    get("rln_witness_identity_secret", fr(secret))
    get("rln_witness_user_message_limit", fr(limit))
    get("rln_witness_x", fr(x))
    get("rln_witness_external_nullifier", fr(ext))
    get("rln_witness_message_ids", ser.vec_fr_to_bytes([mid], False))
    get("rln_witness_path_elements", ser.vec_fr_to_bytes(elems, False))
    get("rln_witness_path_index", ser.vec_u8_to_bytes(idxs, False))

    # multi constructor round-trip
    ids = [1, 4, 0, 0]
    sel = [1, 1, 0, 0]
    ids_flat = b"".join(fr(i) for i in ids)
    assert lib.rln_vec_fr_build(ids_flat, len(ids_flat), 0, ctypes.byref(buf)) == 0
    ids_vec = take(lib, buf)
    assert lib.rln_vec_u8_build(bytes(sel), len(sel), 0, ctypes.byref(buf)) == 0
    sel_vec = take(lib, buf)
    assert (
        lib.rln_witness_build_multi(
            fr(secret), ctypes.c_uint64(limit),
            ids_vec, ctypes.c_size_t(len(ids_vec)),
            sel_vec, ctypes.c_size_t(len(sel_vec)),
            elems_vec, ctypes.c_size_t(len(elems_vec)),
            idx_vec, ctypes.c_size_t(len(idx_vec)),
            fr(x), fr(ext), 0, ctypes.byref(buf),
        )
        == 0
    ), lib.rln_last_error()
    wire_m = take(lib, buf)
    want_m = ser.rln_witness_to_bytes(
        RLNWitnessInput.new_multi(
            secret, limit, ids, elems, idxs, x, ext, [bool(s) for s in sel]
        ),
        False,
    )
    assert wire_m == want_m
    b = RlnBuffer()
    assert lib.rln_witness_message_ids(wire_m, len(wire_m), 0, ctypes.byref(b)) == 0
    assert take(lib, b) == ser.vec_fr_to_bytes(ids, False)


def test_ffi_fr_arithmetic(lib):
    """CFr helper parity with host big-int math (reference ffi_utils.rs)."""
    from zerokit_tpu_torch.constants import R

    a, b = 123456789123456789 % R, hash_to_field_le(b"fr-op-b")
    buf = RlnBuffer()

    def binop(name, want):
        fn = getattr(lib, name)
        assert fn(fr(a), fr(b), 0, ctypes.byref(buf)) == 0, lib.rln_last_error()
        assert take(lib, buf) == fr(want), name

    binop("rln_fr_add", (a + b) % R)
    binop("rln_fr_sub", (a - b) % R)
    binop("rln_fr_mul", a * b % R)
    binop("rln_fr_div", a * pow(b, -1, R) % R)
    assert lib.rln_fr_neg(fr(a), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr((-a) % R)
    assert lib.rln_fr_inv(fr(a), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(pow(a, -1, R))
    assert lib.rln_fr_from_uint64(ctypes.c_uint64(42), 0, ctypes.byref(buf)) == 0
    assert take(lib, buf) == fr(42)
    # division by zero is an error, not a crash
    assert lib.rln_fr_div(fr(a), fr(0), 0, ctypes.byref(buf)) != 0
    assert b"zero" in lib.rln_last_error()
    # random: canonical and nondegenerate
    assert lib.rln_fr_random(0, ctypes.byref(buf)) == 0
    r1 = take(lib, buf)
    assert lib.rln_fr_random(0, ctypes.byref(buf)) == 0
    r2 = take(lib, buf)
    assert r1 != r2
    assert ser.bytes_to_fr(r1, False)[0] < R



# -- the device rule ----------------------------------------------------------


def test_engine_without_a_card_fails(lib):
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    zkey = load_resource("tree_depth_10/rln_final.arkzkey")
    graph = load_resource("tree_depth_10/graph.bin")
    del os.environ[DEVICE_ENV]
    try:
        h = lib.rln_new(0, b"single", b"optimal", zkey, len(zkey), graph, len(graph), None)
    finally:
        os.environ[DEVICE_ENV] = "cpu"
    assert h == 0
    assert b"no CUDA device" in lib.rln_last_error()


# -- the port's shim against the JAX package's --------------------------------


def _out(lib, name, *args):
    buf = RlnBuffer()
    rc = getattr(lib, name)(*args, ctypes.byref(buf))
    assert rc == 0, (name, lib.rln_last_error())
    return take(lib, buf)


def _witness_wire(seed: int, be: bool):
    rnd = random.Random(seed)
    sk, pk = seeded_keygen(b"cross-%d" % seed)
    tree = OptimalMerkleTree(10, device="cpu")
    tree.set(seed, poseidon_hash_pair(pk, 9))
    mp = tree.proof(seed)
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

    w = RLNWitnessInput.new_single(
        int(sk), 9, rnd.randrange(9), mp.get_path_elements(), mp.get_path_index(),
        hash_to_field_le(b"sig-%d" % seed), hash_to_field_le(b"ext-%d" % seed),
    )
    return ser.rln_witness_to_bytes(w, be)


@pytest.mark.parametrize("be", [0, 1], ids=["le", "be"])
def test_shims_give_equal_bytes(lib, ref_lib, be):
    a, b = fr(hash_to_field_le(b"fr-a")), fr(hash_to_field_le(b"fr-b"))
    if be:
        a, b = a[::-1], b[::-1]
    wire = _witness_wire(3, bool(be))
    vals = ser.vec_fr_to_bytes([5, 6, 7], bool(be))
    calls = [
        ("rln_seeded_keygen_be" if be else "rln_seeded_keygen", b"shim-seed", 9),
        ("rln_extended_seeded_keygen_be" if be else "rln_extended_seeded_keygen",
         b"shim-seed", 9),
        ("rln_hash_to_field", b"a signal", 8, be),
        ("rln_poseidon_hash_pair", a, b, be),
        ("rln_id_commitment", a, be),
        ("rln_fr_add", a, b, be), ("rln_fr_sub", a, b, be), ("rln_fr_mul", a, b, be),
        ("rln_fr_div", a, b, be), ("rln_fr_neg", a, be), ("rln_fr_inv", a, be),
        ("rln_fr_from_uint64", ctypes.c_uint64(2**64 - 1), be),
        ("rln_recode_witness", wire, len(wire), be, 1 - be),
        ("rln_witness_to_v3", wire, len(wire), be, be),
        ("rln_proof_values_from_witness", wire, len(wire), be),
        ("rln_witness_path_elements", wire, len(wire), be),
        ("rln_witness_message_ids", wire, len(wire), be),
        ("rln_vec_fr_build", vals[8:], len(vals) - 8, be),
    ]
    if not be:
        inputs = ser.vec_fr_to_bytes([1, 2, 3], False)
        calls.append(("rln_poseidon_hash", inputs, len(inputs)))
    for name, *args in calls:
        assert _out(lib, name, *args) == _out(ref_lib, name, *args), name


def test_shim_engines_give_equal_tree_bytes(lib, ref_lib, cpu_device):
    """The same tree operations on a stateful depth-10 engine of each shim."""
    zkey = load_resource("tree_depth_10/rln_final.arkzkey")
    graph = load_resource("tree_depth_10/graph.bin")
    handles = {}
    for name, shim in (("port", lib), ("jax", ref_lib)):
        h = shim.rln_new(1, b"single", b"optimal", zkey, len(zkey), graph, len(graph), None)
        assert h != 0, shim.rln_last_error()
        handles[name] = (shim, h)
    leaves = ser.vec_fr_to_bytes([poseidon_hash([i]) for i in range(1, 12)], False)
    idx = (ctypes.c_uint64 * 2)(0, 4)
    new = ser.vec_fr_to_bytes([777, 888], False)
    outs = {}
    try:
        for name, (shim, h) in handles.items():
            assert shim.rln_set_leaves_from(h, 0, leaves, len(leaves)) == 0
            assert shim.rln_set_leaf(h, 13, fr(4242)) == 0
            assert shim.rln_atomic_operation(h, 6, new, len(new), idx, 2) == 0
            outs[name] = [
                _out(shim, "rln_get_root", h),
                _out(shim, "rln_get_merkle_proof", h, 5),
                _out(shim, "rln_get_merkle_proof", h, 13),
                _out(shim, "rln_get_subtree_root", h, 3, 1),
                _out(shim, "rln_get_leaves", h),
                shim.rln_leaves_set(h),
            ]
    finally:
        for shim, h in handles.values():
            shim.rln_free(h)
    assert outs["port"] == outs["jax"]


@pytest.mark.slow
def test_with_rs_proofs_equal_the_jax_shims(lib, ref_lib, cpu_device):
    """rln_generate_proof_with_rs at depth 10: the port's proof bytes equal
    the JAX package's at the same witness and (r, s), and verify."""
    zkey = load_resource("tree_depth_10/rln_final.arkzkey")
    graph = load_resource("tree_depth_10/graph.bin")
    wire = _witness_wire(5, False)
    r, s = fr(hash_to_field_le(b"r-blind")), fr(hash_to_field_le(b"s-blind"))
    proofs = {}
    for name, shim in (("port", lib), ("jax", ref_lib)):
        h = shim.rln_new(0, b"single", b"optimal", zkey, len(zkey), graph, len(graph), None)
        assert h != 0, shim.rln_last_error()
        try:
            proofs[name] = _out(shim, "rln_generate_proof_with_rs", h, wire, len(wire), 0, r, s)
            ok = ctypes.c_int(-1)
            proof = proofs[name]
            assert shim.rln_verify(h, proof, len(proof), ctypes.byref(ok)) == 0
            assert ok.value == 1
        finally:
            shim.rln_free(h)
    assert proofs["port"] == proofs["jax"]


class _RecordingEngine:
    """Takes the place of an engine's RLN: records the witnesses it is given."""

    def __init__(self, proof):
        self.proof = proof
        self.witnesses = []

    def generate_proofs(self, witnesses):
        from zerokit_tpu_torch.protocol.proof import proof_values_from_witness

        self.witnesses += witnesses
        return [(self.proof, proof_values_from_witness(w)) for w in witnesses]


@pytest.mark.parametrize("be", [False, True], ids=["le", "be"])
def test_generate_proofs_batch_decodes_each_witness(be):
    """rln_generate_proofs' glue hands the engine every witness of the
    concatenation (single and multi wires mixed); the JAX package's glue
    decodes the rest of the buffer and raises InvalidReadLen."""
    import zerokit_tpu.errors as j_errors
    import zerokit_tpu.ffi_glue as j_glue
    import zerokit_tpu_torch.ffi_glue as glue
    from zerokit_tpu_torch.hostmath import bn254
    from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

    ws = [
        RLNWitnessInput.new_single(11, 10, 3, [1, 2, 3], [0, 1, 1], 7, 8),
        RLNWitnessInput.new_multi(12, 10, [1, 2, 0, 0], [4, 5, 6], [1, 0, 1], 9, 8,
                                  [True, True, False, False]),
        RLNWitnessInput.new_single(13, 10, 4, [1, 2, 3], [1, 1, 0], 5, 8),
    ]
    blob = b"".join(ser.rln_witness_to_bytes(w, be) for w in ws)
    proof = (bn254.G1.mul(bn254.G1_GENERATOR, 3), bn254.G2.mul(bn254.G2_GENERATOR, 5),
             bn254.G1.mul(bn254.G1_GENERATOR, 7))
    engine = _RecordingEngine(proof)
    glue._handles[-1] = engine
    try:
        out = glue.generate_proofs_batch(-1, len(ws), blob, be)
        with pytest.raises(errors.InsufficientData):
            glue.generate_proofs_batch(-1, len(ws), blob[:-1], be)
    finally:
        del glue._handles[-1]
    assert engine.witnesses[:3] == ws
    from zerokit_tpu_torch.protocol.proof import proof_values_from_witness

    assert out == b"".join(ser.proof_v3_to_bytes(proof, proof_values_from_witness(w))
                           for w in ws)
    j_glue._handles[-1] = engine
    try:
        with pytest.raises(j_errors.InvalidReadLen):
            j_glue.generate_proofs_batch(-1, len(ws), blob, be)
    finally:
        del j_glue._handles[-1]
