"""Byte-level glue behind the C FFI (zerokit_tpu_torch/native/rln_ffi.cpp).

The reference exposes its engine to C through ~74 `ffi_*` functions over
serialized buffers (rln/src/ffi/ffi_rln.rs, ffi_rln_v3.rs, ffi_tree.rs).
Here the C ABI library routes every call to this module: all arguments and
results are primitive ints/bytes, handles are small integers into a
process-global table, and every wire format is the byte-exact zerokit
layout from protocol/serialize.py.

Keeping the marshalling on the Python side means the C++ layer stays a thin
embedding shim (GIL + error capture) with no Python C-API object juggling.

Counterpart of zerokit_tpu/ffi_glue.py; the device and the batch call's
decoding (generate_proofs_batch) differ. The C ABI has no device argument,
so `new` builds every engine, and the tree it holds, on the device that the
environment variable ZEROKIT_TORCH_DEVICE names ("cuda" when unset: without
a card it raises, and the C call returns its error; ff/field.device_from_env).
The shim is built by runtime/build.build_ffi into
build/zerokit_tpu_torch/librln_ffi.so.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from . import errors
from .api import RLN
from .constants import FR_BYTE_SIZE
from .ff.field import device_from_env
from .protocol import serialize as ser
from .protocol.keygen import (
    extended_keygen,
    extended_seeded_keygen,
    hash_to_field_be,
    hash_to_field_le,
    keygen,
    seeded_keygen,
)
from .hash.poseidon import poseidon_hash
from .protocol.slashing import recover_secret
from .protocol.witness import MODE_SINGLE, RLNWitnessInput
from .tree.merkle import FullMerkleTree, OptimalMerkleTree
from .tree.pmtree import PmTree

_lock = threading.Lock()
_handles: Dict[int, RLN] = {}
_next_handle = 1

_TREES = {
    "full": FullMerkleTree,
    "optimal": OptimalMerkleTree,
    "pmtree": PmTree,
}


def _fr_bytes(v: int, be: bool = False) -> bytes:
    return ser.fr_to_bytes(v, be)


def _fr_from(data: bytes, be: bool = False) -> int:
    v, _ = ser.bytes_to_fr(data, be)
    return v


# -- lifecycle (reference: ffi_rln_v3.rs:324-506 ctors, ffi_rln.rs new/free) --


def new(
    stateful: bool,
    mode: str,
    tree_backend: str = "optimal",
    zkey_bytes: Optional[bytes] = None,
    graph_bytes: Optional[bytes] = None,
    tree_config_json: Optional[str] = None,
) -> int:
    global _next_handle
    dev = device_from_env()
    if stateful:
        rln = RLN.stateless(mode, zkey_bytes or None, graph_bytes or None, device=dev)
        cls = _TREES[tree_backend]
        if tree_backend == "pmtree" and tree_config_json:
            from .tree.pmtree import PmTreeConfig

            rln.tree = PmTree(
                rln.graph.tree_depth, PmTreeConfig.from_json(tree_config_json),
                device=rln.device,
            )
        else:
            rln.tree = cls(rln.graph.tree_depth, device=rln.device)
    else:
        rln = RLN.stateless(mode, zkey_bytes or None, graph_bytes or None, device=dev)
    with _lock:
        h = _next_handle
        _next_handle += 1
        _handles[h] = rln
    return h


def free(handle: int) -> None:
    with _lock:
        _handles.pop(handle, None)


def _get(handle: int) -> RLN:
    rln = _handles.get(handle)
    if rln is None:
        raise KeyError(f"invalid RLN handle {handle}")
    return rln


# -- tree ops (reference: ffi_tree.rs:21-258, ffi_rln_v3.rs tree surface) -----


def set_leaf(handle: int, index: int, fr_le: bytes) -> None:
    _get(handle).set_leaf(index, _fr_from(fr_le))


def get_leaf(handle: int, index: int) -> bytes:
    return _fr_bytes(_get(handle).get_leaf(index))


def set_leaves_from(handle: int, index: int, leaves_le: bytes) -> None:
    vals, _ = ser.bytes_to_vec_fr(leaves_le, False)
    _get(handle).set_leaves_from(index, vals)


def init_tree_with_leaves(handle: int, leaves_le: bytes) -> None:
    vals, _ = ser.bytes_to_vec_fr(leaves_le, False)
    _get(handle).init_tree_with_leaves(vals)


def atomic_operation(handle: int, index: int, leaves_le: bytes, indices: List[int]) -> None:
    vals, _ = ser.bytes_to_vec_fr(leaves_le, False)
    _get(handle).atomic_operation(index, vals, list(indices))


def set_next_leaf(handle: int, fr_le: bytes) -> None:
    _get(handle).set_next_leaf(_fr_from(fr_le))


def delete_leaf(handle: int, index: int) -> None:
    _get(handle).delete_leaf(index)


def get_root(handle: int) -> bytes:
    return _fr_bytes(_get(handle).get_root())


def get_subtree_root(handle: int, level: int, index: int) -> bytes:
    return _fr_bytes(_get(handle).get_subtree_root(level, index))


def leaves_set(handle: int) -> int:
    return _get(handle).leaves_set()


def get_merkle_proof(handle: int, index: int) -> bytes:
    """Serialized as vec<Fr> path elements + vec<u8> path index (LE), the
    reference FFI layout (ffi_rln.rs get_proof serialization)."""
    proof = _get(handle).get_merkle_proof(index)
    out = ser.vec_fr_to_bytes(proof.get_path_elements(), False)
    out += ser.vec_u8_to_bytes(proof.get_path_index(), False)
    return out


def get_empty_leaves_indices(handle: int) -> List[int]:
    return _get(handle).get_empty_leaves_indices()


def set_metadata(handle: int, metadata: bytes) -> None:
    _get(handle).set_metadata(metadata)


def get_metadata(handle: int) -> bytes:
    return _get(handle).get_metadata()


def flush(handle: int) -> None:
    _get(handle).flush()


def tree_depth(handle: int) -> int:
    return _get(handle).tree_depth()


# -- proof ops (reference: ffi_rln.rs prove/verify, ffi_rln_v3.rs:507-1605) ---


def generate_proof(handle: int, witness_bytes: bytes, be: bool) -> bytes:
    """witness wire bytes in -> proof_v3 wire bytes out (128-B LE Groth16
    proof + proof values; serialize.rs:676-714 CanonicalSerializeMixed)."""
    rln = _get(handle)
    witness, _ = ser.bytes_to_rln_witness(witness_bytes, be)
    proof, values = rln.generate_proof(witness)
    return ser.proof_v3_to_bytes(proof, values)


def prove_with_witness(
    handle: int, calculated_le: bytes, witness_bytes: bytes, be: bool
) -> bytes:
    """Externally-computed witness vector (n_wires LE 32-byte Fr concat) +
    witness-input wire bytes -> proof_v3 wire bytes (the browser/wasm flow;
    reference public.rs:643 generate_rln_proof_with_witness)."""
    rln = _get(handle)
    if len(calculated_le) % 32:
        raise ValueError("calculated witness must be 32-byte LE field elements")
    cw = [
        int.from_bytes(calculated_le[i : i + 32], "little")
        for i in range(0, len(calculated_le), 32)
    ]
    witness, _ = ser.bytes_to_rln_witness(witness_bytes, be)
    proof, values = rln.generate_proof_with_witness(cw, witness)
    return ser.proof_v3_to_bytes(proof, values)


def verify(handle: int, proof_bytes: bytes) -> bool:
    rln = _get(handle)
    proof, values = ser.bytes_to_proof_v3(proof_bytes)
    return rln.verify(proof, values)


def verify_rln_proof(handle: int, proof_bytes: bytes, x_le: bytes) -> bool:
    """False (not an error) on semantic rejection, like the reference FFI's
    CBoolResult (ffi_utils.rs)."""
    rln = _get(handle)
    proof, values = ser.bytes_to_proof_v3(proof_bytes)
    try:
        return rln.verify_rln_proof(proof, values, _fr_from(x_le))
    except errors.ZerokitError:
        return False


def verify_with_roots(handle: int, proof_bytes: bytes, x_le: bytes, roots_le: bytes) -> bool:
    rln = _get(handle)
    proof, values = ser.bytes_to_proof_v3(proof_bytes)
    roots, _ = ser.bytes_to_vec_fr(roots_le, False) if roots_le else ([], 0)
    try:
        return rln.verify_with_roots(proof, values, _fr_from(x_le), roots)
    except errors.ZerokitError:
        return False


def generate_partial_proof(handle: int, partial_witness_bytes: bytes, be: bool) -> bytes:
    rln = _get(handle)
    pw, _ = ser.bytes_to_rln_partial_witness(partial_witness_bytes, be)
    partial = rln.generate_partial_proof(pw)
    return ser.rln_partial_proof_to_bytes(partial)


def finish_proof(handle: int, partial_proof_bytes: bytes, witness_bytes: bytes, be: bool) -> bytes:
    rln = _get(handle)
    partial, _ = ser.bytes_to_rln_partial_proof(partial_proof_bytes)
    witness, _ = ser.bytes_to_rln_witness(witness_bytes, be)
    proof, values = rln.finish_proof(partial, witness)
    return ser.proof_v3_to_bytes(proof, values)


def recover_id_secret(proof1_bytes: bytes, proof2_bytes: bytes) -> bytes:
    _, v1 = ser.bytes_to_proof_v3(proof1_bytes)
    _, v2 = ser.bytes_to_proof_v3(proof2_bytes)
    return _fr_bytes(recover_secret(v1, v2))


# -- primitives (reference: ffi_rln.rs keygen/hash exports) -------------------


def ffi_keygen(seed: Optional[bytes] = None) -> bytes:
    sk, pk = seeded_keygen(seed) if seed else keygen()
    return _fr_bytes(int(sk)) + _fr_bytes(pk)


def ffi_extended_keygen(seed: Optional[bytes] = None) -> bytes:
    parts = extended_seeded_keygen(seed) if seed else extended_keygen()
    return b"".join(_fr_bytes(int(p)) for p in parts)


def ffi_hash(signal: bytes, be: bool) -> bytes:
    v = hash_to_field_be(signal) if be else hash_to_field_le(signal)
    return _fr_bytes(v, be)


def ffi_poseidon_hash(inputs_le: bytes) -> bytes:
    vals, _ = ser.bytes_to_vec_fr(inputs_le, False)
    return _fr_bytes(poseidon_hash(vals))


def ffi_keygen_be(seed: Optional[bytes] = None) -> bytes:
    """BE variant (reference ffi_rln.rs exposes both endiannesses)."""
    sk, pk = seeded_keygen(seed) if seed else keygen()
    return _fr_bytes(int(sk), True) + _fr_bytes(pk, True)


def ffi_extended_keygen_be(seed: Optional[bytes] = None) -> bytes:
    parts = extended_seeded_keygen(seed) if seed else extended_keygen()
    return b"".join(_fr_bytes(int(p), True) for p in parts)


def ffi_poseidon_hash_pair(a: bytes, b: bytes, be: bool) -> bytes:
    from .hash.poseidon import poseidon_hash_pair

    return _fr_bytes(poseidon_hash_pair(_fr_from(a, be), _fr_from(b, be)), be)


def ffi_id_commitment(secret: bytes, be: bool) -> bytes:
    """Identity secret -> Poseidon commitment (keygen.rs:16-30 relation)."""
    return _fr_bytes(poseidon_hash([_fr_from(secret, be)]), be)


# -- standalone wire-format codecs (reference ffi_rln.rs *_to_bytes_{le,be},
#    bytes_{le,be}_to_* exports; all validate canonicality on the way in) ----


def recode_witness(data: bytes, in_be: bool, out_be: bool) -> bytes:
    w, read = ser.bytes_to_rln_witness(data, in_be)
    ser._check_fully_read(read, len(data))
    return ser.rln_witness_to_bytes(w, out_be)


def recode_partial_witness(data: bytes, in_be: bool, out_be: bool) -> bytes:
    w, read = ser.bytes_to_rln_partial_witness(data, in_be)
    ser._check_fully_read(read, len(data))
    return ser.rln_partial_witness_to_bytes(w, out_be)


def recode_proof_values(data: bytes, in_be: bool, out_be: bool) -> bytes:
    v, read = ser.bytes_to_rln_proof_values(data, in_be)
    ser._check_fully_read(read, len(data))
    return ser.rln_proof_values_to_bytes(v, out_be)


def witness_to_v3(data: bytes, in_be: bool, out_be: bool) -> bytes:
    """v2 witness wire -> V3 witness wire (serialize.rs:248-674 layouts)."""
    w, read = ser.bytes_to_rln_witness(data, in_be)
    ser._check_fully_read(read, len(data))
    return ser.witness_v3_to_bytes(w, out_be)


def v3_to_witness(data: bytes, in_be: bool, out_be: bool) -> bytes:
    w = ser.bytes_to_witness_v3(data, in_be)
    return ser.rln_witness_to_bytes(w, out_be)


def ffi_proof_values_from_witness(witness_bytes: bytes, be: bool) -> bytes:
    """Witness wire -> recomputed proof-values wire (witness.rs:759-828)."""
    from .protocol.proof import proof_values_from_witness

    w, read = ser.bytes_to_rln_witness(witness_bytes, be)
    ser._check_fully_read(read, len(witness_bytes))
    return ser.rln_proof_values_to_bytes(proof_values_from_witness(w), be)


def extract_proof_values(proof_bytes: bytes, be: bool) -> bytes:
    """V3 proof wire -> its proof-values wire (no pairing check)."""
    _, values = ser.bytes_to_proof_v3(proof_bytes)
    return ser.rln_proof_values_to_bytes(values, be)


def proof_values_root(values_bytes: bytes, be: bool) -> bytes:
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    return _fr_bytes(v.root, be)


def proof_values_x(values_bytes: bytes, be: bool) -> bytes:
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    return _fr_bytes(v.x, be)


def proof_values_external_nullifier(values_bytes: bytes, be: bool) -> bytes:
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    return _fr_bytes(v.external_nullifier, be)


def proof_values_nullifiers(values_bytes: bytes, be: bool) -> bytes:
    """Active nullifiers as vec<Fr> wire bytes (Single: one entry)."""
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    if v.nullifier is not None:
        nulls = [v.nullifier]
    else:
        nulls = [n for n, used in zip(v.nullifiers, v.selector_used) if used]
    return ser.vec_fr_to_bytes(nulls, be)


# -- Vec<Fr> builder helpers (reference ffi_utils.rs CFr/Vec builders) -------


def vec_fr_build(frs: bytes, be: bool) -> bytes:
    """n concatenated 32-byte field elements -> length-prefixed vec<Fr>."""
    if len(frs) % 32:
        raise ValueError("input must be 32-byte field elements")
    vals = [_fr_from(frs[i : i + 32], be) for i in range(0, len(frs), 32)]
    return ser.vec_fr_to_bytes(vals, be)


def vec_fr_len(vec_bytes: bytes, be: bool) -> int:
    vals, read = ser.bytes_to_vec_fr(vec_bytes, be)
    ser._check_fully_read(read, len(vec_bytes))
    return len(vals)


def vec_fr_get(vec_bytes: bytes, be: bool, index: int) -> bytes:
    vals, _ = ser.bytes_to_vec_fr(vec_bytes, be)
    if index < 0 or index >= len(vals):
        raise IndexError(f"vec<Fr> index {index} out of range ({len(vals)})")
    return _fr_bytes(vals[index], be)


def vec_u8_build(data: bytes, be: bool) -> bytes:
    return ser.vec_u8_to_bytes(list(data), be)


def vec_u8_read(vec_bytes: bytes, be: bool) -> bytes:
    vals, read = ser.bytes_to_vec_u8(vec_bytes, be)
    ser._check_fully_read(read, len(vec_bytes))
    return bytes(vals)


# -- extended engine ops -----------------------------------------------------

MAX_CONFIG_SIZE = 1 << 20  # 1 MB cap, reference ffi_rln_v3.rs:18


def new_with_config_file(
    stateful: bool,
    mode: str,
    tree_backend: str,
    zkey_bytes: Optional[bytes],
    graph_bytes: Optional[bytes],
    config_path: str,
) -> int:
    """Ctor reading the tree config from a FILE with the reference's 1 MB
    cap (ffi_rln_v3.rs:18, 324-506 config-file ctors)."""
    import os as _os

    if _os.path.getsize(config_path) > MAX_CONFIG_SIZE:
        raise ValueError(f"config file exceeds {MAX_CONFIG_SIZE} bytes")
    with open(config_path, "r") as f:
        cfg = f.read()
    return new(stateful, mode, tree_backend, zkey_bytes, graph_bytes, cfg)


def get_leaves(handle: int) -> bytes:
    """All set leaves [0, leaves_set) as vec<Fr> wire bytes."""
    rln = _get(handle)
    n = rln.tree.leaves_set()
    return ser.vec_fr_to_bytes([rln.tree.get(i) for i in range(n)], False)


def generate_proof_with_rs(
    handle: int, witness_bytes: bytes, be: bool, r_le: bytes, s_le: bytes
) -> bytes:
    """Deterministic proving with caller-provided blinding (reference
    proof.rs:753 generate_zk_proof_with_rs)."""
    rln = _get(handle)
    witness, _ = ser.bytes_to_rln_witness(witness_bytes, be)
    proof, values = rln.generate_proof(
        witness, r=_fr_from(r_le), s=_fr_from(s_le)
    )
    return ser.proof_v3_to_bytes(proof, values)


def _witness_wire_len(data: bytes, be: bool) -> int:
    """Bytes of the v2 witness wire at the head of `data` (the layout of
    serialize.rln_witness_to_bytes): bytes_to_rln_witness rejects trailing
    bytes, so each wire of a concatenation is cut out before it is decoded.
    Single: mode, secret, limit, message_id, path (vec<Fr>), index (vec<u8>),
    x, external nullifier; Multi: mode, secret, limit, path, index, x,
    external nullifier, message ids (vec<Fr>), selectors (vec<bool>)."""
    if not data:
        raise errors.InvalidReadLen(1, 0)
    single = ser._mode_from_byte(data[0]) == MODE_SINGLE

    def skip_vec(off: int, width: int) -> int:
        n, sz = ser._read_len(data[off:], be)
        return off + sz + n * width

    off = 1 + (3 if single else 2) * FR_BYTE_SIZE  # mode, secret, limit[, message_id]
    off = skip_vec(skip_vec(off, FR_BYTE_SIZE), 1) + 2 * FR_BYTE_SIZE  # path, index, x, ext
    if not single:
        off = skip_vec(skip_vec(off, FR_BYTE_SIZE), 1)  # message ids, selectors
    return off


def generate_proofs_batch(handle: int, count: int, witnesses_bytes: bytes, be: bool) -> bytes:
    """Batch-first proving (the accelerator-native capability the reference lacks):
    `count` concatenated witness wires in, `count` concatenated V3 proof
    wires out — the whole batch runs through one device pipeline. Each wire
    is cut out before it is decoded: zerokit_tpu/ffi_glue.py decodes the
    rest of the buffer, which bytes_to_rln_witness rejects for trailing
    bytes, so there any count above 1 raised InvalidReadLen."""
    rln = _get(handle)
    wits = []
    off = 0
    for _ in range(count):
        size = _witness_wire_len(witnesses_bytes[off:], be)
        w, read = ser.bytes_to_rln_witness(witnesses_bytes[off : off + size], be)
        wits.append(w)
        off += read
    ser._check_fully_read(off, len(witnesses_bytes))
    out = rln.generate_proofs(wits)
    return b"".join(ser.proof_v3_to_bytes(p, v) for p, v in out)


# -- per-field witness accessors + component constructors --------------------
# (reference ffi_rln_v3.rs:507-1605 per-field ergonomics: C callers build
# and inspect witnesses without hand-rolling the wire layout)


def witness_build_single(
    secret: bytes, limit: int, message_id: int, path_elements_vec: bytes,
    path_index_vec: bytes, x: bytes, external_nullifier: bytes, be: bool,
) -> bytes:
    """Component-wise Single witness constructor -> witness wire bytes.
    path_elements_vec: vec<Fr> wire; path_index_vec: vec<u8> wire."""
    elems, _ = ser.bytes_to_vec_fr(path_elements_vec, be)
    idx, _ = ser.bytes_to_vec_u8(path_index_vec, be)
    w = RLNWitnessInput.new_single(
        _fr_from(secret, be), limit, message_id, elems, idx,
        _fr_from(x, be), _fr_from(external_nullifier, be),
    )
    return ser.rln_witness_to_bytes(w, be)


def witness_build_multi(
    secret: bytes, limit: int, message_ids_vec: bytes, selector_vec: bytes,
    path_elements_vec: bytes, path_index_vec: bytes, x: bytes,
    external_nullifier: bytes, be: bool,
) -> bytes:
    """Component-wise Multi witness constructor -> witness wire bytes.
    message_ids_vec: vec<Fr>; selector_vec: vec<u8> of 0/1."""
    ids, _ = ser.bytes_to_vec_fr(message_ids_vec, be)
    sel, _ = ser.bytes_to_vec_u8(selector_vec, be)
    elems, _ = ser.bytes_to_vec_fr(path_elements_vec, be)
    idx, _ = ser.bytes_to_vec_u8(path_index_vec, be)
    w = RLNWitnessInput.new_multi(
        _fr_from(secret, be), limit, ids, elems, idx,
        _fr_from(x, be), _fr_from(external_nullifier, be),
        [bool(s) for s in sel],
    )
    return ser.rln_witness_to_bytes(w, be)


def _witness_of(witness_bytes: bytes, be: bool) -> "RLNWitnessInput":
    w, read = ser.bytes_to_rln_witness(witness_bytes, be)
    ser._check_fully_read(read, len(witness_bytes))
    return w


def witness_identity_secret(witness_bytes: bytes, be: bool) -> bytes:
    return _fr_bytes(_witness_of(witness_bytes, be).identity_secret, be)


def witness_user_message_limit(witness_bytes: bytes, be: bool) -> bytes:
    return _fr_bytes(_witness_of(witness_bytes, be).user_message_limit, be)


def witness_message_ids(witness_bytes: bytes, be: bool) -> bytes:
    """Message id(s) as vec<Fr> wire bytes (Single: one entry)."""
    w = _witness_of(witness_bytes, be)
    ids = [w.message_id] if w.is_single else list(w.message_ids)
    return ser.vec_fr_to_bytes(ids, be)


def witness_x(witness_bytes: bytes, be: bool) -> bytes:
    return _fr_bytes(_witness_of(witness_bytes, be).x, be)


def witness_external_nullifier(witness_bytes: bytes, be: bool) -> bytes:
    return _fr_bytes(_witness_of(witness_bytes, be).external_nullifier, be)


def witness_path_elements(witness_bytes: bytes, be: bool) -> bytes:
    return ser.vec_fr_to_bytes(_witness_of(witness_bytes, be).path_elements, be)


def witness_path_index(witness_bytes: bytes, be: bool) -> bytes:
    return ser.vec_u8_to_bytes(
        [int(i) for i in _witness_of(witness_bytes, be).identity_path_index], be
    )


def proof_values_ys(values_bytes: bytes, be: bool) -> bytes:
    """Active y share(s) as vec<Fr> wire bytes (Single: one entry)."""
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    if v.y is not None:
        ys = [v.y]
    else:
        ys = [y for y, used in zip(v.ys, v.selector_used) if used]
    return ser.vec_fr_to_bytes(ys, be)


def proof_values_selectors(values_bytes: bytes, be: bool) -> bytes:
    """selector_used as vec<u8> wire bytes (Single: [1])."""
    v, _ = ser.bytes_to_rln_proof_values(values_bytes, be)
    sel = [1] if v.y is not None else [1 if u else 0 for u in v.selector_used]
    return ser.vec_u8_to_bytes(sel, be)


# -- CFr arithmetic helpers (reference ffi_utils.rs CFr ops) -----------------


def fr_binop(op: str, a: bytes, b: bytes, be: bool) -> bytes:
    from .constants import R as _R

    x, y = _fr_from(a, be), _fr_from(b, be)
    if op == "add":
        r = (x + y) % _R
    elif op == "sub":
        r = (x - y) % _R
    elif op == "mul":
        r = (x * y) % _R
    elif op == "div":
        if y % _R == 0:
            raise ZeroDivisionError("Fr division by zero")
        r = x * pow(y, -1, _R) % _R
    else:
        raise ValueError(f"unknown Fr op {op!r}")
    return _fr_bytes(r, be)


def fr_unop(op: str, a: bytes, be: bool) -> bytes:
    from .constants import R as _R

    x = _fr_from(a, be)
    if op == "neg":
        r = (-x) % _R
    elif op == "inv":
        if x % _R == 0:
            raise ZeroDivisionError("Fr inverse of zero")
        r = pow(x, -1, _R)
    else:
        raise ValueError(f"unknown Fr op {op!r}")
    return _fr_bytes(r, be)


def fr_from_uint64(v: int, be: bool) -> bytes:
    return _fr_bytes(int(v), be)


def fr_random(be: bool) -> bytes:
    """Uniform Fr element (rejection-sampled, matching ark Fr::rand)."""
    import secrets as _secrets

    from .constants import R as _R

    while True:
        v = _secrets.randbits(254)
        if v < _R:
            return _fr_bytes(v, be)
