"""The port's protocol layer against the JAX package's, on tests/test_protocol.py's cases.

Each case runs once on the port's modules and once on the JAX package's;
the two results (values as integers, dataclasses as tuples, exceptions as
their class names) must be equal. Golden vectors of the reference pin the
port's results besides. The port's protocol modules are verbatim copies
(tests/test_torch_import.py); these cases check that they run on the
port's own Poseidon, trees and prover.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import zerokit_tpu.errors as j_errors
import zerokit_tpu.hash.poseidon as j_poseidon
import zerokit_tpu.protocol.identity as j_identity
import zerokit_tpu.protocol.keygen as j_keygen
import zerokit_tpu.protocol.proof as j_proof
import zerokit_tpu.protocol.slashing as j_slashing
import zerokit_tpu.protocol.witness as j_witness
import zerokit_tpu.tree.merkle as j_merkle
import zerokit_tpu_torch.errors as t_errors
import zerokit_tpu_torch.hash.poseidon as t_poseidon
import zerokit_tpu_torch.protocol.identity as t_identity
import zerokit_tpu_torch.protocol.keygen as t_keygen
import zerokit_tpu_torch.protocol.proof as t_proof
import zerokit_tpu_torch.protocol.slashing as t_slashing
import zerokit_tpu_torch.protocol.witness as t_witness
import zerokit_tpu_torch.tree.merkle as t_merkle
from zerokit_tpu_torch.constants import R

torch.set_num_threads(1)

# rln/tests/protocol.rs:39-47, as in tests/test_tree.py:22
EXPECTED_ROOT_DEPTH20 = sum(
    l << (64 * i)
    for i, l in enumerate(
        [4939322235247991215, 5110804094006647505, 4427606543677101242, 910933464535675827]
    )
)

PORT = types.SimpleNamespace(errors=t_errors, poseidon=t_poseidon, identity=t_identity,
                             keygen=t_keygen, proof=t_proof, slashing=t_slashing,
                             witness=t_witness, merkle=t_merkle, tree_kwargs={"device": "cpu"})
JAX = types.SimpleNamespace(errors=j_errors, poseidon=j_poseidon, identity=j_identity,
                            keygen=j_keygen, proof=j_proof, slashing=j_slashing,
                            witness=j_witness, merkle=j_merkle, tree_kwargs={})


def plain(x):
    """A result both packages can be compared by: dataclasses as tuples,
    secrets as ints, containers element by element."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, plain(dataclasses.astuple(x)))
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if type(x).__name__ == "IdSecret":
        return ("IdSecret", x.to_int())
    return x


def raised(fn, *args):
    try:
        return plain(fn(*args))
    except Exception as exc:  # the class name is the result compared
        return type(exc).__name__


def witness(m, multi=False, signal=b"hey hey", ext=None):
    """tests/test_protocol.py:34's witness: a depth-20 tree with one member."""
    kg = m.keygen
    secret = kg.hash_to_field_le(b"test-secret")
    tree = m.merkle.OptimalMerkleTree(20, **m.tree_kwargs)
    tree.set(3, m.poseidon.poseidon_hash_pair(m.poseidon.poseidon_hash([secret]), 100))
    proof = tree.proof(3)
    x = kg.hash_to_field_le(signal)
    if ext is None:
        ext = m.poseidon.poseidon_hash_pair(kg.hash_to_field_le(b"test-epoch"),
                                            kg.hash_to_field_le(b"test-rln-identifier"))
    if multi:
        return m.witness.RLNWitnessInput.new_multi(
            secret, 100, [1, 2, 0, 0], proof.get_path_elements(), proof.get_path_index(),
            x, ext, [True, True, False, False]), tree.root()
    return m.witness.RLNWitnessInput.new_single(
        secret, 100, 1, proof.get_path_elements(), proof.get_path_index(), x, ext), tree.root()


def case_seeded_keygen(m):
    kg = m.keygen
    return [kg.seeded_keygen(b"A seed phrase example"), kg.seeded_keygen(bytes(range(10))),
            kg.extended_seeded_keygen(b"test-seed-extended")]


def case_keygen_relations(m):
    kg = m.keygen
    secret, commitment = kg.keygen()
    t, n, s, c = kg.extended_keygen()
    hp = m.poseidon
    return [commitment == hp.poseidon_hash([int(secret)]), s == hp.poseidon_hash_pair(t, n),
            c == hp.poseidon_hash([int(s)])]


def case_hash_to_field(m):
    kg = m.keygen
    return [(kg.hash_to_field_le(s), kg.hash_to_field_be(s)) for s in (b"abc", b"", b"x" * 200)]


def case_witness_errors(m):
    w, _ = witness(m)
    new_single = m.witness.RLNWitnessInput.new_single
    new_multi = m.witness.RLNWitnessInput.new_multi
    pe, pi = w.path_elements, w.identity_path_index
    return [
        raised(new_single, 1, 0, 0, pe, pi, 1, 1),
        raised(new_single, 1, 10, 10, pe, pi, 1, 1),
        raised(new_single, 1, 10, 1, [1, 2], [0], 1, 1),
        raised(new_multi, 1, 10, [], pe, pi, 1, 1, []),
        raised(new_multi, 1, 10, [1], pe, pi, 1, 1, [False]),
        raised(new_multi, 1, 10, [1, 1], pe, pi, 1, 1, [True, True]),
    ]


def case_proof_values_single(m):
    w, root = witness(m)
    return [m.proof.proof_values_from_witness(w), root, w.named_inputs()]


def case_proof_values_multi(m):
    w, root = witness(m, multi=True)
    return [m.proof.proof_values_from_witness(w), root, w.named_inputs()]


def case_slashing(m):
    w1, _ = witness(m)
    w2, _ = witness(m, signal=b"another signal")
    w3, _ = witness(m, ext=999)
    wm1, _ = witness(m, multi=True)
    wm2, _ = witness(m, multi=True, signal=b"zzz")
    pv = m.proof.proof_values_from_witness
    sl = m.slashing
    return [
        sl.recover_id_secret(pv(w1), pv(w2)), sl.recover_secret(pv(w1), pv(w2)),
        sl.recover_id_secret(pv(wm1), pv(wm2)),
        raised(sl.recover_id_secret, pv(w1), pv(w3)),
        raised(sl.compute_id_secret, (5, 7), (5, 9)),
    ]


def case_compute_tree_root(m):
    kg = m.keygen
    secret = kg.hash_to_field_le(b"test-merkle-proof")
    tree = m.merkle.OptimalMerkleTree(20, **m.tree_kwargs)
    tree.set(3, m.poseidon.poseidon_hash_pair(m.poseidon.poseidon_hash([secret]), 100))
    proof = tree.proof(3)
    root = m.witness.compute_tree_root(secret, 100, proof.get_path_elements(),
                                       proof.get_path_index())
    return [root, tree.root()]


def case_id_secret_zeroize(m):
    s = m.identity.IdSecret(12345)
    out = [int(s), s == 12345, s % R, s.to_bytes_le(), s.to_bytes_be(),
           m.identity.IdSecret.from_bytes_le(s.to_bytes_le()) == s, "12345" in repr(s)]
    s.zeroize()
    out.append(int(s))
    w, _ = witness(m)
    w.zeroize()
    out.append(w.identity_secret)
    return out


CASES = {f.__name__[5:]: f for f in (
    case_seeded_keygen, case_keygen_relations, case_hash_to_field, case_witness_errors,
    case_proof_values_single, case_proof_values_multi, case_slashing,
    case_compute_tree_root, case_id_secret_zeroize,
)}


@pytest.mark.parametrize("case", CASES)
def test_port_equals_jax(case):
    assert plain(CASES[case](PORT)) == plain(CASES[case](JAX))


def test_golden_vectors():
    """rln/tests/protocol.rs:461-507 (seeded keygen), the depth-20 root of
    :39-47 (compute_tree_root), as in tests/test_protocol.py:54,206."""
    secret, commitment = t_keygen.seeded_keygen(b"A seed phrase example")
    assert secret == 0x20DF38F3F00496F19FE7C6535492543B21798ED7CB91AEBE4AF8012DB884EDA3
    assert commitment == 0x1223A78A5D66043A7F9863E14507DC80720A5602B2A894923E5B5147D5A9C325
    secret2, commitment2 = t_keygen.seeded_keygen(bytes(range(10)))
    assert secret2 == 0x766CE6C7E7A01BDF5B3F257616F603918C30946FA23480F2859C597817E6716
    assert commitment2 == 0xBF16D2B5C0D6F9D9D561E05BFCA16A81B4B873BB063508FAE360D8C74CEF51F
    root, tree_root = case_compute_tree_root(PORT)
    assert root == tree_root == EXPECTED_ROOT_DEPTH20
    w, _ = witness(PORT)
    v = t_proof.proof_values_from_witness(w)
    a1 = t_poseidon.poseidon_hash([w.identity_secret, w.external_nullifier, w.message_id])
    assert v.y == (w.identity_secret + w.x * a1) % R
    assert v.nullifier == t_poseidon.poseidon_hash([a1])


def test_witness_pipeline_zeroizes_secret_buffers(monkeypatch):
    """tests/test_protocol.py:236 on the port: the host interpreter scrubs
    its input buffer, the device evaluator's path scrubs the host input
    buffer after the copy, and an IdSecret is accepted end to end."""
    from zerokit_tpu_torch.circuit import witness_host
    from zerokit_tpu_torch.circuit.graph import graph_from_bytes
    from zerokit_tpu_torch.circuit.zkey import zkey_from_bytes
    from zerokit_tpu_torch.groth16.prover import Groth16Prover
    from zerokit_tpu_torch.resources import load_resource

    graph = graph_from_bytes(load_resource("tree_depth_10/graph.bin"), 10, None)
    secret = t_identity.IdSecret(t_keygen.hash_to_field_le(b"zeroize-secret"))
    tree = t_merkle.OptimalMerkleTree(10, device="cpu")
    tree.set(0, t_poseidon.poseidon_hash_pair(t_poseidon.poseidon_hash([secret.to_int()]), 5))
    mp = tree.proof(0)
    w = t_witness.RLNWitnessInput.new_single(
        secret, 5, 1, mp.get_path_elements(), mp.get_path_index(),
        t_keygen.hash_to_field_le(b"x"), t_keygen.hash_to_field_le(b"e"))
    assert w.identity_secret == secret.to_int()

    captured = {}
    orig_populate = witness_host._populate

    def capture_populate(inputs, mapping, buffer):
        orig_populate(inputs, mapping, buffer)
        captured["buf"] = buffer

    monkeypatch.setattr(witness_host, "_populate", capture_populate)
    witness_host.calc_witness(w.named_inputs(), graph)
    assert all(v == 0 for v in captured["buf"]), "host input buffer not scrubbed"

    zkey = zkey_from_bytes(load_resource("tree_depth_10/rln_final.arkzkey"))
    prover = Groth16Prover(zkey, graph, device="cpu")
    assert prover.evaluator is not None
    bufs = []
    orig_build = prover.evaluator.build_input_buffer

    def capture_build(named, batch):
        buf = orig_build(named, batch)
        bufs.append(buf)
        return buf

    monkeypatch.setattr(prover.evaluator, "build_input_buffer", capture_build)
    named = {k: [[v] for v in vals] for k, vals in w.named_inputs().items()}
    prover.full_assignments(named, 1)
    assert bufs and all(np.all(b == 0) for b in bufs), "device input buffer not scrubbed"

    w.zeroize()
    assert w.identity_secret == 0
    secret.zeroize()
    assert secret.to_int() == 0
