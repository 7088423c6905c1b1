"""The port's RLN facade against the JAX package's.

The facade's tree operations run on the port's OptimalMerkleTree and are
held against the JAX package's tree after the same operations; the order
of verify_with_roots' and verify_rln_proof's checks is held against the
JAX facade's with the pairing check replaced by a recorder in both. The
slow test proves, verifies and slashes on the depth-10 circuit through the
facade, on the CPU, and requires the JAX facade's proofs at the same (r, s)
(its prover on its CPU backends, as tests/test_torch_prover.py builds it).
"""

import random

import pytest
import torch

import zerokit_tpu.api as japi
import zerokit_tpu.errors as jerrors
from zerokit_tpu.tree.merkle import OptimalMerkleTree as JaxOptimalTree
from zerokit_tpu_torch import (RLN, RLNPartialWitnessInput, RLNWitnessInput, errors,
                               hash_to_field_le, poseidon_hash, poseidon_hash_pair)
from zerokit_tpu_torch.circuit import witness_host
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.resources import load_resource

torch.set_num_threads(1)

DEPTH10 = {"zkey_bytes": "tree_depth_10/rln_final.arkzkey",
           "graph_bytes": "tree_depth_10/graph.bin"}


def depth10_bytes() -> dict:
    return {k: load_resource(v) for k, v in DEPTH10.items()}


@pytest.fixture(scope="module")
def rln10():
    return RLN.stateful(device="cpu", **depth10_bytes())


def tree_ops(target, rnd: random.Random, facade: bool) -> list:
    """One seeded sequence of the facade's tree operations (reference
    public.rs:292-593), or the same operations on a tree; the list of what
    each returned (an exception's class name where it raised)."""
    leaf = lambda: rnd.randrange(R)  # noqa: E731
    calls = [
        ("set_leaf", "set", (3, leaf())),
        ("get_leaf", "get", (3,)),
        ("set_leaves_from", "set_range", (8, [leaf() for _ in range(20)])),
        ("set_next_leaf", "update_next", (leaf(),)),
        ("delete_leaf", "delete", (9,)),
        ("atomic_operation", "override_range", (10, [leaf(), leaf()], [4, 8])),
        ("atomic_operation", "override_range", (0, [leaf()], [])),
        ("leaves_set", "leaves_set", ()),
        ("get_root", "root", ()),
        ("get_subtree_root", "get_subtree_root", (6, 17)),
        ("get_merkle_proof", "proof", (12,)),
        ("get_empty_leaves_indices", "get_empty_leaves_indices", ()),
        ("set_metadata", "set_metadata", (b"epoch 7",)),
        ("get_metadata", "metadata", ()),
        ("get_leaf", "get", (1 << 10,)),
    ]
    out = []
    for facade_name, tree_name, args in calls:
        try:
            res = getattr(target, facade_name if facade else tree_name)(*args)
        except Exception as exc:  # the class name is the result compared
            res = type(exc).__name__
        if hasattr(res, "get_path_elements"):
            res = (res.get_path_elements(), res.get_path_index())
        out.append(res)
    return out


def test_facade_tree_ops_equal_jax_tree(rln10):
    got = tree_ops(rln10, random.Random(4), facade=True)
    want = tree_ops(JaxOptimalTree(10), random.Random(4), facade=False)
    assert got == want
    assert rln10.tree.device == rln10.device == torch.device("cpu")
    rln10.init_tree_with_leaves([1, 2, 3])
    jt = JaxOptimalTree(10)
    jt.set_range(0, [1, 2, 3])
    assert rln10.get_root() == jt.root() and rln10.leaves_set() == 3
    rln10.flush()
    assert (rln10.tree_depth(), rln10.max_out()) == (10, rln10.graph.max_out)


def test_stateless_has_no_tree_and_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RLN.stateless(**depth10_bytes())
    rln = RLN.stateless(device="cpu", **depth10_bytes())
    with pytest.raises(errors.ZerokitError):
        rln.get_root()


def fake_values(pkg_values_cls, root=11, x=22):
    return pkg_values_cls.new_single(root=root, x=x, external_nullifier=33, y=44, nullifier=55)


@pytest.mark.parametrize("pairing_ok", [True, False])
def test_verify_order_equals_jax(rln10, pairing_ok, monkeypatch):
    """verify_with_roots checks the roots, then x, then the pairing
    (public.rs:937-954); verify_rln_proof the pairing, then the tree's
    root, then x (public.rs:725-745). The pairing is a recorder here."""
    from zerokit_tpu.protocol.proof import RLNProofValues as JaxValues
    from zerokit_tpu_torch.protocol.proof import RLNProofValues

    jrln = japi.RLN.__new__(japi.RLN)
    jrln.tree = JaxOptimalTree(10)
    jrln.tree.set(0, 5)
    rln10.init_tree_with_leaves([5])

    def run(rln, values_cls):
        calls = []

        def pairing(proof, values):
            calls.append(values.root)
            return pairing_ok

        monkeypatch.setattr(rln, "verify", pairing)
        root = rln.get_root()
        good = fake_values(values_cls, root=root)
        out = []
        for fn, args in [
            ("verify_with_roots", (good, 22, [root + 1])),
            ("verify_with_roots", (good, 23, [root])),
            ("verify_with_roots", (good, 22, [root + R])),
            ("verify_with_roots", (good, 22, [])),
            ("verify_rln_proof", (good, 23)),
            ("verify_rln_proof", (fake_values(values_cls, root=root + 1), 22)),
            ("verify_rln_proof", (good, 22 + R)),
        ]:
            try:
                res = getattr(rln, fn)(None, *args)
            except Exception as exc:  # the class name is the result compared
                res = type(exc).__name__
            out.append((fn, res, list(calls)))
            calls.clear()
        return out

    assert run(rln10, RLNProofValues) == run(jrln, JaxValues)
    assert errors.InvalidRoot.__name__ == jerrors.InvalidRoot.__name__


def e2e_witnesses(depth: int):
    """Two signals of one member in one epoch, and a second member."""
    tree = JaxOptimalTree(depth)
    secret = hash_to_field_le(b"double-signaler")
    other = hash_to_field_le(b"second member")
    tree.set(0, poseidon_hash_pair(poseidon_hash([secret]), 5))
    tree.set(1, poseidon_hash_pair(poseidon_hash([other]), 5))
    ext = poseidon_hash_pair(hash_to_field_le(b"ep"), hash_to_field_le(b"app"))
    ws = []
    for index, sec, signal in ((0, secret, b"signal-0"), (0, secret, b"signal-1"),
                               (1, other, b"signal-2")):
        mp = tree.proof(index)
        ws.append(RLNWitnessInput.new_single(sec, 5, 1, mp.get_path_elements(),
                                             mp.get_path_index(), hash_to_field_le(signal),
                                             ext))
    return ws, tree.root(), secret


@pytest.mark.slow
def test_depth10_prove_verify_slash_equals_jax():
    """As tests/test_rln_e2e.py:53 (prove, verify, verify_with_roots, a
    tampered value, slashing), on the port's facade at depth 10 on the
    CPU; every proof equals the JAX facade's at the same (r, s), the
    externally computed witness and the partial + finish proof included."""
    import dataclasses

    from test_torch_prover import jax_prover_for

    rln = RLN.stateless(device="cpu", **depth10_bytes())
    jrln = japi.RLN.__new__(japi.RLN)
    jrln.zkey, jrln.graph, jrln.tree = rln.zkey, rln.graph, None
    jrln.prover = jax_prover_for(rln.zkey, rln.prover.num_inputs, rln.prover.n_wires, rln.graph)
    jrln.pvk = japi.prepare_verifying_key(rln.zkey.pk.vk)

    ws, root, secret = e2e_witnesses(rln.tree_depth())
    rs, ss = [1, 2, 123456789], [3, 4, 987654321]
    out = rln.generate_proofs(ws, rs=rs, ss=ss)
    want = jrln.generate_proofs(ws, rs=rs, ss=ss)
    assert [p for p, _ in out] == [p for p, _ in want]
    for proof, values in out:
        assert rln.verify(proof, values)
        assert rln.verify_with_roots(proof, values, values.x, [root])
    assert rln.verify_batch([p for p, _ in out], [v for _, v in out])
    bad = dataclasses.replace(out[0][1], root=(root + 1) % R)
    assert not rln.verify(out[0][0], bad)
    assert RLN.recover_id_secret(out[0][1], out[1][1]) == secret

    calculated = witness_host.calc_witness(ws[2].named_inputs(), rln.graph)
    ext_proof, ext_values = rln.generate_proof_with_witness(calculated, ws[2], r=rs[2], s=ss[2])
    assert ext_proof == out[2][0] and ext_values == proof_values_from_witness(ws[2])

    partial = rln.generate_partial_proof(RLNPartialWitnessInput.from_witness(ws[2]))
    finished, _ = rln.finish_proof(partial, ws[2], r=rs[2], s=ss[2])
    assert finished == out[2][0]
