"""The port's Merkle trees against the JAX package's.

DeviceMerkleTree(device="cpu") runs its rebuild on P1's plain version; it
is held against the JAX package's host trees (whose level values the JAX
DeviceMerkleTree holds too, in Montgomery form), and, in a slow test
(as the JAX package's own tests/test_device_tree.py is: its depth-d
rebuild is one XLA program that takes minutes to compile on the CPU),
against the JAX DeviceMerkleTree itself. Full/Optimal trees run one seeded
sequence of every tree operation in both packages. Values compare as
integers, exactly.
"""

import random

import numpy as np
import pytest
import torch

from zerokit_tpu.ff.field import FR as JFR
from zerokit_tpu.tree import merkle as jmerkle
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import FR, from_numpy_limbs, to_numpy_limbs
from zerokit_tpu_torch.hash.keccak import keccak256
from zerokit_tpu_torch.hash.poseidon import poseidon_hash, poseidon_hash_pair
from zerokit_tpu_torch.runtime import native
from zerokit_tpu_torch.tree import merkle
from zerokit_tpu_torch.tree.batched import DeviceMerkleTree

torch.set_num_threads(1)

# rln/tests/protocol.rs:14-87, as in tests/test_tree.py:22-27
EXPECTED_ROOT_DEPTH20 = sum(
    l << (64 * i)
    for i, l in enumerate(
        [4939322235247991215, 5110804094006647505, 4427606543677101242, 910933464535675827]
    )
)


def jax_levels(tree) -> list:
    """A JAX host tree's levels as the JAX DeviceMerkleTree keeps them: root
    level first, (16, 2^level) uint32 Montgomery limb arrays."""
    return [np.asarray(JFR.encode([int(tree._get_node(lv, i)) for i in range(1 << lv)]),
                       dtype=np.uint32) for lv in range(tree.depth() + 1)]


def assert_same_tree(dt: DeviceMerkleTree, jt, indices) -> None:
    assert dt.root() == jt.root()
    for i in indices:
        assert dt.get(i) == jt.get(i)
        proof = jt.proof(i)
        assert dt.proof(i) == (proof.get_path_elements(), proof.get_path_index())
    elems, bits = dt.proofs_batch(indices)
    assert elems == [jt.proof(i).get_path_elements() for i in indices]
    assert bits == [jt.proof(i).get_path_index() for i in indices]


@pytest.mark.parametrize("depth", [4, 5, 6])
def test_device_tree_equals_jax_trees(depth):
    rnd = random.Random(depth)
    dt = DeviceMerkleTree(depth, device="cpu")
    jt = jmerkle.FullMerkleTree(depth)
    assert dt.root() == jt.root()  # the default-leaf cascade
    cap = 1 << depth
    first = [rnd.randrange(R) for _ in range(cap // 2)]
    dt.set_leaves(0, first)
    jt.set_range(0, first)
    assert_same_tree(dt, jt, [0, 1, cap // 2 - 1, cap // 2, cap - 1])
    offset = 3 * cap // 8 + 1
    more = [rnd.randrange(R) for _ in range(cap // 4)]
    dt.set_leaves(offset, more)
    jt.set_range(offset, more)
    assert dt.next_index == offset + len(more)
    mont = [rnd.randrange(R) for _ in range(5)]
    dt.set_leaves_mont(cap - 5, FR.encode(mont))
    jt.set_range(cap - 5, mont)
    indices = sorted(rnd.sample(range(cap), 6))
    assert_same_tree(dt, jt, indices)
    # the carry-over: the JAX tree's state as its device tree keeps it
    levels = jax_levels(jt)
    assert [to_numpy_limbs(lv).tolist() for lv in dt._levels] == [lv.tolist() for lv in levels]
    carried = DeviceMerkleTree.from_levels_numpy(levels, next_index=dt.next_index,
                                                 device="cpu")
    assert_same_tree(carried, jt, indices)
    late = [rnd.randrange(R) for _ in range(3)]
    carried.set_leaves(2, late)
    jt.set_range(2, late)
    assert_same_tree(carried, jt, [1, 2, 4, cap - 1])


def test_device_tree_writes_do_not_alias_the_default_column():
    dt = DeviceMerkleTree(4, device="cpu")
    dt.set_leaves(5, [7])
    jt = jmerkle.OptimalMerkleTree(4)
    jt.set(5, 7)
    assert dt.get(4) == 0 and dt.get(6) == 0 and dt.get(5) == 7
    assert dt.root() == jt.root()
    with pytest.raises(ValueError):
        dt.set_leaves(15, [1, 2])
    with pytest.raises(ValueError):
        bad = jax_levels(jt)[:-1] + [np.zeros((16, 4), np.uint32)]
        DeviceMerkleTree.from_levels_numpy(bad, device="cpu")


def test_device_tree_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMerkleTree(3)


@pytest.mark.slow
@pytest.mark.parametrize("depth", [4, 5, 6])
def test_device_tree_equals_jax_device_tree(depth):
    """The JAX package's DeviceMerkleTree after the same writes: its levels
    equal the port's, integer for integer, and carry over."""
    from zerokit_tpu.tree.batched import DeviceMerkleTree as JaxDeviceTree

    rnd = random.Random(50 + depth)
    cap = 1 << depth
    jt = JaxDeviceTree(depth)
    dt = DeviceMerkleTree(depth, device="cpu")
    leaves = [rnd.randrange(R) for _ in range(cap - 3)]
    jt.set_leaves(2, leaves)
    dt.set_leaves(2, leaves)
    mont = np.asarray(JFR.encode([rnd.randrange(R) for _ in range(4)]))
    jt.set_leaves_mont(1, mont)
    dt.set_leaves_mont(1, from_numpy_limbs(mont, "cpu"))
    levels = [np.asarray(lv) for lv in jt._levels]
    assert [to_numpy_limbs(lv).tolist() for lv in dt._levels] == [lv.tolist() for lv in levels]
    assert dt.root() == jt.root() and dt.get(7) == jt.get(7)
    assert dt.proof(5) == jt.proof(5)
    assert dt.proofs_batch([0, 5, cap - 1]) == jt.proofs_batch([0, 5, cap - 1])
    carried = DeviceMerkleTree.from_levels_numpy(levels, jt.next_index, device="cpu")
    assert carried.root() == jt.root() and carried.next_index == jt.next_index


def run_sequence(mod, cls_name: str, depth: int, seed: int) -> list:
    """One seeded sequence of every tree operation on `mod`'s tree class;
    the list of what each step returned (an exception's class name where
    it raised)."""
    rnd = random.Random(seed)
    kwargs = {"device": "cpu"} if mod is merkle else {}
    tree = getattr(mod, cls_name)(depth, **kwargs)
    cap = 1 << depth
    out = []

    def step(fn, *args):
        try:
            res = fn(*args)
        except mod.MerkleTreeError as exc:
            res = type(exc).__name__
        if hasattr(res, "get_path_elements"):
            res = (res.get_path_elements(), res.get_path_index(), res.leaf_index())
        out.append((fn.__name__, res, tree.root(), tree.leaves_set(),
                    tree.get_empty_leaves_indices()))

    leaf = lambda: rnd.randrange(R)  # noqa: E731
    step(tree.set, 3, leaf())
    step(tree.set_range, 5, [leaf() for _ in range(cap // 2)])
    step(tree.set_range, cap - 1, [leaf(), leaf()])  # beyond capacity
    step(tree.update_next, leaf())
    step(tree.delete, 6)
    step(tree.delete, cap - 1)  # beyond next_index: no-op
    step(tree.override_range, 4, [leaf() for _ in range(3)], [0, 1, 9])
    step(tree.override_range, 0, [leaf()], [])  # empty indices rejected
    step(tree.override_range, 0, [leaf()], [cap + 3])  # out of capacity
    step(tree.override_range, 2, [leaf(), leaf()], [5])  # min index after start
    step(tree.get_subtree_root, 0, 0)
    step(tree.get_subtree_root, depth - 2, 9)
    step(tree.get_subtree_root, depth + 1, 0)
    step(tree.get, cap)
    step(tree.proof, 7)
    for i in (0, 5, cap - 1):
        proof = tree.proof(i)
        step(tree.verify, tree.get(i), proof)
        step(tree.verify, tree.get(i) + 1, proof)
    step(tree.set_metadata, b"meta")
    step(tree.metadata)
    return out


@pytest.mark.parametrize("cls_name", ["FullMerkleTree", "OptimalMerkleTree"])
@pytest.mark.parametrize("depth", [4, 6])
def test_host_trees_equal_jax(cls_name, depth):
    assert run_sequence(merkle, cls_name, depth, 9) == run_sequence(jmerkle, cls_name, depth, 9)


@pytest.mark.parametrize("cls_name", ["FullMerkleTree", "OptimalMerkleTree"])
def test_depth20_golden_root_and_path(cls_name):
    tree = getattr(merkle, cls_name)(20, device="cpu")
    secret = int.from_bytes(keccak256(b"test-merkle-proof"), "little") % R
    rate = poseidon_hash_pair(poseidon_hash([secret]), 100)
    tree.set(3, rate)
    assert tree.root() == EXPECTED_ROOT_DEPTH20
    proof = tree.proof(3)
    assert proof.get_path_index() == [1, 1] + [0] * 18
    elems = proof.get_path_elements()
    assert elems[0] == 0
    assert elems[1] == 0x2098F5FB9E239EAB3CEAC3F27B81E481DC3124D55FFED523A839EE8446B64864
    assert elems[19] == 0x1830EE67B5FB554AD5F63D4388800E1CFE78E310697D46E43C9CE36134F72CCA
    assert tree.verify(rate, proof)
    assert proof.leaf_index() == 3


@pytest.mark.parametrize("pairs", [3, merkle.MIN_PARALLEL_NODES, 21])
def test_hash_pairs_batch_branches_agree(pairs, monkeypatch):
    """Native branch, then, with the native library patched off, the host
    hash (below MIN_PARALLEL_NODES pairs) or the batched kernel's branch on
    the hasher's device; all equal the JAX package's hasher."""
    rnd = random.Random(pairs)
    lefts = [rnd.randrange(R) for _ in range(pairs)]
    rights = [rnd.randrange(R) for _ in range(pairs)]
    want = jmerkle.PoseidonHasher.hash_pairs_batch(lefts, rights)
    hasher = merkle.PoseidonHasher(device="cpu")
    assert hasher.hash_pairs_batch(lefts, rights) == want
    monkeypatch.setattr(native, "_load", lambda: None)
    assert hasher.hash_pairs_batch(lefts, rights) == want
    tree = merkle.FullMerkleTree(5, device="cpu")
    tree.set_range(0, lefts)
    jt = jmerkle.FullMerkleTree(5)
    jt.set_range(0, lefts)
    assert tree.root() == jt.root()


def test_device_branch_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.setattr(native, "_load", lambda: None)
    tree = merkle.OptimalMerkleTree(4)  # builds: the default cascade hashes on the host
    tree.set_range(0, [1, 2])  # 1-pair windows: the host hash
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree.set_range(0, list(range(16)))  # an 8-pair window: the device branch
