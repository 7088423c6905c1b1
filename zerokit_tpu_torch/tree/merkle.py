"""Incremental Poseidon Merkle trees with the full zerokit tree API.

API parity with the reference's `ZerokitMerkleTree`/`ZerokitMerkleProof`
traits (utils/src/merkle_tree/merkle_tree.rs:22-99) and its two in-memory
implementations:

  * FullMerkleTree  — dense array of all 2^(d+1)-1 nodes
    (utils/src/merkle_tree/full_merkle_tree.rs)
  * OptimalMerkleTree — sparse {(level, index): value} map with cached
    default-node column (utils/src/merkle_tree/optimal_merkle_tree.rs)

Semantics matched exactly: next_index bookkeeping, cached empty-leaf indices,
override_range validation (utils/src/merkle_tree/override_range_validation.rs
— Full/Optimal reject empty delete-index lists), subtree roots addressed by
(level-from-root, leaf index), proof orientation (path bit 0 = node is left
child), and depth < 64 bound.

Counterpart of zerokit_tpu/tree/merkle.py; only the batch hook differs.
Values are canonical Python ints at this layer (state layer, not the hot
path). The level-wise rehash hashes all parent pairs of an update window
in one batch: the native host library when it loads, else one launch of
the Poseidon kernel P1 on the tree's device (device="cuda" by default) when
the window is at least MIN_PARALLEL_NODES pairs (the same threshold the
reference uses to go parallel with rayon, merkle_tree.rs:18), and the host
hash below it. The fully device-resident tree for bulk workloads lives in
tree/batched.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..ff.field import FR, resolve_device
from ..hash.poseidon import poseidon_hash_pair, poseidon_hash_pair_mont

MIN_PARALLEL_NODES = 8


class MerkleTreeError(ValueError):
    pass


class InvalidDepth(MerkleTreeError):
    pass


class InvalidLeaf(MerkleTreeError):
    pass


class InvalidIndex(MerkleTreeError):
    pass


class InvalidLevel(MerkleTreeError):
    pass


class TooManySet(MerkleTreeError):
    pass


class InvalidIndices(MerkleTreeError):
    pass


class InvalidMerkleProof(MerkleTreeError):
    pass


class PoseidonHasher:
    """The zerokit RLN Merkle hasher (reference: rln/src/hashers.rs:56-70).
    An instance carries the device of its batched branch."""

    def __init__(self, device="cuda"):
        self.device = device

    @staticmethod
    def default_leaf() -> int:
        return 0

    @staticmethod
    def hash_pair(left: int, right: int) -> int:
        return poseidon_hash_pair(left, right)

    def hash_pairs_batch(self, lefts: Sequence[int], rights: Sequence[int]) -> List[int]:
        """Batched pair hashing: native C runtime when built, else the
        batched device kernel on the hasher's device for ranges of at least
        MIN_PARALLEL_NODES pairs (the reference's rayon threshold,
        merkle_tree.rs:18), the host hash below it. The device branch
        raises when the device is a card that is not there."""
        from ..runtime import native

        if native.available():
            out = native.poseidon_hash_pairs_native(list(lefts), list(rights))
            if out is not None:
                return out
        if len(lefts) < MIN_PARALLEL_NODES:
            return [poseidon_hash_pair(l, r) for l, r in zip(lefts, rights)]
        dev = resolve_device(self.device)
        out = poseidon_hash_pair_mont(
            FR.encode(list(lefts)).to(dev), FR.encode(list(rights)).to(dev)
        )
        return [int(v) for v in FR.decode(out)]


class MerkleProof:
    """Bottom-up membership proof: [(sibling, path_bit)], bit 0 = node is left."""

    def __init__(self, elements: List[int], path_bits: List[int]):
        self.elements = elements
        self.path_bits = path_bits

    def length(self) -> int:
        return len(self.elements)

    def leaf_index(self) -> int:
        idx = 0
        for bit in reversed(self.path_bits):
            idx = (idx << 1) + int(bit)
        return idx

    def get_path_elements(self) -> List[int]:
        return list(self.elements)

    def get_path_index(self) -> List[int]:
        return list(self.path_bits)

    def compute_root_from(self, leaf: int, hasher=PoseidonHasher) -> int:
        acc = leaf
        for sibling, bit in zip(self.elements, self.path_bits):
            acc = hasher.hash_pair(acc, sibling) if bit == 0 else hasher.hash_pair(sibling, acc)
        return acc


def validate_override_range_inputs(
    start: int,
    leaves_len: int,
    indices: Sequence[int],
    capacity: int,
    allow_empty_indices: bool,
) -> Tuple[List[int], Optional[int], Optional[int]]:
    """Normalizes override_range inputs; mirrors override_range_validation.rs:20-65.

    Returns (sorted deduped indices, min_index, max_index).
    """
    if not allow_empty_indices and len(indices) == 0:
        raise InvalidIndices("empty delete-indices list")
    if any(i >= capacity for i in indices):
        raise InvalidIndices("delete index out of capacity")
    norm = sorted(set(indices))
    min_index = norm[0] if norm else None
    if leaves_len == 0:
        max_index = None
    else:
        end = start + leaves_len
        if end > capacity:
            raise TooManySet("override_range beyond capacity")
        max_index = end
    if min_index is not None and max_index is not None:
        if min_index > start or min_index >= max_index:
            raise InvalidIndices("delete indices must start at or before the write window")
    return norm, min_index, max_index


class _TreeBase:
    """Shared logic for both tree implementations."""

    ALLOW_EMPTY_OVERRIDE_INDICES = False

    def __init__(self, depth: int, default_leaf: int = 0, hasher=None, device="cuda"):
        """hasher: PoseidonHasher(device) unless given."""
        if depth >= 64:
            raise InvalidDepth(f"depth {depth} out of range")
        hasher = PoseidonHasher(device) if hasher is None else hasher
        self.hasher = hasher
        self.device = device
        self._depth = depth
        # default node per level, level d = leaves ... level 0 = root
        cascade = [default_leaf]
        for _ in range(depth):
            cascade.append(hasher.hash_pair(cascade[-1], cascade[-1]))
        self.default_nodes = list(reversed(cascade))  # [root_default, ..., leaf_default]
        self.cached_leaves_indices = np.zeros(1 << depth, dtype=np.uint8)
        self.next_index = 0
        self._metadata = b""

    # -- storage interface (implemented by subclasses) ----------------------

    def _get_node(self, level: int, index: int) -> int:
        raise NotImplementedError

    def _set_nodes(self, level: int, start: int, values: Sequence[int]) -> None:
        raise NotImplementedError

    # -- shared API ---------------------------------------------------------

    def depth(self) -> int:
        return self._depth

    def capacity(self) -> int:
        return 1 << self._depth

    def leaves_set(self) -> int:
        return self.next_index

    def root(self) -> int:
        return self._get_node(0, 0)

    def get(self, index: int) -> int:
        if index >= self.capacity():
            raise InvalidLeaf(f"leaf index {index} out of range")
        return self._get_node(self._depth, index)

    def get_subtree_root(self, n: int, index: int) -> int:
        if n > self._depth:
            raise InvalidLevel(f"level {n} deeper than tree")
        if index >= self.capacity():
            raise InvalidLeaf(f"leaf index {index} out of range")
        if n == 0:
            return self.root()
        return self._get_node(n, index >> (self._depth - n))

    def get_empty_leaves_indices(self) -> List[int]:
        view = self.cached_leaves_indices[: self.next_index]
        return [int(i) for i in np.nonzero(view == 0)[0]]

    def set(self, index: int, leaf: int) -> None:
        if index >= self.capacity():
            raise InvalidLeaf(f"leaf index {index} out of range")
        self._write_leaves(index, [leaf])
        self.cached_leaves_indices[index] = 1
        self.next_index = max(self.next_index, index + 1)

    def set_range(self, start: int, leaves: Sequence[int]) -> None:
        leaves = list(leaves)
        end = start + len(leaves)
        if end > self.capacity():
            raise TooManySet("set_range beyond capacity")
        if not leaves:
            return
        self._write_leaves(start, leaves)
        self.cached_leaves_indices[start:end] = 1
        self.next_index = max(self.next_index, end)

    def override_range(
        self, start: int, leaves: Sequence[int], to_remove_indices: Sequence[int]
    ) -> None:
        leaves = list(leaves)
        indices, min_index, max_index = validate_override_range_inputs(
            start,
            len(leaves),
            list(to_remove_indices),
            self.capacity(),
            self.ALLOW_EMPTY_OVERRIDE_INDICES,
        )
        if min_index is None and max_index is None:
            return
        if min_index is None:
            min_index = start
        if max_index is None:
            max_index = start
        if min_index >= max_index and not self.ALLOW_EMPTY_OVERRIDE_INDICES:
            raise InvalidIndices("empty override window")
        default = self.hasher.default_leaf()
        index_set = set(indices)
        window = [default] * (max_index - min_index)
        for i in range(min_index, start):
            if i not in index_set:
                window[i - min_index] = self.get(i)
        for k, leaf in enumerate(leaves):
            window[start - min_index + k] = leaf
        for i in indices:
            self.cached_leaves_indices[i] = 0
        self.set_range(min_index, window)
        # set_range marked the whole window set; re-clear removed indices
        for i in indices:
            if i < max_index:
                self.cached_leaves_indices[i] = 0

    def update_next(self, leaf: int) -> None:
        self.set(self.next_index, leaf)

    def delete(self, index: int) -> None:
        if index < self.next_index:
            self.set(index, self.hasher.default_leaf())
            self.cached_leaves_indices[index] = 0

    def proof(self, index: int) -> MerkleProof:
        if index >= self.capacity():
            raise InvalidLeaf(f"leaf index {index} out of range")
        elements: List[int] = []
        bits: List[int] = []
        i = index
        for level in range(self._depth, 0, -1):
            sibling = i ^ 1
            elements.append(self._get_node(level, sibling))
            bits.append(i & 1)
            i >>= 1
        return MerkleProof(elements, bits)

    def verify(self, leaf: int, proof: MerkleProof) -> bool:
        if proof.length() != self._depth:
            raise InvalidMerkleProof(
                f"proof length {proof.length()} != depth {self._depth}"
            )
        return proof.compute_root_from(leaf, self.hasher) == self.root()

    def set_metadata(self, metadata: bytes) -> None:
        self._metadata = bytes(metadata)

    def metadata(self) -> bytes:
        return self._metadata

    def close_db_connection(self) -> None:
        pass

    # -- hashing ------------------------------------------------------------

    def _write_leaves(self, start: int, leaves: Sequence[int]) -> None:
        self._set_nodes(self._depth, start, leaves)
        lo, hi = start, start + len(leaves) - 1
        for level in range(self._depth, 0, -1):
            parent_lo, parent_hi = lo >> 1, hi >> 1
            lefts = [self._get_node(level, p * 2) for p in range(parent_lo, parent_hi + 1)]
            rights = [self._get_node(level, p * 2 + 1) for p in range(parent_lo, parent_hi + 1)]
            hashed = self.hasher.hash_pairs_batch(lefts, rights)
            self._set_nodes(level - 1, parent_lo, hashed)
            lo, hi = parent_lo, parent_hi


class FullMerkleTree(_TreeBase):
    """Dense tree: every node materialized (reference full_merkle_tree.rs)."""

    def __init__(self, depth: int, default_leaf: int = 0, hasher=None, device="cuda"):
        super().__init__(depth, default_leaf, hasher, device)
        self._levels: List[np.ndarray] = []
        for level in range(depth + 1):
            arr = np.empty(1 << level, dtype=object)
            arr[:] = self.default_nodes[level]
            self._levels.append(arr)

    def _get_node(self, level: int, index: int) -> int:
        return int(self._levels[level][index])

    def _set_nodes(self, level: int, start: int, values: Sequence[int]) -> None:
        self._levels[level][start : start + len(values)] = list(values)


class OptimalMerkleTree(_TreeBase):
    """Sparse tree: only touched nodes stored (reference optimal_merkle_tree.rs)."""

    def __init__(self, depth: int, default_leaf: int = 0, hasher=None, device="cuda"):
        super().__init__(depth, default_leaf, hasher, device)
        self._nodes: Dict[Tuple[int, int], int] = {}

    def _get_node(self, level: int, index: int) -> int:
        return self._nodes.get((level, index), self.default_nodes[level])

    def _set_nodes(self, level: int, start: int, values: Sequence[int]) -> None:
        for k, v in enumerate(values):
            self._nodes[(level, start + k)] = int(v)
