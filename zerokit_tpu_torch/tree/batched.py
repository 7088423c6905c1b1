"""Device-resident batched Poseidon Merkle tree.

Counterpart of zerokit_tpu/tree/batched.py. The host trees (tree/merkle.py)
carry the incremental zerokit API; this tree keeps every level on the card
as Montgomery limb tensors (16, 2^level) int32 and recomputes whole levels
with the Poseidon kernel P1 — the bulk path for workloads like "insert 2^20
leaves and recompute root/paths" (BASELINE.md batched-tree target).
Bit-compatible with the host trees (same hash, same default-leaf cascade);
parity-tested against them and against the JAX package's device tree.

A rebuild is one P1 launch a level, each reading the level below in place
as its own lefts and rights (strided views, no copy), with no host
synchronisation between levels. Like the reference, every write rebuilds
every level from the whole leaf level (2^depth - 1 hashes).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..constants import NUM_LIMBS
from ..ff.field import FR, FrField, encode_canonical_fast, from_numpy_limbs, resolve_device
from ..hash.poseidon import poseidon_hash, poseidon_hash_pair_mont


@functools.lru_cache(maxsize=None)
def _default_nodes(depth: int):
    """Default node value per level (leaf level = depth ... root = 0)."""
    cascade = [0]
    for _ in range(depth):
        cascade.append(poseidon_hash_pair_host(cascade[-1], cascade[-1]))
    return list(reversed(cascade))


def poseidon_hash_pair_host(a: int, b: int) -> int:
    return poseidon_hash([a, b])


def recompute_levels(leaves: torch.Tensor) -> List[torch.Tensor]:
    """(16, 2^depth) Montgomery leaves -> [root_level, ..., leaf_level]."""
    levels = [leaves]
    cur = leaves
    while cur.shape[1] > 1:
        cur = poseidon_hash_pair_mont(cur[:, 0::2], cur[:, 1::2])
        levels.append(cur)
    return levels[::-1]


class DeviceMerkleTree:
    """Dense on-device tree; leaves and internal nodes in Montgomery form."""

    def __init__(self, depth: int, device="cuda"):
        self.depth = depth
        self.device = resolve_device(device)
        defaults = _default_nodes(depth)
        self._levels: List[torch.Tensor] = []
        for level in range(depth + 1):
            const = FR.encode([defaults[level]]).to(self.device)  # (16, 1)
            # a view of one column until set_leaves writes the leaf level
            self._levels.append(const.expand(NUM_LIMBS, 1 << level))
        self.next_index = 0

    @classmethod
    def from_levels_numpy(cls, levels: Sequence[np.ndarray], next_index: int = 0,
                          device="cuda") -> "DeviceMerkleTree":
        """The tree whose levels hold these integers: `levels` as the JAX
        package's DeviceMerkleTree keeps them (its _levels as numpy arrays,
        root level first, (16, 2^level) uint32 Montgomery limbs)."""
        tree = cls.__new__(cls)
        tree.depth = len(levels) - 1
        tree.device = resolve_device(device)
        tree._levels = [from_numpy_limbs(np.asarray(lv), tree.device) for lv in levels]
        for level, lv in enumerate(tree._levels):
            if tuple(lv.shape) != (NUM_LIMBS, 1 << level):
                raise ValueError(f"level {level}: shape {tuple(lv.shape)}")
        tree.next_index = next_index
        return tree

    def capacity(self) -> int:
        return 1 << self.depth

    def set_leaves(self, start: int, leaves: Sequence[int]) -> None:
        """Writes a contiguous leaf range and recomputes all ancestors."""
        if start + len(leaves) > self.capacity():
            raise ValueError("set_leaves beyond capacity")
        canon = encode_canonical_fast(list(leaves)).to(self.device)
        self.set_leaves_mont(start, FrField.to_mont(canon))

    def set_leaves_mont(self, start: int, mont: torch.Tensor) -> None:
        """Device-side variant: mont is (16, k) Montgomery limbs."""
        k = mont.shape[1]
        if start + k > self.capacity():
            raise ValueError("set_leaves beyond capacity")
        leaves = self._levels[self.depth]
        if leaves.stride(1) == 0:  # still the default column's view
            leaves = leaves.contiguous()
        leaves[:, start : start + k] = mont.to(self.device)
        self._levels = recompute_levels(leaves)
        self.next_index = max(self.next_index, start + k)

    def root(self) -> int:
        return int(FR.decode(self._levels[0])[0])

    def get(self, index: int) -> int:
        leaf = self._levels[self.depth][:, index : index + 1]
        return int(FR.decode(leaf)[0])

    def proof(self, index: int):
        """Returns (path_elements, path_bits) as host ints, leaf to root."""
        elements, bits = self.proofs_batch([index])
        return elements[0], bits[0]

    def proofs_batch(self, indices: Sequence[int]):
        """Gathers membership proofs for many leaves: one index_select a
        level on the device, one copy to the host at the end."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.device)
        sibs = []
        i = idx
        for level in range(self.depth, 0, -1):
            sibs.append(self._levels[level].index_select(1, i ^ 1))  # (16, K)
            i = i >> 1
        vals = FR.decode(torch.stack(sibs, dim=1))  # (depth, K) host ints
        elems = [[int(vals[lvl, k]) for lvl in range(self.depth)] for k in range(len(idx))]
        bits = [[(int(indices[k]) >> lvl) & 1 for lvl in range(self.depth)]
                for k in range(len(idx))]
        return elems, bits
