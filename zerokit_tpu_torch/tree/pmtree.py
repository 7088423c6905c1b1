"""Persistent Poseidon Merkle tree (the reference's sled-backed PmTree analog).

API and semantics follow rln/src/pm_tree_adapter.rs: JSON/builder config with
the same keys and defaults (temporary=true, cache_capacity 1GB,
flush_every_ms 500, HighThroughput mode), load-or-create on open with a
depth check, leaf-occupancy cache rebuilt from storage on load, app metadata
stored under a dedicated key, explicit flush/close, and PmTree's
override_range dispatch (empty delete-index lists allowed; (0,0) is an
error; delete of a never-set index is an error — pmtree behavior).

Storage is a single snapshot file written atomically (tmp+rename) — the
framework-native replacement for the sled embedded DB (the reference's
on-disk format is a sled implementation detail; the durable semantics are
what is ported). The persistent tree IS the checkpoint/resume story, as in
the reference (SURVEY.md §5).

Counterpart of zerokit_tpu/tree/pmtree.py; only the device differs: the
inner OptimalMerkleTree hashes through a hasher on `device` ("cuda" by
default; the constructor raises without a card unless given "cpu"), and
the tree carries `.device` as the port's trees do. The
snapshot and journal formats are the JAX package's, byte for byte, so a
file written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .. import errors
from ..constants import R
from ..ff.field import resolve_device
from .merkle import (
    InvalidDepth,
    InvalidLeaf,
    InvalidLevel,
    MerkleProof,
    MerkleTreeError,
    OptimalMerkleTree,
    PoseidonHasher,
    validate_override_range_inputs,
)

MAGIC = b"zktpu.pmtree.v1\n"
MAGIC_Z = b"zktpu.pmtree.z1\n"  # zlib-compressed body (use_compression=true)
MAGIC_V2 = b"zktpu.pmtree.v2\n"  # v1 + generation stamp
MAGIC_Z2 = b"zktpu.pmtree.x2\n"  # compressed v2 body
JOURNAL_MAGIC = b"zktpu.pmjournal1"  # 16 bytes + <Q generation
_ENTRY_BYTES = 40  # 8-byte index + 32-byte leaf, for the write-buffer bound

DEFAULT_TEMPORARY = True
DEFAULT_CACHE_CAPACITY = 1073741824
DEFAULT_FLUSH_EVERY_MS = 500
DEFAULT_MODE = "HighThroughput"
DEFAULT_USE_COMPRESSION = False


class FromConfigError(MerkleTreeError):
    pass


@dataclass
class PmTreeConfig:
    path: str
    temporary: bool = DEFAULT_TEMPORARY
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    flush_every_ms: int = DEFAULT_FLUSH_EVERY_MS
    mode: str = DEFAULT_MODE
    use_compression: bool = DEFAULT_USE_COMPRESSION
    tree_depth: Optional[int] = None

    @classmethod
    def create(
        cls,
        path: Optional[str] = None,
        temporary: bool = DEFAULT_TEMPORARY,
        cache_capacity: int = DEFAULT_CACHE_CAPACITY,
        flush_every_ms: int = DEFAULT_FLUSH_EVERY_MS,
        mode: str = DEFAULT_MODE,
        use_compression: bool = DEFAULT_USE_COMPRESSION,
        tree_depth: Optional[int] = None,
    ) -> "PmTreeConfig":
        path = cls._resolve_path(temporary, path)
        return cls(
            path=path,
            temporary=temporary,
            cache_capacity=cache_capacity,
            flush_every_ms=flush_every_ms,
            mode=mode,
            use_compression=use_compression,
            tree_depth=tree_depth,
        )

    @staticmethod
    def _resolve_path(temporary: bool, path: Optional[str]) -> str:
        # reference resolve_path (pm_tree_adapter.rs:93-101)
        if path is None:
            if not temporary:
                raise FromConfigError("persistent config requires a path")
            fd, tmp = tempfile.mkstemp(prefix="pmtree-")
            os.close(fd)
            os.unlink(tmp)
            return tmp
        if temporary and os.path.exists(path):
            raise FromConfigError(f"temporary path already exists: {path}")
        return path

    @classmethod
    def from_json(cls, text: str) -> "PmTreeConfig":
        try:
            cfg = json.loads(text) if text.strip() else {}
        except json.JSONDecodeError as e:
            raise FromConfigError(f"invalid config JSON: {e}") from e
        return cls.create(
            path=cfg.get("path"),
            temporary=cfg.get("temporary", DEFAULT_TEMPORARY),
            cache_capacity=cfg.get("cache_capacity", DEFAULT_CACHE_CAPACITY),
            flush_every_ms=cfg.get("flush_every_ms", DEFAULT_FLUSH_EVERY_MS),
            mode="LowSpace" if cfg.get("mode") == "LowSpace" else DEFAULT_MODE,
            use_compression=cfg.get("use_compression", DEFAULT_USE_COMPRESSION),
            tree_depth=cfg.get("tree_depth"),
        )


class PmTree:
    """Persistent tree: in-memory Optimal tree + durable snapshot storage."""

    def __init__(self, depth: int, config: Optional[PmTreeConfig] = None, device="cuda"):
        self.config = config or PmTreeConfig.create()
        if self.config.tree_depth is not None and self.config.tree_depth != depth:
            raise InvalidDepth("config tree_depth disagrees with requested depth")
        self.device = resolve_device(device)
        self._inner = OptimalMerkleTree(depth, device=self.device)
        self._metadata = b""
        self._generation = 0  # bumped on every compaction (snapshot rewrite)
        self._dirty = False
        self._pending: set = set()  # dirty leaf indices awaiting a journal append
        self._meta_dirty = False
        self._last_flush = time.monotonic()
        self._closed = False
        if os.path.exists(self.config.path):
            self._load(depth)
        self._replay_journal()

    # -- storage ------------------------------------------------------------

    def _load(self, depth: int) -> None:
        with open(self.config.path, "rb") as f:
            data = f.read()
        if data.startswith(MAGIC_Z):
            import zlib

            data = MAGIC + zlib.decompress(data[len(MAGIC_Z) :])
        elif data.startswith(MAGIC_Z2):
            import zlib

            data = MAGIC_V2 + zlib.decompress(data[len(MAGIC_Z2) :])
        if data.startswith(MAGIC_V2):
            off = len(MAGIC_V2)
            (self._generation,) = struct.unpack_from("<Q", data, off)
            off += 8
        elif data.startswith(MAGIC):
            off = len(MAGIC)  # legacy v1 snapshot: generation 0
        else:
            raise MerkleTreeError("not a pmtree snapshot file")
        stored_depth, next_index, n_entries, meta_len = struct.unpack_from("<QQQQ", data, off)
        if stored_depth != depth:
            raise InvalidDepth(
                f"stored depth {stored_depth} != requested depth {depth}"
            )
        off += 32
        entries = []
        for _ in range(n_entries):
            (idx,) = struct.unpack_from("<Q", data, off)
            off += 8
            val = int.from_bytes(data[off : off + 32], "little")
            off += 32
            entries.append((idx, val))
        self._metadata = data[off : off + meta_len]
        # rebuild tree + occupancy cache (reference load path rebuilds the
        # occupancy cache from storage, pm_tree_adapter.rs:216-233)
        for idx, val in entries:
            self._inner.set(idx, val)
            self._inner.cached_leaves_indices[idx] = 1 if val != 0 else 0
        self._inner.next_index = next_index

    def flush(self) -> None:
        """Full snapshot + journal truncation (compaction). Incremental
        durability between snapshots goes through the append-only journal
        (_journal_flush) so steady-state I/O is O(delta), not O(tree) —
        sled's log-structured behavior, pm_tree_adapter.rs:184+ semantics."""
        entries = [
            (int(i), self._inner.get(int(i)))
            for i in range(self._inner.next_index)
            if self._inner.cached_leaves_indices[i]
        ]
        # Generation stamp: a crash between os.replace and the journal unlink
        # leaves a stale journal next to the NEW snapshot; the bumped
        # generation makes _replay_journal skip (and delete) it instead of
        # silently reverting post-journal writes (advisor round-3 finding).
        self._generation += 1
        payload = MAGIC_V2 + struct.pack("<Q", self._generation)
        payload += struct.pack(
            "<QQQQ",
            self._inner.depth(),
            self._inner.next_index,
            len(entries),
            len(self._metadata),
        )
        for idx, val in entries:
            payload += struct.pack("<Q", idx) + int(val).to_bytes(32, "little")
        payload += self._metadata
        if self.config.use_compression:
            import zlib

            payload = MAGIC_Z2 + zlib.compress(payload[len(MAGIC_V2) :], 6)
        tmp = self.config.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.config.path)
        self._fsync_dir()
        if os.path.exists(self._journal_path()):
            os.unlink(self._journal_path())
        self._pending.clear()
        self._meta_dirty = False
        self._dirty = False
        self._last_flush = time.monotonic()

    # -- append-only journal (tags: 0 leaf, 1 next_index, 2 metadata) --------

    def _journal_path(self) -> str:
        return self.config.path + ".journal"

    def _fsync_dir(self) -> None:
        """Best-effort fsync of the containing directory (rename durability)."""
        d = os.path.dirname(os.path.abspath(self.config.path)) or "."
        try:
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _journal_flush(self) -> None:
        """Appends the buffered writes: O(delta) bytes, values read at append
        time. Compaction (full snapshot) kicks in once the journal outgrows
        the live entry set."""
        if not (self._pending or self._meta_dirty):
            self._last_flush = time.monotonic()
            return
        fresh = not os.path.exists(self._journal_path())
        with open(self._journal_path(), "ab") as f:
            if fresh:  # stamp which snapshot generation this journal extends
                f.write(JOURNAL_MAGIC + struct.pack("<Q", self._generation))
            for idx in sorted(self._pending):
                val = self._inner.get(int(idx))
                f.write(b"\x00" + struct.pack("<Q", idx) + int(val).to_bytes(32, "little"))
            f.write(b"\x01" + struct.pack("<Q", self._inner.next_index))
            if self._meta_dirty:
                f.write(b"\x02" + struct.pack("<Q", len(self._metadata)) + self._metadata)
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        self._pending.clear()
        self._meta_dirty = False
        self._dirty = False
        self._last_flush = time.monotonic()
        # ndarray.sum() promotes the accumulator; builtin sum() over uint8
        # scalars wraps at 256 and collapses the compaction bound
        live = int(self._inner.cached_leaves_indices[: self._inner.next_index].sum())
        if size > max(1 << 20, 2 * _ENTRY_BYTES * live):
            self.flush()

    def _replay_journal(self) -> None:
        path = self._journal_path()
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        if data.startswith(JOURNAL_MAGIC):
            (gen,) = struct.unpack_from("<Q", data, len(JOURNAL_MAGIC))
            off = len(JOURNAL_MAGIC) + 8
            if gen != self._generation:
                # stale journal from before the last compaction (crash landed
                # between snapshot replace and journal unlink): discard it
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
        try:
            while off < len(data):
                tag = data[off]
                off += 1
                if tag == 0:
                    (idx,) = struct.unpack_from("<Q", data, off)
                    off += 8
                    val = int.from_bytes(data[off : off + 32], "little")
                    off += 32
                    self._inner.set(idx, val)
                    self._inner.cached_leaves_indices[idx] = 1 if val != 0 else 0
                elif tag == 1:
                    (self._inner.next_index,) = struct.unpack_from("<Q", data, off)
                    off += 8
                elif tag == 2:
                    (mlen,) = struct.unpack_from("<Q", data, off)
                    off += 8
                    self._metadata = data[off : off + mlen]
                    off += mlen
                else:
                    break  # corrupt tag: stop at the last good record
        except (struct.error, IndexError):
            pass  # torn tail write: everything before it is applied

    def _maybe_flush(self, entries=None, meta: bool = False) -> None:
        """Durability pressure: journal-append when flush_every_ms has
        elapsed OR the buffered delta exceeds cache_capacity bytes (the role
        sled's page-cache bound plays for its flusher; pm_tree_adapter.rs
        config keys). cache_capacity bounds ACTUAL buffered bytes now —
        flushing is O(buffered delta), never a full-tree rewrite."""
        self._dirty = True
        if entries is not None:
            self._pending.update(int(i) for i in entries)
        if meta:
            self._meta_dirty = True
        if (
            (time.monotonic() - self._last_flush) * 1000.0 >= self.config.flush_every_ms
            or len(self._pending) * _ENTRY_BYTES >= self.config.cache_capacity
        ):
            self._journal_flush()

    def close_db_connection(self) -> None:
        if self._closed:
            return
        if self.config.temporary:
            for p in (self.config.path, self._journal_path()):
                if os.path.exists(p):
                    os.unlink(p)
        elif self._dirty or os.path.exists(self._journal_path()):
            self.flush()  # compacting: snapshot + journal truncation
        self._closed = True

    # -- tree API (delegation + pmtree-specific dispatch) --------------------

    def depth(self) -> int:
        return self._inner.depth()

    def capacity(self) -> int:
        return self._inner.capacity()

    def leaves_set(self) -> int:
        return self._inner.leaves_set()

    def root(self) -> int:
        return self._inner.root()

    def get(self, index: int) -> int:
        return self._inner.get(index)

    def get_subtree_root(self, n: int, index: int) -> int:
        return self._inner.get_subtree_root(n, index)

    def get_empty_leaves_indices(self) -> List[int]:
        return self._inner.get_empty_leaves_indices()

    def set(self, index: int, leaf: int) -> None:
        self._inner.set(index, leaf)
        self._maybe_flush([index])

    def set_range(self, start: int, leaves: Sequence[int]) -> None:
        self._inner.set_range(start, leaves)
        self._maybe_flush(range(start, start + len(leaves)))

    def update_next(self, leaf: int) -> None:
        self._inner.update_next(leaf)
        self._maybe_flush([self._inner.next_index - 1])

    def delete(self, index: int) -> None:
        # pmtree errors on deleting a never-set leaf (unlike Full/Optimal)
        if index >= self._inner.next_index:
            raise InvalidLeaf("cannot delete a leaf that was never set")
        self._inner.delete(index)
        self._maybe_flush([index])

    def override_range(
        self, start: int, leaves: Sequence[int], to_remove_indices: Sequence[int]
    ) -> None:
        """PmTree dispatch (pm_tree_adapter.rs:320-356): empty indices allowed."""
        leaves = list(leaves)
        indices, _, max_index = validate_override_range_inputs(
            start, len(leaves), list(to_remove_indices), self.capacity(), True
        )
        if not leaves and not indices:
            raise InvalidLeaf("override_range with no leaves and no indices")
        if len(leaves) == 1 and not indices:
            return self.set(start, leaves[0])
        if not leaves and len(indices) == 1:
            return self.delete(indices[0])
        if leaves and not indices:
            return self.set_range(start, leaves)
        if not leaves:
            for i in indices:
                self._inner.delete(i)
            self._maybe_flush(indices)
            return
        # combined remove + set, atomic from the caller's view:
        # apply removes below start then write the whole window
        index_set = set(indices)
        min_index = min(indices)
        default = PoseidonHasher.default_leaf()
        window = [default] * (max_index - min_index)
        for i in range(min_index, start):
            if i not in index_set:
                window[i - min_index] = self._inner.get(i)
        for k, leaf in enumerate(leaves):
            window[start - min_index + k] = leaf
        for i in indices:
            self._inner.cached_leaves_indices[i] = 0
        self._inner.set_range(min_index, window)
        for i in indices:
            if i < max_index:
                self._inner.cached_leaves_indices[i] = 0
        self._maybe_flush(list(range(min_index, max_index)) + list(indices))

    def proof(self, index: int) -> MerkleProof:
        return self._inner.proof(index)

    def verify(self, leaf: int, proof: MerkleProof) -> bool:
        if not self._inner.verify(leaf, proof):
            raise errors.ZerokitError("invalid merkle proof")
        return True

    def set_metadata(self, metadata: bytes) -> None:
        self._metadata = bytes(metadata)
        self._maybe_flush(meta=True)

    def metadata(self) -> bytes:
        return self._metadata
