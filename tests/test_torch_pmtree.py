"""The port's persistent tree (zerokit_tpu_torch/tree/pmtree.py) against
tests/test_pmtree.py's cases and the JAX package's tree.

tests/test_pmtree.py's cases run on the port's PmTree on the CPU (config
parsing, persistence and reload with the occupancy cache, metadata,
temporary cleanup, depth checks, override_range dispatch, the journal).
Then: the facade's init_tree_with_leaves over a PmTree; the device rule;
and the storage formats across packages: the same writes give the same
snapshot and journal bytes in both packages, and a file written by either
package loads in the other with the same root.
"""

import os

import pytest
import torch

import zerokit_tpu.tree.pmtree as j_pmtree
import zerokit_tpu_torch.tree.pmtree as t_pmtree
from zerokit_tpu.tree.merkle import OptimalMerkleTree as JaxOptimalTree
from zerokit_tpu_torch.tree.merkle import InvalidDepth, InvalidLeaf, OptimalMerkleTree
from zerokit_tpu_torch.tree.pmtree import FromConfigError, PmTree, PmTreeConfig

torch.set_num_threads(1)


def _cfg(tmp_path, name="tree.db", extra=""):
    path = os.path.join(str(tmp_path), name)
    return PmTreeConfig.from_json(
        '{"path": "%s", "temporary": false, "flush_every_ms": 0%s}' % (path, extra)
    )


def test_config_defaults_and_json(tmp_path):
    cfg = PmTreeConfig.from_json("{}")
    assert cfg.temporary is True
    assert cfg.cache_capacity == 1073741824
    assert cfg.flush_every_ms == 500
    assert cfg.mode == "HighThroughput"
    assert cfg.use_compression is False
    cfg2 = _cfg(tmp_path, extra=', "mode": "LowSpace", "cache_capacity": 7')
    assert cfg2.mode == "LowSpace"
    assert cfg2.cache_capacity == 7
    with pytest.raises(FromConfigError):
        PmTreeConfig.create(path=None, temporary=False)


def test_persistence_reload_and_occupancy(tmp_path):
    cfg = _cfg(tmp_path)
    t = PmTree(4, cfg, device="cpu")
    t.set_range(0, [11, 22, 33])
    t.delete(1)
    t.set_metadata(b"app metadata")
    root = t.root()
    t.flush()
    t.close_db_connection()

    t2 = PmTree(4, _cfg(tmp_path), device="cpu")
    assert t2.root() == root
    assert t2.metadata() == b"app metadata"
    assert t2.leaves_set() == 3
    assert t2.get_empty_leaves_indices() == [1]
    # matches a freshly built in-memory tree
    ref = OptimalMerkleTree(4, device="cpu")
    ref.set_range(0, [11, 22, 33])
    ref.delete(1)
    assert t2.root() == ref.root()


def test_depth_mismatch_rejected(tmp_path):
    cfg = _cfg(tmp_path)
    t = PmTree(4, cfg, device="cpu")
    t.set(0, 1)
    t.flush()
    t.close_db_connection()
    with pytest.raises(InvalidDepth):
        PmTree(5, _cfg(tmp_path), device="cpu")


def test_temporary_cleanup():
    cfg = PmTreeConfig.from_json("{}")
    t = PmTree(3, cfg, device="cpu")
    t.set(0, 5)
    t.flush()
    assert os.path.exists(cfg.path)
    t.close_db_connection()
    assert not os.path.exists(cfg.path)


def test_temporary_path_exists_rejected(tmp_path):
    path = os.path.join(str(tmp_path), "exists.db")
    with open(path, "w") as f:
        f.write("x")
    with pytest.raises(FromConfigError):
        PmTreeConfig.create(path=path, temporary=True)


def test_override_range_dispatch(tmp_path):
    t = PmTree(4, _cfg(tmp_path), device="cpu")
    # set-only override (empty indices allowed, unlike Full/Optimal)
    t.override_range(0, [1, 2, 3], [])
    assert [t.get(i) for i in range(3)] == [1, 2, 3]
    # single-set and single-delete fast paths
    t.override_range(3, [9], [])
    assert t.get(3) == 9
    t.override_range(0, [], [3])
    assert t.get(3) == 0
    # combined removes + writes
    t.override_range(2, [77, 88], [0, 1])
    assert t.get(0) == 0 and t.get(1) == 0
    assert t.get(2) == 77 and t.get(3) == 88
    # no leaves, no indices -> error
    with pytest.raises(InvalidLeaf):
        t.override_range(0, [], [])
    t.close_db_connection()


def test_delete_never_set_errors(tmp_path):
    t = PmTree(4, _cfg(tmp_path), device="cpu")
    t.set(0, 1)
    with pytest.raises(InvalidLeaf):
        t.delete(2)  # pmtree errors on deleting beyond next_index
    t.close_db_connection()


def test_proof_and_verify(tmp_path):
    t = PmTree(5, _cfg(tmp_path), device="cpu")
    t.set_range(0, list(range(1, 9)))
    proof = t.proof(4)
    assert t.verify(t.get(4), proof)
    assert proof.leaf_index() == 4
    t.close_db_connection()


def test_compression_roundtrip(tmp_path):
    from zerokit_tpu_torch.tree.pmtree import MAGIC_Z2 as MAGIC_Z, PmTree, PmTreeConfig

    path = str(tmp_path / "ztree.db")
    cfg = PmTreeConfig.create(path=path, temporary=False, use_compression=True)
    t = PmTree(4, cfg, device="cpu")
    for i in range(5):
        t.set(i, 100 + i)
    t.set_metadata(b"zipped")
    t.flush()
    root = t.root()
    with open(path, "rb") as f:
        assert f.read(len(MAGIC_Z)) == MAGIC_Z
    cfg2 = PmTreeConfig.create(path=path, temporary=False, use_compression=True)
    t2 = PmTree(4, cfg2, device="cpu")
    assert t2.root() == root
    assert t2.metadata() == b"zipped"
    assert t2.get(3) == 103


def test_cache_capacity_write_buffer_flush(tmp_path):
    from zerokit_tpu_torch.tree.pmtree import PmTree, PmTreeConfig

    path = str(tmp_path / "cap.db")
    # huge flush interval so only the write-buffer bound can trigger a flush
    cfg = PmTreeConfig.create(
        path=path, temporary=False, flush_every_ms=10_000_000, cache_capacity=120
    )
    t = PmTree(4, cfg, device="cpu")
    t.set(0, 1)
    t.set(1, 2)
    # 2 writes * 40B < 120B: buffered, nothing durable yet
    assert not os.path.exists(path) and not os.path.exists(path + ".journal")
    t.set(2, 3)  # 3 * 40 >= 120 -> journal append (O(delta) durability)
    assert os.path.exists(path + ".journal")


def test_journal_delta_io_and_reload(tmp_path):
    """Incremental durability is O(delta): between snapshots, writes append
    40-byte journal records instead of rewriting the full leaf set; reload
    replays snapshot + journal; a torn tail record is tolerated."""
    import os
    import struct

    from zerokit_tpu_torch.tree.pmtree import PmTree, PmTreeConfig

    path = str(tmp_path / "tree.db")
    cfg = PmTreeConfig.create(
        path=path, temporary=False, cache_capacity=120, flush_every_ms=10**9
    )
    t = PmTree(4, cfg, device="cpu")
    t.set(0, 111)  # pending (40B < 120B capacity): no I/O yet
    assert not os.path.exists(path + ".journal")
    t.set(1, 222)
    t.set(2, 333)  # 3*40 >= 120 -> journal append, snapshot untouched
    assert os.path.exists(path + ".journal")
    assert not os.path.exists(path)  # no full snapshot written yet
    jsize = os.path.getsize(path + ".journal")
    t.set(3, 444)
    t.set(4, 555)
    t.set(5, 666)
    grown = os.path.getsize(path + ".journal")
    assert grown > jsize  # appends, not rewrites
    root_before = t.root()
    # reload WITHOUT closing (journal replay path; no snapshot exists)
    t2 = PmTree(4, cfg, device="cpu")
    assert t2.root() == root_before
    assert t2.get(4) == 555
    assert t2.leaves_set() == 6

    # torn tail: truncate mid-record; earlier records still apply
    with open(path + ".journal", "ab") as f:
        f.write(b"\x00" + struct.pack("<Q", 7))  # leaf record missing value
    t3 = PmTree(4, cfg, device="cpu")
    assert t3.root() == root_before

    # explicit flush compacts: snapshot written, journal gone
    t.flush()
    assert os.path.exists(path)
    assert not os.path.exists(path + ".journal")
    t4 = PmTree(4, cfg, device="cpu")
    assert t4.root() == root_before
    t.close_db_connection()


def test_stale_journal_skipped_after_compaction_crash(tmp_path):
    """Crash between snapshot replace and journal unlink must NOT replay the
    pre-compaction journal over the newer snapshot (generation stamping)."""
    import shutil

    from zerokit_tpu_torch.tree.pmtree import PmTree, PmTreeConfig

    path = str(tmp_path / "tree.db")
    cfg = PmTreeConfig.create(
        path=path, temporary=False, cache_capacity=40, flush_every_ms=10**9
    )
    t = PmTree(4, cfg, device="cpu")
    t.set(0, 111)  # journal append (cache_capacity=40 -> immediate)
    journal = path + ".journal"
    assert os.path.exists(journal)
    stale = str(tmp_path / "stale.journal")
    shutil.copy(journal, stale)  # the journal as of generation g
    t.flush()  # compaction: snapshot at generation g+1, journal unlinked
    t.set(0, 999)  # post-compaction value, journaled then compacted again
    t.flush()
    root_after = t.root()
    # simulate the crash window: stale journal resurfaces next to the
    # newer snapshot
    shutil.copy(stale, journal)
    t2 = PmTree(4, cfg, device="cpu")
    assert t2.get(0) == 999  # stale record (0 -> 111) must not re-apply
    assert t2.root() == root_after
    assert not os.path.exists(journal)  # stale journal discarded on open


# -- the facade over a PmTree, and the device rule ---------------------------


def test_rln_init_tree_with_leaves_over_pmtree():
    """api.py rebuilds the tree as type(tree)(depth, device=tree.device): a
    PmTree takes that call, and the new tree holds the leaves (its config
    is dropped there, as the JAX facade drops it)."""
    from zerokit_tpu_torch import RLN
    from zerokit_tpu_torch.resources import load_resource

    rln = RLN.stateful(
        device="cpu", tree=PmTree(10, device="cpu"),
        zkey_bytes=load_resource("tree_depth_10/rln_final.arkzkey"),
        graph_bytes=load_resource("tree_depth_10/graph.bin"),
    )
    rln.set_leaf(0, 5)
    leaves = [(i * 7919 + 3) ** 3 % (1 << 200) for i in range(37)]
    rln.init_tree_with_leaves(leaves)
    assert isinstance(rln.tree, PmTree) and rln.tree.device == torch.device("cpu")
    ref = JaxOptimalTree(10)
    ref.set_range(0, leaves)
    assert rln.get_root() == ref.root()
    assert rln.leaves_set() == len(leaves)
    proof = rln.get_merkle_proof(11)
    assert proof.get_path_elements() == ref.proof(11).get_path_elements()
    rln.tree.close_db_connection()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert PmTree(3).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PmTree(3)


# -- the storage formats across packages --------------------------------------


def _writes(t):
    t.set_range(0, [11, 22, 33, 44])
    t.delete(1)
    t.set_metadata(b"cross-package")
    t.update_next(55)
    t.override_range(2, [66, 77], [0])


def _open(pkg, path, depth=4, **kw):
    cfg = pkg.PmTreeConfig.create(path=path, temporary=False, flush_every_ms=10**9, **kw)
    if pkg is j_pmtree:
        return pkg.PmTree(depth, cfg)
    return pkg.PmTree(depth, cfg, device="cpu")


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "zlib"])
def test_snapshot_and_journal_bytes_equal(tmp_path, compression):
    files = {}
    for name, pkg in (("jax", j_pmtree), ("port", t_pmtree)):
        path = str(tmp_path / f"{name}.db")
        t = _open(pkg, path, use_compression=compression, cache_capacity=40)
        _writes(t)  # cache_capacity=40: every write appends to the journal
        with open(path + ".journal", "rb") as f:
            journal = f.read()
        t.flush()
        with open(path, "rb") as f:
            files[name] = (journal, f.read(), t.root())
        t.close_db_connection()
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer,reader", [(j_pmtree, t_pmtree), (t_pmtree, j_pmtree)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("compression", [False, True], ids=["plain", "zlib"])
def test_file_written_by_one_loads_in_the_other(tmp_path, writer, reader, compression):
    path = str(tmp_path / "tree.db")
    t = _open(writer, path, use_compression=compression)
    _writes(t)
    t.flush()  # snapshot
    t.set(6, 99)  # then a journal record beside it
    t._journal_flush()
    root = t.root()
    t2 = _open(reader, path, use_compression=compression)
    assert t2.root() == root
    assert t2.get(6) == 99
    # against the writer's own reload: in both packages a reload marks the
    # zero-valued leaf that override_range rewrote (index 1) as empty, where
    # the tree in memory holds it as set
    own = _open(writer, path, use_compression=compression)
    assert t2.metadata() == own.metadata() == b"cross-package"
    assert t2.get_empty_leaves_indices() == own.get_empty_leaves_indices() == [0, 1, 5]
    assert t2.leaves_set() == own.leaves_set() == t.leaves_set()
    assert [t2.get(i) for i in range(8)] == [t.get(i) for i in range(8)]
