"""A ("dp", "tp") mesh of torch.distributed ranks, and the tensor-parallel MSM.

Counterpart of zerokit_tpu/parallel/sharded.py, as SPMD over process
groups: every rank runs the same program on its share of the work.

  * mesh axes: "dp" (data parallel: the proofs of a batch) x "tp" (tensor
    parallel: the MSM base points, the NTT domain). Rank = d * tp + t, as
    the JAX package's devices.reshape(dp, tp).
  * MSM: each tp rank holds n / tp of the base points and its own window
    tables, runs the fused pass (groth16/msm_fused.py, K2 and K3) on its
    points, and the tp partial accumulators combine by an all_gather over
    tp and a log-depth tree of K2 adds. EC addition is not a ring sum, so
    no all_reduce applies; the gather moves 16 * C * 3 * B words a rank.
  * batch (dp) sharding needs no communication until the results: witness
    evaluation, the QAP map and each lane's MSMs are independent per proof.

The collectives go through all_gather / all_to_all / all_gather_object
here, which time each call (host clock, the device synchronised on both
sides) and count its bytes in mesh.collectives, under the profiler spans
parallel.all_gather, parallel.all_to_all, parallel.all_gather_object and
parallel.broadcast_object.
Gloo takes CUDA tensors in each of them (torch 2.11), so gloo ranks on
cards hand it device tensors as they are.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ff.field import resolve_device
from ..groth16.curve import CurveOps
from ..groth16.msm import (C_BITS, K_BLOCK, LANE_BATCH, MSM, N_WINDOWS, _pad_lanes,
                           _window_group, block_size_for, encode_affine_points, table_rows)
from ..groth16.msm_fused import fused_msm_pass, tree_sum
from ..runtime.profiling import span


class Mesh:
    """This rank's place in a (dp, tp) mesh: its coordinates, its tp and dp
    process groups, its device and the default group's backend. The
    collectives of this module record their calls, bytes and seconds in
    `collectives`: name -> {"calls", "bytes_in", "bytes_out", "seconds"}."""

    def __init__(self, dp: int, tp: int, rank: int, tp_group, dp_group,
                 device: torch.device, backend: str):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.dp_index, self.tp_index = divmod(rank, tp)
        self.tp_group, self.dp_group = tp_group, dp_group
        self.device = device
        self.backend = backend
        self.collectives: dict = {}

    def group(self, axis: str):
        return {"tp": self.tp_group, "dp": self.dp_group}[axis]

    def size(self, axis: str) -> int:
        return {"tp": self.tp, "dp": self.dp}[axis]

    def index(self, axis: str) -> int:
        return {"tp": self.tp_index, "dp": self.dp_index}[axis]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank} = ({self.dp_index}, "
                f"{self.tp_index}), {self.backend} on {self.device})")


def make_mesh(tp: int = 1, dp: Optional[int] = None, device="cuda") -> Mesh:
    """The (dp, tp) mesh over the initialised default process group.

    device: "cuda" takes cuda:<local rank mod device count> (LOCAL_RANK, else
    the global rank), "cuda:<i>" that card, "cpu" the CPU. A card becomes
    the rank's current device: NCCL's object collectives stage their
    objects there. Every rank creates every tp and dp group, in the same
    order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp = {dp * tp} != world size {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(t, world, tp))) for t in range(tp)]
    d, t = divmod(rank, tp)
    return Mesh(dp, tp, rank, tp_groups[d], dp_groups[t], dev, dist.get_backend())


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded(mesh: Mesh, name: str, bytes_in: int, bytes_out: int):
    cuda = mesh.device.type == "cuda"
    with span(f"parallel.{name}"):
        if cuda:
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
    rec = mesh.collectives.setdefault(
        name, {"calls": 0, "bytes_in": 0, "bytes_out": 0, "seconds": 0.0})
    rec["calls"] += 1
    rec["bytes_in"] += bytes_in
    rec["bytes_out"] += bytes_out
    rec["seconds"] += seconds


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """(size, *x.shape): every rank's x over the axis's group, in rank order."""
    x = x.contiguous()
    size = mesh.size(axis)
    nbytes = x.numel() * x.element_size()
    with _recorded(mesh, "all_gather", nbytes, size * nbytes):
        out = x.new_empty((size,) + tuple(x.shape))
        dist.all_gather(list(out.unbind(0)), x, group=mesh.group(axis))
    return out


def all_to_all(mesh: Mesh, x: torch.Tensor, in_splits: Optional[List[int]] = None,
               out_splits: Optional[List[int]] = None) -> torch.Tensor:
    """all_to_all_single over the tp group along dim 0: rank r sends its
    i-th block of in_splits[i] rows to rank i and receives out_splits[j] rows
    from each rank j, in rank order (equal blocks when the splits are None)."""
    x = x.contiguous()
    rows = sum(out_splits) if out_splits is not None else x.shape[0]
    out_shape = (rows,) + tuple(x.shape[1:])
    row_bytes = x[:1].numel() * x.element_size()
    with _recorded(mesh, "all_to_all", x.shape[0] * row_bytes, rows * row_bytes):
        out = x.new_empty(out_shape)
        dist.all_to_all_single(out, x, out_splits, in_splits, group=mesh.tp_group)
    return out


def all_gather_object(mesh: Mesh, obj, axis: str = "dp") -> list:
    """Every rank's picklable obj over the axis's group, in rank order."""
    out = [None] * mesh.size(axis)
    with _recorded(mesh, "all_gather_object", 0, 0):
        dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


def broadcast_object(mesh: Mesh, obj):
    """Global rank 0's picklable obj, on every rank of the mesh."""
    box = [obj]
    with _recorded(mesh, "broadcast_object", 0, 0):
        dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# Tensor-parallel MSM
# ---------------------------------------------------------------------------


def _tree_reduce_points(cv: CurveOps, gathered: torch.Tensor) -> torch.Tensor:
    """gathered: (D, 16, C, 3, B) projective partials -> (16, C, 3, B): a
    halving tree of K2 adds, the odd partial carried to the next round."""
    return tree_sum(cv, gathered.movedim(0, 3), 3)


def sharded_msm(adapter, points: list, scalars: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Tensor-parallel MSM of one call: points a list of affine points (as
    ShardedMSM takes them), scalars (16, len(points), B) canonical, the same
    on every tp rank. A throwaway ShardedMSM: each rank builds the tables of
    its share of the points only. Returns the projective accumulators (16,
    C, 3, B), equal on every tp rank."""
    return ShardedMSM(points, adapter, mesh).local(scalars)


def pad_points_for_sharding(points: list, shards: int) -> list:
    """Pads a base-point list with infinity so len divides the shard count."""
    rem = len(points) % shards
    if rem:
        points = list(points) + [None] * (shards - rem)
    return points


class ShardedMSM(MSM):
    """Tensor-parallel MSM over one fixed base set: a drop-in for MSM on a mesh.

    The base points pad with infinity to a multiple of tp * K_BLOCK; tp rank
    t holds points [t * n_loc, (t + 1) * n_loc) and builds their window
    tables itself. Each pass (MSM._pass, here on the shard) runs the fused
    MSM pass on the rank's points and combines the tp partials
    (all_gather + K2 tree). FusedMSMGroup runs over ShardedMSMs as it runs
    over MSMs.

    __call__ takes the whole batch, as the JAX ShardedMSM does: dp rank d
    takes its contiguous share of the lanes, streams it through passes of
    LANE_BATCH lanes (LANE_BATCH * dp lanes of the batch), and the results
    are gathered over dp, so every rank returns all lanes. `local` (MSM's)
    is the same MSM on the lanes a rank already holds, with no dp gather."""

    def __init__(self, points, adapter, mesh: Mesh, n_windows: int = N_WINDOWS,
                 c_bits: int = C_BITS):
        self.adapter = adapter
        self.curve = CurveOps(adapter)
        self.mesh = mesh
        self.device = mesh.device
        self.n_windows = n_windows
        self.c_bits = c_bits
        self.lane_batch = LANE_BATCH
        self.n_real = len(points)
        gran = mesh.tp * K_BLOCK
        padded = pad_points_for_sharding(points, gran)
        self.n = max(gran, len(padded))
        self.n_loc = self.n // mesh.tp
        self.lo = mesh.tp_index * self.n_loc
        mine = list(padded[self.lo : self.lo + self.n_loc])
        mine += [None] * (self.n_loc - len(mine))  # no points at all
        self.points = encode_affine_points(mine, adapter).to(self.device)
        self._tables = None
        self._tables_lock = threading.Lock()

    def tables(self) -> torch.Tensor:
        """This shard's AoS window-table rows (W * n_loc, 16 * C * 2). The
        padding points are infinity, whose rows are (0, 0): only the shard's
        real points go through the doublings."""
        with self._tables_lock:
            if self._tables is None:
                n_mine = min(max(self.n_real - self.lo, 0), self.n_loc)
                self._tables = table_rows(self.curve, self.points[..., :n_mine], self.n_loc,
                                          self.n_windows, self.c_bits)
        return self._tables

    def _pass(self, scalars: torch.Tensor, n_instances: int = 1,
              tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        """scalars (16, n, B) padded -> the pass over this shard's points,
        combined over tp: (16, C, 3, B) on every tp rank."""
        local = scalars[:, self.lo : self.lo + self.n_loc].contiguous()
        group = _window_group(scalars.shape[2], self.adapter.components, self.n_loc,
                              self.n_windows)
        acc = fused_msm_pass(
            self.curve, self.tables() if tables is None else tables, local, self.n_loc,
            self.n_windows, self.c_bits, group, block_size_for(self.n_loc), n_instances,
        )
        return _tree_reduce_points(self.curve, all_gather(self.mesh, acc, "tp"))

    def __call__(self, scalars_canon: torch.Tensor, mask=None) -> torch.Tensor:
        """scalars_canon: (16, n_real, B) canonical limbs of the whole batch,
        the same on every rank; mask: optional (n_real, B) or (n_real, 1)
        bool, False entries contribute nothing. Returns the projective
        accumulators (16, C, 3, B) on every rank."""
        batch = scalars_canon.shape[2]
        dp, d = self.mesh.dp, self.mesh.dp_index
        per = -(-batch // dp)
        mine = slice(d * per, (d + 1) * per)
        scalars = _pad_lanes(scalars_canon, per * dp)[:, :, mine]
        if mask is not None:
            mask = torch.as_tensor(mask).expand(self.n_real, batch)
            mask = _pad_lanes(mask, per * dp)[:, mine]
        acc = self.local(scalars, mask)
        full = all_gather(self.mesh, acc, "dp")  # (dp, 16, C, 3, per)
        return full.permute(1, 2, 3, 0, 4).reshape(acc.shape[:3] + (dp * per,))[..., :batch]
