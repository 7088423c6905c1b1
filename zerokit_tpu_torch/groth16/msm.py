"""Batched fixed-base Pippenger MSM on the card.

Counterpart of zerokit_tpu/groth16/msm.py (ark-ec VariableBaseMSM
semantics, reference rln/src/partial_proof.rs:98-104). Every Groth16 MSM
runs over a fixed base set (the zkey's a/b1/b2/h/l queries) against a batch
of per-proof scalar vectors:

  * fixed-base window tables T[w][i] = 2^(8w) * P_i, built once per MSM on
    the device (8 K2 doublings per window, then one batched to_affine);
  * each pass (msm_fused.fused_msm_pass) sorts the digits per lane, prefix-
    sums the sorted table rows (K3) and telescopes the bucket sums (K2).

Base sets pad to a multiple of PAD_GRANULARITY (infinity points, zero
scalars) when they hold more than 64 points; batches wider than LANE_BATCH
stream through passes of LANE_BATCH lanes.

An MSM may also be built over a fixed subset of a query (`index`): the
partial and the finish of two-phase proving walk only the points of the
wires they know or do not know. It takes the whole query's scalar vectors
and reads them at its positions, and pads to a multiple of K_BLOCK only.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from ..constants import NUM_LIMBS, Q
from ..ff.field import FQ, decode_canonical_fast, resolve_device
from ..ff.fq2 import FqAdapter
from ..runtime.profiling import span
from .curve import CurveOps
from .msm_fused import fused_msm_pass

C_BITS = 8
N_BUCKETS = 1 << C_BITS
N_WINDOWS = 32  # 256 bits / 8
# Window-group size bound: a pass keeps the int32 table-row index
# (4 * G * n * B bytes) and the fine prefix rows (192 * C * G * n * B bytes)
# resident; the fine scan reads the table rows through the index, so no
# gathered copy of them exists. C*G*B is capped, and so are the fine rows'
# bytes: MAX_FINE_BYTES binds only past the proving path's widths (at most
# 1.2 GB there: b2, 6144 points x 16 lanes x 32 windows), and keeps a
# 2^22-point G1 pass of 4 lanes at 2 windows a group (6.4 GB), not 32 (103 GB).
MAX_CGB = 1024
MAX_FINE_BYTES = 8 << 30
FINE_ROW_BYTES = 192  # one projective prefix row a component: 16 limbs x 3 coords x 4 B
# points whose window tables one build step holds at once: bounds the
# projective columns and to_affine's product tree of a large table build
TABLE_CHUNK = 1 << 20
K_BLOCK = 32  # intra-block scan length
PAD_GRANULARITY = 2048
# lanes per MSM pass; wider batches stream through passes of this width
LANE_BATCH = 16


def encode_affine_points(points, adapter) -> torch.Tensor:
    """Host affine points (ints; None = infinity) -> (16, C, 2, n) int32.

    G1 points are (x, y); G2 points are ((x0,x1), (y0,y1)). Infinity is
    encoded as (0, 0), the zkey sentinel convention."""
    flat = []
    if adapter is FqAdapter:
        for p in points:
            x, y = (0, 0) if p is None else p
            flat.extend([x, y])
    else:
        for p in points:
            if p is None:
                flat.extend([(0, 0), (0, 0)])
            else:
                flat.extend([p[0], p[1]])
    enc = adapter.encode(flat).reshape(NUM_LIMBS, adapter.components, len(points), 2)
    return enc.permute(0, 1, 3, 2).contiguous()  # (16, C, 2, n)


def tables_to_aos_s(adapter, tables: torch.Tensor) -> torch.Tensor:
    """(S, 16, C, 2, W, n) SoA tables -> (S, W*n, 16*C*2) AoS point rows,
    word order (limb, comp, coord)."""
    s, w, n = tables.shape[0], tables.shape[4], tables.shape[5]
    t = tables.permute(0, 4, 5, 1, 2, 3)  # (S, W, n, 16, C, 2)
    return t.reshape(s, w * n, NUM_LIMBS * adapter.components * 2)


def build_window_tables(
    cv: CurveOps, points: torch.Tensor, n_windows: int = N_WINDOWS, c_bits: int = C_BITS
) -> torch.Tensor:
    """points (16, C, 2, n) affine -> tables (16, C, 2, W, n) with
    tables[..., w, i] = 2^(c_bits*w) * P_i; infinity -> (0, 0)."""
    proj = cv.from_affine(points)  # (16, C, 3, n)
    cols = [proj]
    for _ in range(1, n_windows):
        for _ in range(c_bits):
            proj = cv.double(proj)
        cols.append(proj)
    return cv.to_affine(torch.stack(cols, dim=3))


def table_rows(cv: CurveOps, points: torch.Tensor, n: int, n_windows: int = N_WINDOWS,
               c_bits: int = C_BITS) -> torch.Tensor:
    """points (16, C, 2, n_real) affine -> the AoS window-table rows
    (W*n, 16*C*2) of build_window_tables, row w*n + i for point i; the rows
    of points n_real..n (infinity padding) are (0, 0) and cost no
    doublings. Built TABLE_CHUNK points at a time."""
    n_real = points.shape[3]
    rows = points.new_zeros((n_windows, n, NUM_LIMBS * cv.components * 2))
    for lo in range(0, n_real, TABLE_CHUNK):
        t = build_window_tables(cv, points[..., lo : lo + TABLE_CHUNK], n_windows, c_bits)
        rows[:, lo : lo + t.shape[4]] = tables_to_aos_s(cv.fq, t[None]).view(
            n_windows, t.shape[4], -1)
    return rows.view(n_windows * n, -1)


def subset_size(count: int) -> int:
    """Points a subset MSM of `count` points holds: the next multiple of
    K_BLOCK, at least one block."""
    return max(K_BLOCK, -(-count // K_BLOCK) * K_BLOCK)


def _window_group(batch: int, components: int, n: int, n_windows: int = N_WINDOWS) -> int:
    """Windows a pass of `batch` lanes over n points sorts and scans at once."""
    g = min(32, n_windows)
    while g > 2 and (g * batch * components > MAX_CGB
                     or FINE_ROW_BYTES * components * g * n * batch > MAX_FINE_BYTES):
        g //= 2
    return g


def block_size_for(n: int) -> int:
    return K_BLOCK if n % K_BLOCK == 0 else n  # small test MSMs: one block


def _pad_lanes(x: torch.Tensor, width: int) -> torch.Tensor:
    """Pads the lane axis (last) to width by repeating lane 0."""
    extra = width - x.shape[-1]
    if extra <= 0:
        return x
    return torch.cat([x, x[..., :1].expand(x.shape[:-1] + (extra,))], dim=-1)


def affine_ints(adapter, acc: torch.Tensor) -> List:
    """Projective accumulators (16, C, 3, B) of the adapter's curve -> host
    affine points (None for infinity). The few Z inversions run on host
    integers. The span host.affine holds the blocking copy to the host, the
    decode and the inversions (not msm.*: the MSMs' roofline reads the
    device time inside msm.* ranges)."""
    from ..hostmath import bn254

    with span("host.affine"):
        arr = acc.detach().cpu()
        batch = arr.shape[3]
        vals = [FQ.from_mont_int(v) for v in decode_canonical_fast(arr.reshape(NUM_LIMBS, -1))]
        out = []
        for b in range(batch):
            def coord(c, j):
                return vals[(c * 3 + j) * batch + b]

            if adapter is FqAdapter:
                x, y, z = coord(0, 0), coord(0, 1), coord(0, 2)
                if z == 0:
                    out.append(None)
                    continue
                zi = pow(z, -1, Q)
                out.append((x * zi % Q, y * zi % Q))
            else:
                x = (coord(0, 0), coord(1, 0))
                y = (coord(0, 1), coord(1, 1))
                z = (coord(0, 2), coord(1, 2))
                if z == (0, 0):
                    out.append(None)
                    continue
                zi = bn254.fq2_inv(z)
                out.append((bn254.fq2_mul(x, zi), bn254.fq2_mul(y, zi)))
        return out


def msm_accumulate(adapter, points: torch.Tensor, scalars: torch.Tensor,
                   n_windows: int = N_WINDOWS, c_bits: int = C_BITS) -> torch.Tensor:
    """One-shot MSM from affine points (16, C, 2, n) + canonical scalars
    (16, n, B); tables built on the fly. Returns projective accumulators
    (16, C, 3, B). For repeated MSMs over the same bases use the MSM class,
    which caches the window tables. (n_windows, c_bits) below the default
    requires every scalar < 2^(c_bits*n_windows)."""
    cv = CurveOps(adapter)
    n = points.shape[3]
    rows = table_rows(cv, points, n, n_windows, c_bits)
    group = _window_group(scalars.shape[2], adapter.components, n, n_windows)
    return fused_msm_pass(cv, rows, scalars.contiguous(), n, n_windows, c_bits, group,
                          block_size_for(n))


class MSM:
    """MSM over one fixed base set. adapter = ff.fq2.FqAdapter (G1) or Fq2Adapter (G2)."""

    def __init__(self, points, adapter, device="cuda", n_windows: int = N_WINDOWS,
                 c_bits: int = C_BITS, index: Optional[Sequence[int]] = None,
                 size: Optional[int] = None):
        """points: list of affine points as ints (G1: (x, y); G2:
        ((x0,x1),(y0,y1))). None encodes the point at infinity. index: the
        positions of a fixed subset of points, to build the MSM over those
        points alone, padded with infinity to `size` (default
        subset_size); it is then called with scalar vectors as long as
        points, and reads them at index."""
        self.adapter = adapter
        self.curve = CurveOps(adapter)
        self.device = resolve_device(device)
        self.n_windows = n_windows
        self.c_bits = c_bits
        self.lane_batch = LANE_BATCH
        points = self._take(points, index)
        self.n_real = len(points)
        if index is not None:
            pad_to = size or subset_size(len(points))
        else:
            pad_to = max(
                PAD_GRANULARITY,
                ((len(points) + PAD_GRANULARITY - 1) // PAD_GRANULARITY) * PAD_GRANULARITY,
            )
        if len(points) > 64 or index is not None:
            points = list(points) + [None] * (pad_to - len(points))
        self.n = len(points)
        self.points = encode_affine_points(points, adapter).to(self.device)
        self._tables = None
        self._tables_lock = threading.Lock()

    def _take(self, points, index):
        """The points the MSM is over: the subset at index, or all. Sets
        the scalar vectors' length (n_scalars) and the index on the device."""
        self.n_scalars = len(points)
        self.index = None
        if index is None:
            return points
        self.index = torch.as_tensor(list(index), dtype=torch.int64, device=self.device)
        return [points[i] for i in index]

    def tables(self) -> torch.Tensor:
        """AoS window-table rows (W*n, 16*C*2), built on first use, once
        when threads reach the first use together."""
        with self._tables_lock:
            if self._tables is None:
                self._tables = table_rows(self.curve, self.points[..., : self.n_real], self.n,
                                          self.n_windows, self.c_bits)
        return self._tables

    def scalars_padded(self, scalars_canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Validates, masks and pads scalars (16, n_scalars, B) to (16, n,
        B); a subset MSM takes its positions first."""
        if scalars_canon.shape[1] != self.n_scalars:
            raise ValueError(f"expected {self.n_scalars} scalars, got {scalars_canon.shape[1]}")
        scalars = scalars_canon.to(self.device)
        if mask is not None:
            m = torch.as_tensor(mask, device=self.device)
            scalars = torch.where(m[None], scalars, torch.zeros_like(scalars))
        if self.index is not None:
            scalars = scalars[:, self.index]
        if self.n != self.n_real:
            pad = scalars.new_zeros((NUM_LIMBS, self.n - self.n_real, scalars.shape[2]))
            scalars = torch.cat([scalars, pad], dim=1)
        return scalars

    def _pass(self, scalars: torch.Tensor, n_instances: int = 1,
              tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        group = _window_group(scalars.shape[2], self.adapter.components, self.n,
                              self.n_windows)
        return fused_msm_pass(
            self.curve, self.tables() if tables is None else tables, scalars, self.n,
            self.n_windows, self.c_bits, group, block_size_for(self.n), n_instances,
        )

    def __call__(self, scalars_canon: torch.Tensor, mask=None) -> torch.Tensor:
        """scalars_canon: (16, n_scalars, B) canonical limbs. mask: optional
        (n_scalars, B) bool; points with False contribute nothing. Returns
        projective accumulators (16, C, 3, B)."""
        return self.local(scalars_canon, mask)

    def local(self, scalars_canon: torch.Tensor, mask=None) -> torch.Tensor:
        """The MSM of the lanes this process holds, in passes of LANE_BATCH
        lanes: all of them here; a ShardedMSM's __call__ first splits the
        batch over its mesh's dp ranks."""
        scalars = self.scalars_padded(scalars_canon, mask)
        batch = scalars.shape[2]
        b0 = self.lane_batch
        chunks = []
        for lo in range(0, batch, b0):
            hi = min(lo + b0, batch)
            piece = scalars[:, :, lo:hi]
            if batch > b0:  # ragged tail: pad lanes, slice the result
                piece = _pad_lanes(piece, b0)
            chunks.append(self._pass(piece.contiguous())[..., : hi - lo])
        return torch.cat(chunks, dim=3)

    def to_affine_ints(self, acc: torch.Tensor) -> List:
        """Projective accumulators (16, C, 3, B) -> host affine points (None
        for infinity)."""
        return affine_ints(self.adapter, acc)


class FusedMSMGroup:
    """Runs k same-shape fixed-base MSMs (the prover's a/b1/l G1 queries) as
    one pass per LANE_BATCH chunk: lane axis k*B, per-lane table base."""

    def __init__(self, msms):
        if len(msms) < 2:
            raise ValueError("a group needs at least two MSMs")
        first = msms[0]
        if not all(m.n == first.n and m.adapter is first.adapter for m in msms):
            raise ValueError("grouped MSMs must share the padded size and the curve")
        self.msms = list(msms)
        self.adapter = first.adapter
        self.n = first.n
        self.lane_batch = first.lane_batch
        self._tables_cat = None
        self._tables_lock = threading.Lock()

    def tables_cat(self) -> torch.Tensor:
        with self._tables_lock:
            if self._tables_cat is None:
                self._tables_cat = torch.cat([m.tables() for m in self.msms], dim=0)
        return self._tables_cat

    def __call__(self, scalars_list, masks=None):
        """scalars_list[i]: (16, msms[i].n_real, B). Returns one projective
        accumulator (16, C, 3, B) per member MSM."""
        m_count = len(self.msms)
        if masks is None:
            masks = [None] * m_count
        padded = [m.scalars_padded(s, mk) for m, s, mk in zip(self.msms, scalars_list, masks)]
        batch = padded[0].shape[2]
        if any(p.shape[2] != batch for p in padded):
            raise ValueError("grouped MSMs need one batch size")
        b0 = self.lane_batch
        accs = [[] for _ in range(m_count)]
        for lo in range(0, batch, b0):
            hi = min(lo + b0, batch)
            width = b0 if batch > b0 else hi - lo
            piece = [_pad_lanes(p[:, :, lo:hi], width) for p in padded]
            stacked = torch.cat(piece, dim=2).contiguous()  # (16, n, M*width)
            acc = self.msms[0]._pass(stacked, m_count, self.tables_cat())
            for m in range(m_count):
                accs[m].append(acc[..., m * width : m * width + (hi - lo)])
        return [torch.cat(a, dim=3) for a in accs]
