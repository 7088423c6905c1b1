"""Single-pass batched Pippenger MSM over fixed bases, as torch orchestration.

Counterpart of the pass in zerokit_tpu/groth16/msm_fused.py (_build_fused),
same algorithm and stage order:

  1. digits of the 8-bit windows;
  2. per window and lane, a stable sort by digit via packed int64 keys
     (digit << idx_bits) | index, giving the int32 table-row index of
     the points in sorted order (sorted_table_index);
  3. the histogram of digits and its cumsum: C(d) = #(digit <= d);
  4. the fine scan (K3 "mixed", ec_scan_gather): inclusive prefixes inside
     blocks of k = 32 sorted points, read from the table rows through the
     index, written as rows in sorted order;
  5. the coarse scan (K3 "excl", ec_scan_excl): exclusive prefixes of the
     block totals, the fine prefixes at the end of each block, read in place;
  6. the Q_d bucket adds: Q_d = fine[C(d)-1] + coarse[(C(d)-1) div k], or
     the identity where C(d) = 0 (K2 ec_add_gather, which reads both rows
     through int32 indices itself; bucket_rows makes them);
  7. the telescope 255*S_total - sum_{d<255} Q_d, with sum_d Q_d as a
     halving tree of K2 adds and 255*S as 256*S - S (8 K2 doublings);
  8. the windows' sum (the tables carry the 2^(8w) factors): a halving tree.

Digit 0 contributes equally to every Q_d and cancels, so zero and masked
scalars cost nothing. The stages run under torch.profiler ranges msm.digits,
msm.sort, msm.fine, msm.coarse, msm.qgather and msm.sumq (the cut points of
tools/msm_profile.py); they cost nothing without a profiler.
"""

from __future__ import annotations

import torch

from ..constants import NUM_LIMBS
from ..ff.field_kernels import ec_add_gather, ec_scan_excl, ec_scan_gather
from ..runtime.profiling import span
from .curve import CurveOps

L = NUM_LIMBS


def digits_for_windows(scalars: torch.Tensor, n_windows: int, c_bits: int) -> torch.Tensor:
    """scalars (16, n, B) canonical -> digits (W, n, B) int64."""
    if 16 % c_bits:
        raise ValueError("c_bits must divide 16 (digits may not straddle limbs)")
    per_limb = 16 // c_bits
    mask = (1 << c_bits) - 1
    sc = scalars.to(torch.int64)
    return torch.stack(
        [(sc[w // per_limb] >> ((w % per_limb) * c_bits)) & mask for w in range(n_windows)]
    )


def tree_sum(cv: CurveOps, xs: torch.Tensor, axis: int) -> torch.Tensor:
    """EC sum along a batch axis (after the (16, C, 3) point dims) via
    halving rounds of wide adds."""
    d = xs.shape[axis]
    while d > 1:
        half = d // 2
        a = xs.narrow(axis, 0, half)
        b = xs.narrow(axis, half, half)
        combined = cv.add(a, b)
        if d % 2:
            combined = torch.cat([combined, xs.narrow(axis, 2 * half, d - 2 * half)], dim=axis)
        xs = combined
        d = xs.shape[axis]
    return xs.squeeze(axis)


def sorted_table_index(dg: torch.Tensor, first_window: int, n_windows: int,
                       n_instances: int = 1) -> torch.Tensor:
    """Digits (G, n, B) of windows first_window.. -> int32 (G, n, B): per
    window and lane, the table rows of the n points in stable digit order.
    Rows of instance m, window w start at (m*W + w)*n (tables of the
    instances stacked, lanes instance-major)."""
    group, n, batch = dg.shape
    device = dg.device
    idx_bits = max(1, (n - 1).bit_length())
    iota_n = torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    skeys, _ = torch.sort((dg << idx_bits) | iota_n, dim=1)
    inst = (torch.arange(batch, device=device) // (batch // n_instances)) * (n_windows * n)
    window = torch.arange(first_window, first_window + group, device=device)[:, None, None]
    return (window * n + inst[None, None, :] + (skeys & ((1 << idx_bits) - 1))).to(torch.int32)


def bucket_counts(dg: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Digits (G, n, B) -> counts (G, n_buckets - 1, B) int64: C(d) =
    #(digit <= d) per window and lane, d in [0, n_buckets - 2]."""
    group, _, batch = dg.shape
    device = dg.device
    g_iota = torch.arange(group, dtype=torch.int64, device=device)[:, None, None]
    b_iota = torch.arange(batch, dtype=torch.int64, device=device)[None, None, :]
    hist = torch.zeros(group * n_buckets * batch, dtype=torch.int64, device=device)
    hist.index_add_(
        0,
        ((g_iota * n_buckets + dg) * batch + b_iota).reshape(-1),
        torch.ones(dg.numel(), dtype=torch.int64, device=device),
    )
    return hist.reshape(group, n_buckets, batch).cumsum(dim=1)[:, : n_buckets - 1]


def bucket_rows(counts: torch.Tensor, n: int, k: int):
    """Counts (G, nb-1, B), C(d) = #(digit <= d) -> (fidx, cidx, empty),
    each (G, nb, B): per window, bucket d and lane, the fine-prefix row of
    the bucket's last sorted point (position C(d) - 1; the last bucket
    takes all n points), the coarse-prefix row of that point's block of k,
    both int32 rows of the pass's dense (G, n, B) / (G, n/k, B) outputs,
    and whether the bucket is empty (C(d) = 0)."""
    group, _, batch = counts.shape
    device = counts.device
    total = torch.full((group, 1, batch), n, dtype=counts.dtype, device=device)
    c_all = torch.cat([counts, total], dim=1)
    pos = (c_all - 1).clamp(min=0).to(torch.int32)
    g_iota = torch.arange(group, dtype=torch.int32, device=device)[:, None, None]
    b_iota = torch.arange(batch, dtype=torch.int32, device=device)[None, None, :]
    fidx = (g_iota * n + pos) * batch + b_iota
    cidx = (g_iota * (n // k) + pos // k) * batch + b_iota
    return fidx, cidx, c_all == 0


def fused_msm_pass(
    cv: CurveOps,
    tables_flat: torch.Tensor,
    scalars: torch.Tensor,
    n: int,
    n_windows: int,
    c_bits: int,
    group: int,
    k: int,
    n_instances: int = 1,
) -> torch.Tensor:
    """One MSM pass.

    tables_flat: (M*W*n, 16*C*2) affine AoS table rows, word order (limb,
    comp, coord), instance-major; scalars: (16, n, M*B) canonical limbs with
    lane order (m, b). Returns projective accumulators (16, C, 3, M*B)."""
    comps = cv.components
    n_buckets = 1 << c_bits
    batch = scalars.shape[2]
    if n_windows % group or n % k:
        raise ValueError(f"group {group} / block {k} do not divide {n_windows} / {n}")
    n_groups = n_windows // group
    nb_blk = n // k
    rows_out = L * comps * 3
    with span("msm.digits"):
        digits = digits_for_windows(scalars, n_windows, c_bits)  # (W, n, B)
    window_results = []
    for g in range(n_groups):
        dg = digits[g * group : (g + 1) * group]  # (G, n, B)
        with span("msm.sort"):
            index = sorted_table_index(dg, g * group, n_windows, n_instances)
        with span("msm.fine"):
            counts = bucket_counts(dg, n_buckets)
            # -- intra-block inclusive prefixes: K3 mixed, lanes (g, blk, b) -
            fine = ec_scan_gather(comps, tables_flat, index.view(group * nb_blk, k, batch))
        with span("msm.coarse"):
            # -- exclusive block prefixes: K3 excl over the blocks' totals --
            totals = fine.view(group, nb_blk, k, batch, rows_out)[:, :, k - 1]
            coarse = ec_scan_excl(comps, totals)  # (G, NB, B, rows_out)
        with span("msm.qgather"):
            # -- Q_d: K2 adds through the bucket rows, (16, C, 3, G, nb, B) --
            fidx, cidx, empty = bucket_rows(counts, n, k)
            q = ec_add_gather(comps, fine.view(-1, rows_out), fidx, coarse.view(-1, rows_out),
                              cidx, empty)
            s_total = q[:, :, :, :, n_buckets - 1].contiguous()
            q[:, :, :, :, n_buckets - 1] = cv.identity_like(s_total)
        with span("msm.sumq"):
            # -- sum_d Q_d: halving tree ------------------------------------
            sum_q = tree_sum(cv, q, 4)
            # -- telescope: (2^c - 1) * S_total - sum Q ---------------------
            t = s_total
            for _ in range(c_bits):
                t = cv.double(t)
            t = cv.add(t, cv.neg(s_total))
            t = cv.add(t, cv.neg(sum_q))
        window_results.append(t)  # (16, C, 3, G, B)
    with span("msm.sumq"):
        all_windows = torch.cat(window_results, dim=3)  # (16, C, 3, W, B)
        return tree_sum(cv, all_windows, 3)
