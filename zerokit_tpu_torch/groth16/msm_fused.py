"""Single-pass batched Pippenger MSM over fixed bases, as torch orchestration.

Counterpart of the pass in zerokit_tpu/groth16/msm_fused.py (_build_fused),
same algorithm and stage order:

  1. digits of the 8-bit windows;
  2. per window and lane, a stable sort by digit via packed int64 keys
     (digit << idx_bits) | index;
  3. a gather of the affine table rows in sorted order, k-major so the
     fine scan reads them as (k, rows, lanes);
  4. the histogram of digits and its cumsum: C(d) = #(digit <= d);
  5. the fine scan (K3 "mixed"): inclusive prefixes inside blocks of
     k = 32 sorted points;
  6. the coarse scan (K3 "excl"): exclusive prefixes of the block totals;
  7. the Q_d gathers: Q_d = fine[C(d)-1] + coarse[(C(d)-1) div k] (K2 add);
  8. the telescope 255*S_total - sum_{d<255} Q_d, with sum_d Q_d as a
     halving tree of K2 adds and 255*S as 256*S - S (8 K2 doublings);
  9. the windows' sum (the tables carry the 2^(8w) factors): a halving tree.

Digit 0 contributes equally to every Q_d and cancels, so zero and masked
scalars cost nothing.
"""

from __future__ import annotations

import torch

from ..constants import NUM_LIMBS
from ..ff.field_kernels import ec_scan_rows
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
    device = scalars.device
    n_buckets = 1 << c_bits
    batch = scalars.shape[2]
    if n_windows % group or n % k:
        raise ValueError(f"group {group} / block {k} do not divide {n_windows} / {n}")
    n_groups = n_windows // group
    nb_blk = n // k
    idx_bits = max(1, (n - 1).bit_length())
    rows_in = L * comps * 2
    rows_out = L * comps * 3
    digits = digits_for_windows(scalars, n_windows, c_bits)  # (W, n, B)
    iota_n = torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    g_iota = torch.arange(group, dtype=torch.int64, device=device)[:, None, None]
    b_iota = torch.arange(batch, dtype=torch.int64, device=device)[None, None, :]
    inst = (torch.arange(batch, device=device) // (batch // n_instances)) * (n_windows * n)
    window_results = []
    for g in range(n_groups):
        dg = digits[g * group : (g + 1) * group]  # (G, n, B)
        # -- stable sort by digit via packed keys -------------------------
        skeys, _ = torch.sort((dg << idx_bits) | iota_n, dim=1)
        order = skeys & ((1 << idx_bits) - 1)
        # -- gather AoS table rows in sorted order, k-major ----------------
        base = (g * group + g_iota) * n + inst[None, None, :]
        flat = base + order  # (G, n, B); n splits as (NB, k)
        flat_k = flat.reshape(group, nb_blk, k, batch).permute(2, 0, 1, 3).reshape(-1)
        rows = tables_flat[flat_k]  # (k*G*NB*B, rows_in)
        # -- counts C(d) = #(digit <= d), d in [0, nb-2] --------------------
        hist = torch.zeros(group * n_buckets * batch, dtype=torch.int64, device=device)
        hist.index_add_(
            0,
            ((g_iota * n_buckets + dg) * batch + b_iota).reshape(-1),
            torch.ones(dg.numel(), dtype=torch.int64, device=device),
        )
        counts = hist.reshape(group, n_buckets, batch).cumsum(dim=1)[:, : n_buckets - 1]
        # -- intra-block inclusive prefixes: K3 mixed -----------------------
        lanes = group * nb_blk * batch
        xk = rows.reshape(k, lanes, rows_in).transpose(1, 2).contiguous()
        fine_k = ec_scan_rows(comps, xk, "mixed")  # (k, rows_out, lanes)
        # -- exclusive block prefixes: K3 excl over NB ----------------------
        totals = fine_k[k - 1]  # (rows_out, G*NB*B)
        tx = totals.reshape(rows_out, group, nb_blk, batch).permute(2, 0, 1, 3)
        coarse_k = ec_scan_rows(comps, tx.reshape(nb_blk, rows_out, group * batch).contiguous(), "excl")
        # -- Q_d gathers ----------------------------------------------------
        total_col = torch.full((group, 1, batch), n, dtype=torch.int64, device=device)
        c_all = torch.cat([counts, total_col], dim=1)  # (G, nb, B)
        idx = (c_all - 1).clamp(min=0)  # position in [0, n)
        fine_aos = fine_k.transpose(1, 2).reshape(-1, rows_out)  # lane order (j, g, nb, b)
        fflat = ((((idx % k) * group + g_iota) * nb_blk + idx // k) * batch + b_iota).reshape(-1)
        coarse_aos = coarse_k.transpose(1, 2).reshape(-1, rows_out)
        cflat = (((idx // k) * group + g_iota) * batch + b_iota).reshape(-1)

        def rows_to_soa(r):
            """(G*nb*B, rows_out) AoS -> (16, C, 3, G, nb, B)."""
            t = r.reshape(group, n_buckets, batch, L, comps, 3)
            return t.permute(3, 4, 5, 0, 1, 2).contiguous()

        q = cv.add(rows_to_soa(fine_aos[fflat]), rows_to_soa(coarse_aos[cflat]))
        ident = cv.identity_like(q)
        q = torch.where((c_all == 0)[None, None, None], ident, q)
        s_total = q[:, :, :, :, n_buckets - 1].contiguous()
        q[:, :, :, :, n_buckets - 1] = ident[:, :, :, :, n_buckets - 1]
        # -- sum_d Q_d: halving tree ----------------------------------------
        sum_q = tree_sum(cv, q, 4)
        # -- telescope: (2^c - 1) * S_total - sum Q -------------------------
        t = s_total
        for _ in range(c_bits):
            t = cv.double(t)
        t = cv.add(t, cv.neg(s_total))
        t = cv.add(t, cv.neg(sum_q))
        window_results.append(t)  # (16, C, 3, G, B)
    all_windows = torch.cat(window_results, dim=3)  # (16, C, 3, W, B)
    return tree_sum(cv, all_windows, 3)

