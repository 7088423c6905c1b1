"""K2's Q_d add through row indices (ff/field_kernels.py ec_add_gather,
csrc/field_kernels.cu ec_add_gather<Curve>) and the MSM pass's bucket rows
(groth16/msm_fused.py bucket_counts, bucket_rows), through their plain
versions on the CPU.

The plain version must equal what the pass did before the kernel existed
(two gathers into SoA, ec_op_plain "add", the identity where the bucket is
empty) bit for bit, and the host big-integer curve in affine, with empty
buckets, repeated indices and identity rows.
"""

import numpy as np
import pytest
import torch

from test_torch_curve import CURVES, decode_proj, encode_proj
from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.groth16.msm_fused import bucket_counts, bucket_rows

torch.set_num_threads(1)


def _rows(comps, rng, points):
    """AoS projective rows (len(points), 16*C*3) of host points (None = the
    identity) with random Z."""
    x = encode_proj(comps, points, rng)  # (16, C, 3, n)
    return x.permute(3, 0, 1, 2).reshape(len(points), -1).contiguous()


def _case(comps, seed):
    rng = np.random.default_rng(seed)
    _, grp, gen, _, _ = CURVES[comps]
    base = [grp.mul(gen, int(rng.integers(1, 1 << 62))) for _ in range(3)]
    fine_pts = [base[0], None, base[1], grp.neg(base[0]), base[2]]
    coarse_pts = [None, base[0], base[2]]
    fidx = torch.tensor([[0, 1, 2], [3, 3, 4], [0, 4, 1]], dtype=torch.int32)  # repeats
    cidx = torch.tensor([[0, 1, 2], [1, 1, 0], [2, 2, 1]], dtype=torch.int32)
    empty = torch.tensor([[False, False, True], [False, False, False], [True, False, False]])
    return (grp, fine_pts, coarse_pts, _rows(comps, rng, fine_pts), fidx,
            _rows(comps, rng, coarse_pts), cidx, empty)


@pytest.mark.parametrize("comps", [1, 2])
def test_ec_add_gather_plain_is_the_pass_s_old_torch_code(comps):
    grp, fine_pts, coarse_pts, fine, fidx, coarse, cidx, empty = _case(comps, 60 + comps)
    got = fk.ec_add_gather_plain(comps, fine, fidx, coarse, cidx, empty)
    assert got.shape == (16, comps, 3, 3, 3)

    def rows_to_soa(r):  # the pass's old (M, rows) AoS -> (16, C, 3, M)
        return r.reshape(-1, 16, comps, 3).permute(1, 2, 3, 0).contiguous()

    q = fk.ec_op_plain("add", comps, rows_to_soa(fine[fidx.reshape(-1).long()]),
                       rows_to_soa(coarse[cidx.reshape(-1).long()]))
    ident = fk.identity_points(comps, q.shape[-1], "cpu")
    want = torch.where(empty.reshape(-1)[None, None, None], ident, q)
    assert torch.equal(got.reshape(want.shape), want)
    host = [None if e else grp.add(fine_pts[f], coarse_pts[c])
            for f, c, e in zip(fidx.reshape(-1).tolist(), cidx.reshape(-1).tolist(),
                               empty.reshape(-1).tolist())]
    assert decode_proj(comps, got.reshape(16, comps, 3, -1)) == host


@pytest.mark.parametrize("comps", [1, 2])
def test_ec_add_gather_on_cpu_takes_the_plain_version(comps):
    _, _, _, fine, fidx, coarse, cidx, empty = _case(comps, 70 + comps)
    fk.reset_launches()
    got = fk.ec_add_gather(comps, fine, fidx, coarse, cidx, empty)
    assert fk.launches["ec_add_gather"] == 0
    assert torch.equal(got, fk.ec_add_gather_plain(comps, fine, fidx, coarse, cidx, empty))


@pytest.mark.parametrize("which,bad", [("fidx", -1), ("fidx", 5), ("cidx", -2), ("cidx", 3)])
def test_ec_add_gather_index_out_of_range_raises(which, bad):
    _, _, _, fine, fidx, coarse, cidx, empty = _case(1, 80)
    idx = {"fidx": fidx.clone(), "cidx": cidx.clone()}
    idx[which][1, 2] = bad
    with pytest.raises(RuntimeError, match=f"ec_add_gather: {which} values must lie in"):
        fk.ec_add_gather(1, fine, idx["fidx"], coarse, idx["cidx"], empty)


def test_ec_add_gather_shape_checks():
    _, _, _, fine, fidx, coarse, cidx, empty = _case(1, 90)
    with pytest.raises(ValueError):
        fk.ec_add_gather(1, fine[:, :-1], fidx, coarse, cidx, empty)
    with pytest.raises(ValueError):
        fk.ec_add_gather(2, fine, fidx, coarse, cidx, empty)  # G1 rows as G2
    with pytest.raises(ValueError):
        fk.ec_add_gather(1, fine, fidx, coarse, cidx[:2], empty)
    with pytest.raises(TypeError):
        fk.ec_add_gather(1, fine, fidx.long(), coarse, cidx, empty)
    with pytest.raises(TypeError):
        fk.ec_add_gather(1, fine, fidx, coarse, cidx, empty.to(torch.int32))
    with pytest.raises(ValueError):
        fk.ec_add_gather(1, fine, fidx, coarse, cidx, empty, threads=512)


def test_bucket_rows_from_the_pass_s_counts():
    """Digits of two windows and three lanes, 4 buckets, n = 4 points in
    blocks of k = 2: counts, each bucket's last sorted point and its block,
    and the empty buckets, against a hand-written loop."""
    rng = np.random.default_rng(5)
    group, n, batch, nb, k = 2, 4, 3, 4, 2
    dg = torch.from_numpy(rng.integers(0, nb, size=(group, n, batch)))
    dg[0, :, 0] = 3  # every point in the last bucket: buckets 0-2 empty
    counts = bucket_counts(dg, nb)
    fidx, cidx, empty = bucket_rows(counts, n, k)
    assert fidx.dtype == cidx.dtype == torch.int32 and empty.dtype == torch.bool
    for g in range(group):
        for b in range(batch):
            digits = dg[g, :, b].tolist()
            for d in range(nb):
                c = n if d == nb - 1 else sum(1 for x in digits if x <= d)
                assert counts.shape == (group, nb - 1, batch)
                if d < nb - 1:
                    assert int(counts[g, d, b]) == c
                pos = max(c - 1, 0)
                assert int(fidx[g, d, b]) == (g * n + pos) * batch + b
                assert int(cidx[g, d, b]) == (g * (n // k) + pos // k) * batch + b
                assert bool(empty[g, d, b]) == (c == 0)
    assert empty[0, :3, 0].all()
