"""K3's two scans as the MSM pass runs them (ff/field_kernels.py
ec_scan_excl / ec_scan_gather, csrc/ec_scan.cu), through their plain
versions on the CPU.

The coarse scan splits each lane's k steps into `chunks` chunks (csrc/
ec_scan.cu's grouping); its prefixes are held against the host big-integer
curve (hostmath/bn254) in affine, for k not divisible by the chunk count,
more chunks than steps, k = 1, and sequences with identities, negations and
repeats. With one chunk it is the sequential scan, bit for bit. The fine
scan reads table rows through the index the pass's own sort makes; it must
equal the sequential mixed scan of the gathered rows bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_curve import CURVES, decode_proj, encode_aff, encode_proj
from zerokit_tpu_torch.constants import Q
from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.groth16.msm_fused import digits_for_windows, sorted_table_index

torch.set_num_threads(1)


def _sequences(comps, rng, k, n):
    """Per lane k host points: repeats of three bases, the identity (None)
    and negations."""
    _, grp, gen, _, _ = CURVES[comps]
    base = [grp.mul(gen, int(rng.integers(1, 1 << 62))) for _ in range(3)]
    seqs = []
    for lane in range(n):
        seq = []
        for j in range(k):
            pt = base[(lane + j) % 3]
            if (lane + j) % 4 == 1:
                pt = None
            elif (lane + 2 * j) % 5 == 3:
                pt = grp.neg(pt)
            seq.append(pt)
        seqs.append(seq)
    return seqs


def _proj_rows(comps, rng, seqs):
    """(k, 16*C*3, n) limb-major projective rows of the lanes' sequences."""
    k, n = len(seqs[0]), len(seqs)
    steps = [encode_proj(comps, [seqs[lane][j] for lane in range(n)], rng) for j in range(k)]
    return torch.stack([s.reshape(16 * comps * 3, n) for s in steps]).contiguous()


@pytest.mark.parametrize("k,chunks", [(7, 4), (3, 8), (1, 4), (12, 5), (6, 1)])
@pytest.mark.parametrize("comps", [1, 2])
def test_chunked_coarse_scan_matches_host(comps, k, chunks):
    rng = np.random.default_rng(100 * comps + 10 * k + chunks)
    _, grp, _, _, _ = CURVES[comps]
    n = 3
    seqs = _sequences(comps, rng, k, n)
    out = fk.ec_scan_rows_plain(comps, _proj_rows(comps, rng, seqs), "excl", chunks)
    assert out.shape == (k, 16 * comps * 3, n)
    for j in range(k):
        want = []
        for lane in range(n):
            acc = None
            for pt in seqs[lane][:j]:
                acc = grp.add(acc, pt)
            want.append(acc)
        assert decode_proj(comps, out[j].reshape(16, comps, 3, n)) == want, j


@pytest.mark.parametrize("comps", [1, 2])
def test_one_chunk_is_the_sequential_scan(comps):
    """chunks = 1 is the carry loop from the identity, bit for bit; more
    chunks give other representatives of the same points."""
    rng = np.random.default_rng(7 + comps)
    x = _proj_rows(comps, rng, _sequences(comps, rng, 6, 2))
    fq = fk.plain_adapter(comps)
    carry = fk.identity_points(comps, 2, "cpu")
    want = torch.empty_like(x)
    for j in range(6):
        want[j] = carry.reshape(-1, 2)
        carry = fk.rcb_add(fq, carry, x[j].reshape(16, comps, 3, 2))
    assert torch.equal(fk.ec_scan_rows_plain(comps, x, "excl", 1), want)
    four = fk.ec_scan_rows_plain(comps, x, "excl", 4)
    assert not torch.equal(four, want)
    for j in range(6):
        assert decode_proj(comps, four[j].reshape(16, comps, 3, 2)) == decode_proj(
            comps, want[j].reshape(16, comps, 3, 2))


@pytest.mark.parametrize("comps", [1, 2])
def test_coarse_scan_reads_strided_block_totals(comps):
    """ec_scan_excl on a strided (outer, k, inner, rows) view, as the pass
    gives it the fine prefixes' last row of every block, equals the plain
    scan of the same rows laid out densely."""
    rng = np.random.default_rng(40 + comps)
    outer, k, inner, rows = 2, 5, 3, 16 * comps * 3
    vals = rng.integers(0, 1 << 16, size=(outer, k, 4, inner, rows), dtype=np.int64)
    big = torch.from_numpy(vals.astype(np.int32))
    big[..., 15 * comps * 3:] %= Q >> 240  # top limbs below q's: values below q
    view = big[:, :, 3]
    got = fk.ec_scan_excl(comps, view, chunks=2)
    dense = view.permute(1, 3, 0, 2).reshape(k, rows, outer * inner)
    want = fk.ec_scan_rows_plain(comps, dense, "excl", 2)
    assert torch.equal(got, want.reshape(k, rows, outer, inner).permute(2, 0, 3, 1))
    with pytest.raises(ValueError):
        fk.ec_scan_excl(comps, view[..., :-1])
    with pytest.raises(ValueError):
        fk.ec_scan_excl(comps, view, chunks=fk.MAX_SCAN_CHUNKS + 1)


@pytest.mark.parametrize("comps", [1, 2])
def test_fine_scan_through_the_sorted_index(comps):
    """The pass's index (its own sort of seeded digits, two instances, the
    second window group of four windows) and ec_scan_gather on it, against
    a stable numpy argsort and the sequential mixed scan of the gathered
    rows."""
    rng = np.random.default_rng(50 + comps)
    n_windows, group, first, n, k, batch, n_inst = 4, 2, 2, 8, 4, 4, 2
    in_rows = 16 * comps * 2
    n_rows = n_inst * n_windows * n
    scalars = torch.from_numpy(rng.integers(0, 1 << 16, size=(16, n, batch)).astype(np.int32))
    digits = digits_for_windows(scalars, n_windows, 4)  # few buckets: many ties
    index = sorted_table_index(digits[first:first + group], first, n_windows, n_inst)
    assert index.dtype == torch.int32 and index.shape == (group, n, batch)
    for g in range(group):
        for b in range(batch):
            order = np.argsort(digits[first + g, :, b].numpy(), kind="stable")
            start = ((b // (batch // n_inst)) * n_windows + first + g) * n
            assert index[g, :, b].tolist() == (start + order).tolist()
    # random table rows (the formulas are polynomials) with (0, 0) sentinels
    table = torch.from_numpy(rng.integers(0, 1 << 16, size=(n_rows, in_rows)).astype(np.int32))
    table[:, 15 * comps * 2:] %= Q >> 240
    table[::5] = 0
    nb = n // k
    fk.reset_launches()
    fine = fk.ec_scan_gather(comps, table, index.view(group * nb, k, batch))
    assert fk.launches["ec_scan_gather"] == 0
    assert fine.shape == (group * nb, k, batch, 16 * comps * 3)
    lanes = [(g, blk, b) for g in range(group) for blk in range(nb) for b in range(batch)]
    x_rows = torch.stack([
        torch.stack([table[int(index[g, blk * k + j, b])] for g, blk, b in lanes], dim=1)
        for j in range(k)])  # (k, in_rows, lanes)
    want = fk.ec_scan_rows_plain(comps, x_rows, "mixed")
    for lane, (g, blk, b) in enumerate(lanes):
        for j in range(k):
            assert torch.equal(fine[g * nb + blk, j, b], want[j, :, lane]), (lane, j)


def test_scan_shape_checks():
    table = torch.zeros((4, 32), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.ec_scan_gather(1, table, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.ec_scan_gather(2, table, torch.zeros((1, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.ec_scan_excl(1, torch.zeros((2, 3, 48), dtype=torch.int32))
    for bad in (-1, 4):  # index values outside the table's rows
        with pytest.raises(RuntimeError, match="index values must lie in"):
            fk.ec_scan_gather(1, table, torch.tensor([[[0, 1], [bad, 3]]], dtype=torch.int32))
    fine = fk.ec_scan_gather(1, encode_aff(1, [None] * 4).reshape(32, 4).T.contiguous(),
                             torch.arange(4, dtype=torch.int32).view(1, 2, 2))
    assert decode_proj(1, fine.reshape(4, 48).T.reshape(16, 1, 3, 4)) == [None] * 4
