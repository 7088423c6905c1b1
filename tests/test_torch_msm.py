"""MSM and FusedMSMGroup (the single-pass fused MSM over the K2/K3 plain
versions) against the native host MSMs, exactly.

n = 64 runs unpadded in one scan block; n = 96 pads to PAD_GRANULARITY
(2048) points at infinity and runs 64 blocks of 32 with the coarse scan.
The bases include a point at infinity; the scalars include zeros and a
mask. The encoded bases must equal the JAX package's encoding. Then the
one-shot msm_accumulate, the chunked table build, and the window-group
rule: unchanged at the proving path's widths, capped by the fine rows'
bytes at 2^22 points.
"""

import functools

import numpy as np
import pytest
import torch

from zerokit_tpu.ff import fq2 as jfq2
from zerokit_tpu.groth16.msm import encode_affine_points as jax_encode_affine_points
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import encode_canonical_fast, from_numpy_limbs
from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
from zerokit_tpu_torch.groth16 import msm as msm_mod
from zerokit_tpu_torch.groth16.curve import CurveOps
from zerokit_tpu_torch.groth16.msm import PAD_GRANULARITY, MSM, FusedMSMGroup
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.runtime import native

torch.set_num_threads(1)

CURVES = {
    "g1": (FqAdapter, jfq2.FqAdapter, bn254.G1, bn254.G1_GENERATOR, native.g1_msm_native),
    "g2": (Fq2Adapter, jfq2.Fq2Adapter, bn254.G2, bn254.G2_GENERATOR, native.g2_msm_native),
}
BATCH = 4


@functools.lru_cache(maxsize=None)
def bases(curve: str, n: int, which: int):
    """n seeded points (multiples of the generator), one at infinity."""
    _, _, grp, gen, _ = CURVES[curve]
    rng = np.random.default_rng(1000 * n + 10 * which + len(curve))
    step = grp.mul(gen, int.from_bytes(rng.bytes(32), "little") % R)
    pts, acc = [], step
    for _ in range(n):
        pts.append(acc)
        acc = grp.add(acc, step)
    pts[n // 3] = None
    return tuple(pts)


@functools.lru_cache(maxsize=None)
def msm_for(curve: str, n: int, which: int = 0) -> MSM:
    """Built once per module: the window tables are the slow part here."""
    return MSM(list(bases(curve, n, which)), CURVES[curve][0], "cpu")


def scalars_and_mask(rng, n, batch):
    """(n, B) ints with a zero row and scattered zeros, and a mask."""
    vals = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(batch)] for _ in range(n)]
    vals[1] = [0] * batch
    for i in range(0, n, 7):
        vals[i][i % batch] = 0
    vals[2][0] = R - 1
    mask = rng.random((n, batch)) > 0.2
    return vals, mask


def encode_scalars(vals):
    n, batch = len(vals), len(vals[0])
    return encode_canonical_fast([vals[i][b] for i in range(n) for b in range(batch)]).reshape(
        16, n, batch
    )


def native_msm(curve, pts, vals, mask, b):
    scal = [vals[i][b] if mask is None or mask[i, b] else 0 for i in range(len(pts))]
    return CURVES[curve][4](list(pts), scal)


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_matches_native(curve, n):
    msm = msm_for(curve, n)
    assert msm.n == (n if n <= 64 else PAD_GRANULARITY)
    jax_enc = jax_encode_affine_points(list(bases(curve, n, 0)), CURVES[curve][1])
    assert torch.equal(msm.points[..., :n], from_numpy_limbs(jax_enc, "cpu"))
    assert not msm.points[..., n:].any()  # padding: (0, 0) points at infinity
    rng = np.random.default_rng(n + len(curve))
    vals, mask = scalars_and_mask(rng, n, BATCH)
    got = msm.to_affine_ints(msm(encode_scalars(vals), mask))
    pts = bases(curve, n, 0)
    assert got == [native_msm(curve, pts, vals, mask, b) for b in range(BATCH)]


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_fused_group_matches_native(curve, n):
    """Members of one padded size over different bases; at n = 96 the
    second member holds fewer real points, as the l query does."""
    sizes = [n, n if n <= 64 else n - 6]
    members = [msm_for(curve, size, which) for which, size in enumerate(sizes)]
    group = FusedMSMGroup(members)
    rng = np.random.default_rng(7 * n + len(curve))
    inputs = [scalars_and_mask(rng, size, BATCH) for size in sizes]
    accs = group([encode_scalars(v) for v, _ in inputs], [m for _, m in inputs])
    for which, (msm, acc, (vals, mask)) in enumerate(zip(members, accs, inputs)):
        pts = bases(curve, sizes[which], which)
        want = [native_msm(curve, pts, vals, mask, b) for b in range(BATCH)]
        assert msm.to_affine_ints(acc) == want


def test_lane_streaming_and_ragged_tail():
    """Batches wider than the lane batch stream through padded passes."""
    msm = MSM(list(bases("g1", 64, 0)), FqAdapter, "cpu")
    msm.lane_batch = 2
    rng = np.random.default_rng(3)
    vals, _ = scalars_and_mask(rng, 64, 3)
    got = msm.to_affine_ints(msm(encode_scalars(vals)))
    pts = bases("g1", 64, 0)
    assert got == [native_msm("g1", pts, vals, None, b) for b in range(3)]


def test_group_rejects_mismatched_members():
    with pytest.raises(ValueError):
        FusedMSMGroup([msm_for("g1", 64)])
    with pytest.raises(ValueError):
        FusedMSMGroup([msm_for("g1", 64), MSM(list(bases("g1", 32, 0)), FqAdapter, "cpu")])


# (n_windows, c_bits, scalar bits): G2 at 4 windows of 8 bits keeps the
# plain versions' time down; scalars then stay below 2^32
ACCUMULATE = {"g1": (32, 8, 256), "g2": (4, 8, 32)}


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_accumulate_matches_native(curve):
    """The one-shot MSM from a tensor of affine points (tables built on the
    fly, one fused pass) against the native host MSM, every lane."""
    adapter = CURVES[curve][0]
    n_windows, c_bits, bits = ACCUMULATE[curve]
    n, batch = 8, 2
    pts = bases(curve, n, 0)
    rng = np.random.default_rng(11 + len(curve))
    vals = [[int.from_bytes(rng.bytes(32), "little") % min(R, 1 << bits) for _ in range(batch)]
            for _ in range(n)]
    vals[1][0] = 0
    points = msm_mod.encode_affine_points(list(pts), adapter)
    acc = msm_mod.msm_accumulate(adapter, points, encode_scalars(vals), n_windows, c_bits)
    assert acc.shape == (16, adapter.components, 3, batch)
    want = [native_msm(curve, pts, vals, None, b) for b in range(batch)]
    assert msm_mod.affine_ints(adapter, acc) == want


def test_table_rows_in_chunks_equal_one_build(monkeypatch):
    """A table build in chunks of points (TABLE_CHUNK, which bounds a large
    build's transients) gives the rows of one build; the padding rows are
    (0, 0)."""
    cv = CurveOps(FqAdapter)
    points = msm_mod.encode_affine_points(list(bases("g1", 7, 0)), FqAdapter)
    whole = msm_mod.table_rows(cv, points, 10, n_windows=2)
    monkeypatch.setattr(msm_mod, "TABLE_CHUNK", 3)
    chunked = msm_mod.table_rows(cv, points, 10, n_windows=2)
    assert torch.equal(chunked, whole)
    rows = whole.view(2, 10, -1)
    assert not rows[:, 7:].any()
    tables = msm_mod.build_window_tables(cv, points, n_windows=2)
    assert torch.equal(rows[:, :7], msm_mod.tables_to_aos_s(FqAdapter, tables[None])[0]
                       .view(2, 7, -1))


def _group_before_the_fine_cap(batch, comps):
    g = 32
    while g > 2 and g * batch * comps > msm_mod.MAX_CGB:
        g //= 2
    return g


def test_window_groups_at_depth20_proving_widths_unchanged():
    """Every pass of the depth-20 prover (a/b1/l fused, b2 on G2, h; 1-16
    proofs a pass) keeps the window group of the C*G*B rule alone: the
    fine-row cap binds only above the proving path's widths. Mesh shards
    hold fewer points, so they are covered too."""
    from zerokit_tpu_torch.resources import load_circuit

    pk = load_circuit(20)[0].pk

    def padded(count):
        return -(-count // PAD_GRANULARITY) * PAD_GRANULARITY

    passes = [(1, 3, padded(len(pk.a_query))), (2, 1, padded(len(pk.b_g2_query))),
              (1, 1, padded(len(pk.h_query)))]
    assert [n for _, _, n in passes] == [6144, 6144, 8192]
    for comps, members, n in passes:
        for batch in range(1, msm_mod.LANE_BATCH + 1):
            lanes = members * batch
            assert (msm_mod._window_group(lanes, comps, n=n)
                    == _group_before_the_fine_cap(lanes, comps))


def test_window_group_caps_fine_rows_of_a_2e22_pass():
    """A 2^22-point G1 pass of 4 lanes kept 32 windows a group before the
    cap: 103 GB of fine rows, more than the card's 80 GB."""
    n, lanes = 1 << 22, 4
    assert _group_before_the_fine_cap(lanes, 1) == 32
    assert msm_mod.FINE_ROW_BYTES * 32 * n * lanes > 80e9
    g = msm_mod._window_group(lanes, 1, n=n)
    assert g == 2
    assert msm_mod.FINE_ROW_BYTES * g * n * lanes <= msm_mod.MAX_FINE_BYTES
