"""MSM and FusedMSMGroup (the single-pass fused MSM over the K2/K3 plain
versions) against the native host MSMs, exactly.

n = 64 runs unpadded in one scan block; n = 96 pads to PAD_GRANULARITY
(2048) points at infinity and runs 64 blocks of 32 with the coarse scan.
The bases include a point at infinity; the scalars include zeros and a
mask. The encoded bases must equal the JAX package's encoding.
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
