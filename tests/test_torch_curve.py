"""The plain versions of the EC kernels (K2 ec_op, K3 ec_scan_rows) and the
curve glue against the host big-integer curve (hostmath/bn254), in affine.

The inputs cover the identity, P = Q, P = -Q and the (0, 0) affine
sentinel; projective inputs carry random Z so the formulas see more than
Z = 1. Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from zerokit_tpu_torch.constants import Q, R
from zerokit_tpu_torch.ff import field_kernels as fk
from zerokit_tpu_torch.ff.field import FQ
from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
from zerokit_tpu_torch.groth16.curve import CurveOps
from zerokit_tpu_torch.hostmath import bn254

torch.set_num_threads(1)

CURVES = {
    1: (FqAdapter, bn254.G1, bn254.G1_GENERATOR, 0, 1),
    2: (Fq2Adapter, bn254.G2, bn254.G2_GENERATOR, (0, 0), (1, 0)),
}


def _fmul(comps, a, b):
    return a * b % Q if comps == 1 else bn254.fq2_mul(a, b)


def _rand_elem(comps, rng):
    v = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(comps)]
    return v[0] if comps == 1 else (v[0], v[1])


def encode_proj(comps, points, rng):
    """Host affine points (None = identity) -> (16, C, 3, n) with random Z."""
    ad, _, _, zero, one = CURVES[comps]
    coords = []
    for pt in points:
        if pt is None:
            coords += [zero, one, zero]
        else:
            z = _rand_elem(comps, rng)
            coords += [_fmul(comps, pt[0], z), _fmul(comps, pt[1], z), z]
    enc = ad.encode(coords).reshape(16, comps, len(points), 3)
    return enc.permute(0, 1, 3, 2).contiguous()


def encode_aff(comps, points):
    """Host affine points (None = the (0, 0) sentinel) -> (16, C, 2, n)."""
    ad, _, _, zero, _ = CURVES[comps]
    coords = []
    for pt in points:
        coords += [zero, zero] if pt is None else [pt[0], pt[1]]
    enc = ad.encode(coords).reshape(16, comps, len(points), 2)
    return enc.permute(0, 1, 3, 2).contiguous()


def decode_proj(comps, arr):
    """(16, C, 3, n) projective -> host affine points (None = identity)."""
    n = arr.shape[3]
    vals = FQ.decode(arr.reshape(16, -1))  # order (comp, coord, lane)
    vals = np.asarray(vals).reshape(comps, 3, n)
    out = []
    for j in range(n):
        if comps == 1:
            x, y, z = (int(vals[0, c, j]) for c in range(3))
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
        else:
            x, y, z = ((int(vals[0, c, j]), int(vals[1, c, j])) for c in range(3))
            if z == (0, 0):
                out.append(None)
                continue
            zi = bn254.fq2_inv(z)
            out.append((bn254.fq2_mul(x, zi), bn254.fq2_mul(y, zi)))
    return out


def sample_pairs(comps, rng, n_random):
    """(P, Q) host pairs: identity cases, P = Q, P = -Q, then random."""
    _, grp, gen, _, _ = CURVES[comps]
    pts = [grp.mul(gen, int(rng.integers(1, 1 << 62))) for _ in range(n_random + 1)]
    p0 = pts[0]
    pairs = [(None, p0), (p0, None), (None, None), (p0, p0), (p0, grp.neg(p0))]
    pairs += [(pts[i], pts[(i * 5 + 1) % len(pts)]) for i in range(1, n_random + 1)]
    return pairs


@pytest.mark.parametrize("op", ["add", "add_mixed", "double"])
@pytest.mark.parametrize("comps", [1, 2])
def test_ec_op_plain_matches_host(comps, op):
    rng = np.random.default_rng(10 * comps + len(op))
    _, grp, _, _, _ = CURVES[comps]
    pairs = sample_pairs(comps, rng, 5)
    ps = [a for a, _ in pairs]
    qs = [b for _, b in pairs]
    p = encode_proj(comps, ps, rng)
    if op == "add":
        q = encode_proj(comps, qs, rng)
        want = [grp.add(a, b) for a, b in pairs]
    elif op == "add_mixed":
        q = encode_aff(comps, qs)  # None -> the (0, 0) sentinel
        want = [grp.add(a, b) for a, b in pairs]
    else:
        q = None
        want = [grp.add(a, a) for a in ps]
    fk.reset_launches()
    got = fk.ec_op(op, comps, p, q)  # CPU tensors: the plain version
    assert fk.launches["ec_op"] == 0
    assert got.shape == p.shape
    assert decode_proj(comps, got) == want
    assert torch.equal(got, fk.ec_op_plain(op, comps, p, q))


def test_ec_op_batch_dims_and_shape_checks():
    rng = np.random.default_rng(3)
    pairs = sample_pairs(1, rng, 3)
    p = encode_proj(1, [a for a, _ in pairs] + [None], rng)  # 9 lanes
    q = encode_proj(1, [b for _, b in pairs] + [None], rng)
    flat = fk.ec_op("add", 1, p, q)
    shaped = fk.ec_op("add", 1, p.reshape(16, 1, 3, 3, 3), q.reshape(16, 1, 3, 3, 3))
    assert torch.equal(shaped.reshape(flat.shape), flat)
    with pytest.raises(ValueError):
        fk.ec_op("add", 1, p, q[:, :, :2])
    with pytest.raises(ValueError):
        fk.ec_op("triple", 1, p, q)


def _rows(comps, x, coords):
    """(16, C, coords, n) points -> (16*C*coords, n) limb-major rows."""
    return x.reshape(16 * comps * coords, x.shape[-1])


@pytest.mark.parametrize("kind", ["mixed", "excl"])
@pytest.mark.parametrize("comps", [1, 2])
def test_ec_scan_rows_plain_matches_host(comps, kind):
    rng = np.random.default_rng(20 * comps + len(kind))
    _, grp, gen, _, _ = CURVES[comps]
    k, n = 5, 4
    base = [grp.mul(gen, int(rng.integers(1, 1 << 62))) for _ in range(3)]
    # per lane a sequence of k points with repeats, negations and identities
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
    coords = 2 if kind == "mixed" else 3
    steps = []
    for j in range(k):
        col = [seqs[lane][j] for lane in range(n)]
        x = encode_aff(comps, col) if kind == "mixed" else encode_proj(comps, col, rng)
        steps.append(_rows(comps, x, coords))
    x_rows = torch.stack(steps).contiguous()
    fk.reset_launches()
    out = fk.ec_scan_rows(comps, x_rows, kind)
    assert fk.launches["ec_scan_rows"] == 0
    assert out.shape == (k, 16 * comps * 3, n)
    for j in range(k):
        got = decode_proj(comps, out[j].reshape(16, comps, 3, n))
        upto = j + 1 if kind == "mixed" else j
        want = []
        for lane in range(n):
            acc = None
            for pt in seqs[lane][:upto]:
                acc = grp.add(acc, pt)
            want.append(acc)
        assert got == want, (j, kind)


@pytest.mark.parametrize("comps", [1, 2])
def test_curve_glue_matches_host(comps):
    rng = np.random.default_rng(30 + comps)
    ad, grp, gen, _, _ = CURVES[comps]
    cv = CurveOps(ad)
    pts = [None] + [grp.mul(gen, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(5)]
    aff = encode_aff(comps, pts)
    proj = cv.from_affine(aff)
    assert decode_proj(comps, proj) == pts
    assert torch.equal(cv.to_affine(proj), aff)  # identity -> (0, 0)
    scaled = encode_proj(comps, pts, rng)
    assert torch.equal(cv.to_affine(scaled), aff)
    assert decode_proj(comps, cv.neg(scaled)) == [grp.neg(p) for p in pts]
    assert decode_proj(comps, cv.identity_like(scaled)) == [None] * len(pts)
    four = cv.add(cv.double(proj), cv.add_mixed(proj, aff))  # 2P + (P + P)
    assert decode_proj(comps, four) == [grp.mul(p, 4) for p in pts]
