"""The port's multi-rank proving (zerokit_tpu_torch/parallel) on gloo process groups.

Counterpart of tests/test_parallel.py. Each case starts its ranks through
parallel/launch.py (spawned processes, a file store, a timeout on every
join), whose bodies live in parallel/dryrun.py and run on CPU tensors with
one torch thread; the results come back as plain data and are compared
here, exactly: the mesh's layout, ShardedMSM against the JAX package's host
MSM oracle (zerokit_tpu.groth16.msm_host), the pico and toy tiers, and the
slice as a whole: Groth16Prover(mesh=) at (dp, tp) = (2, 2) against the JAX
single-device prover at the same (r, s). _tree_reduce_points needs no
process group and runs here.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_prover import MATRICES, jax_prover_for
from zerokit_tpu.ff.fq2 import Fq2Adapter as JaxFq2, FqAdapter as JaxFq
from zerokit_tpu.groth16.msm_host import HostMSM
from zerokit_tpu_torch.constants import NUM_LIMBS, R
from zerokit_tpu_torch.ff import _cuda
from zerokit_tpu_torch.ff.field import FrField, encode_canonical_fast, to_numpy_limbs
from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
from zerokit_tpu_torch.groth16.curve import CurveOps
from zerokit_tpu_torch.groth16.msm import affine_ints, encode_affine_points
from zerokit_tpu_torch.groth16.setup import groth16_setup
from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.parallel.launch import LaunchError, launch
from zerokit_tpu_torch.parallel.sharded import (_tree_reduce_points, make_mesh,
                                                pad_points_for_sharding)
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.protocol.witness import RLNWitnessInput

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODIES = "zerokit_tpu_torch.parallel.dryrun"
TIMEOUT = 240  # seconds a launch may take before its ranks are killed


def run(world, body, *args):
    return launch(world, f"{BODIES}:{body}", args, timeout=TIMEOUT)


def host_points(rnd, n, g2):
    curve, gen = (bn254.G2, bn254.G2_GENERATOR) if g2 else (bn254.G1, bn254.G1_GENERATOR)
    return [curve.mul(gen, rnd.randrange(1, R)) for _ in range(n)]


def canon_np(scalars):
    """scalars[lane][i] -> (16, n, B) canonical limbs as numpy."""
    b, n = len(scalars), len(scalars[0])
    flat = [scalars[j][i] for i in range(n) for j in range(b)]
    return to_numpy_limbs(encode_canonical_fast(flat).reshape(NUM_LIMBS, n, b))


def test_make_mesh_layout():
    """rank = d * tp + t; tp groups are rows, dp groups columns; a dp * tp
    other than the world size raises ValueError."""
    out = run(4, "mesh_layout", 2, 2, "cpu")
    for r, o in enumerate(out):
        d, t = divmod(r, 2)
        assert (o["rank"], o["dp_index"], o["tp_index"]) == (r, d, t)
        assert o["tp_ranks"] == [2 * d, 2 * d + 1]
        assert o["dp_ranks"] == [t, t + 2]
        assert (o["device"], o["backend"]) == ("cpu", "gloo")
        assert o["error"] == "dp*tp = 6 != world size 4"


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError):
        make_mesh(tp=1)


def test_failed_rank_raises_in_the_caller():
    """A rank whose body raises makes launch kill the others and raise."""
    with pytest.raises(LaunchError, match="ValueError"):
        run(2, "mesh_layout", 3, 1, "cpu")


def test_hung_rank_is_killed_at_the_timeout():
    """Ranks that run past the launch's timeout are killed, and the caller
    raises within seconds of it."""
    t0 = time.monotonic()
    with pytest.raises(LaunchError, match="ran past 8 s"):
        launch(2, "time:sleep", (600,), timeout=8)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_tree_reduce_points(d, g2):
    """D projective partials (Z != 1, one of them the identity) -> their sum."""
    rnd = random.Random(30 + d)
    adapter, curve = (Fq2Adapter, bn254.G2) if g2 else (FqAdapter, bn254.G1)
    b = 2
    pts = host_points(rnd, d * b, g2)
    pts[0] = None
    cv = CurveOps(adapter)
    proj = cv.double(cv.from_affine(encode_affine_points(pts, adapter)))  # (16, C, 3, D*B)
    gathered = proj.reshape(proj.shape[:3] + (d, b)).permute(3, 0, 1, 2, 4)
    got = affine_ints(adapter, _tree_reduce_points(cv, gathered.contiguous()))
    for j in range(b):
        want = None
        for i in range(d):
            want = curve.add(want, curve.mul(pts[i * b + j], 2))
        assert got[j] == want


@pytest.mark.parametrize("tp,dp,g2", [(2, 2, False), (4, 1, False), (2, 1, True), (4, 1, True)],
                         ids=["tp2-dp2-G1", "tp4-G1", "tp2-G2", "tp4-G2"])
def test_sharded_msm_matches_host(tp, dp, g2):
    """ShardedMSM (its tp shard's tables, the tp gather and K2 tree, the dp
    split of 5 lanes) equals the host MSM oracle: G1 with full-range
    scalars, zero and r - 1 among them; G2 at 4 windows of 4 bits with
    scalars < 2^16, as the JAX package's test runs it (the prover's G2 MSM
    runs full range in test_mesh_prover_equals_jax)."""
    rnd = random.Random(9 + tp + 10 * g2)
    n, b = 37, 5
    points = host_points(rnd, n, g2)
    points[3] = None
    top = 1 << 16 if g2 else R
    scalars = [[rnd.randrange(top) for _ in range(n)] for _ in range(b)]
    scalars[1][0], scalars[2][5] = 0, top - 1
    windows = (4, 4) if g2 else (32, 8)
    got = run(tp * dp, "sharded_msm_ints", tp, dp, "cpu", points, scalars, g2, *windows)
    want = HostMSM(points, JaxFq2 if g2 else JaxFq)
    want = want.to_affine_ints(want(canon_np(scalars)))
    assert all(g == want for g in got)


def test_sharded_msm_function_matches_host():
    """sharded_msm, the one-shot form (a throwaway ShardedMSM, its 11 points
    padded with infinity inside), at tp = 2."""
    rnd = random.Random(19)
    n, b = 11, 3
    points = host_points(rnd, n, False)
    scalars = [[rnd.randrange(R) for _ in range(n)] for _ in range(b)]
    got = run(2, "sharded_msm_fn_ints", 2, 1, "cpu", points, scalars)
    for j in range(b):
        assert got[0][j] == got[1][j] == bn254.G1.msm(points, scalars[j])


def test_pad_points_for_sharding():
    """Pads with infinity to a multiple of the shard count, never past it."""
    pts = [(1, 2), (3, 4), (5, 6)]
    assert pad_points_for_sharding(pts, 2) == pts + [None]
    assert pad_points_for_sharding(pts, 3) == pts
    assert pad_points_for_sharding(pts, 8) == pts + [None] * 5


@pytest.mark.parametrize("tier,world", [("pico", 2), ("pico", 4), ("toy", 2), ("toy", 4)])
def test_dryrun_tier(tier, world):
    out = run(world, "run_tier", tier, "cpu", 10)
    if tier == "toy":
        assert all(o["proofs"] == out[0]["proofs"] for o in out)
        assert len(out[0]["proofs"]) == 2 * (world // 2)


def test_facade_draws_one_set_of_blinding_scalars():
    """RLN(mesh=) without r and s: every rank proves with rank 0's draws."""
    zkey = groth16_setup(MATRICES, random.Random(3))
    out = run(4, "facade_scalars", 2, 2, "cpu", zkey, 3)
    assert all(o == out[0] for o in out) and len(set(out[0])) == 3
    assert all(0 <= v < R for v in out[0])


def test_facade_values_over_the_mesh():
    """RLN(mesh=) at (dp, tp) = (2, 2) on the depth-10 circuit: each dp rank
    reads the public wires of its own lanes, and every rank's
    generate_proofs values, gathered over dp, equal the host's values of
    every witness (3 witnesses in a size class of 4: dp rank 1 holds a
    padding lane). The MSMs and the assembly are stand-ins in the ranks."""
    rnd = random.Random(18)
    ws = [RLNWitnessInput.new_single(rnd.randrange(R), 9, i, [rnd.randrange(R) for _ in range(10)],
                                     [rnd.randrange(2) for _ in range(10)], rnd.randrange(R),
                                     rnd.randrange(R))
          for i in range(3)]
    out = run(4, "facade_values", 2, 2, "cpu", ws)
    want = [proof_values_from_witness(w) for w in ws]
    for o in out:
        assert o["proofs"] == [None] * 3 and o["values"] == want
        assert o["counts"] == {"public_from_assignment": 3}
        assert "dp_gather" in o["stages"]


def test_mesh_prover_equals_jax():
    """The slice as a whole: Groth16Prover(mesh=) at (dp, tp) = (2, 2) on the
    2-constraint circuit (QAP lift sharded over tp, a/b1/l fused over the
    ShardedMSMs, 5 lanes split over dp) gives every rank the JAX
    single-device prover's proofs at the same (r, s), r = s = 0 included;
    they verify. A partial + finish proof under the mesh equals the full
    proof."""
    rnd = random.Random(77)
    zkey = groth16_setup(MATRICES, rnd)
    batch = 5
    rows = []
    for _ in range(batch):
        w1 = rnd.randrange(R)
        rows.append([1, w1 * w1 % R * w1 % R, w1, w1 * w1 % R])
    canon = encode_canonical_fast([rows[j][i] for i in range(4) for j in range(batch)])
    assignment = to_numpy_limbs(FrField.to_mont(canon.reshape(NUM_LIMBS, 4, batch)))
    rs = [rnd.randrange(R) for _ in range(batch)]
    ss = [rnd.randrange(R) for _ in range(batch)]
    rs[3], ss[3] = 0, 0
    mask = [False, True, False]  # w1 known, x and w2 not
    out = run(4, "prove_np", 2, 2, "cpu", zkey, np.ascontiguousarray(assignment), rs, ss, mask)
    want = jax_prover_for(zkey, 2, 4).prove_batch_with_assignment(assignment, rs, ss)
    pvk = prepare_verifying_key(zkey.pk.vk)
    for o in out:
        assert o["fused"] and o["sharded_lift"]
        assert o["proofs"] == want
        assert o["finished"] == want[0]
    for j in range(batch):
        assert verify_proof(pvk, want[j], [rows[j][1]])


NVCC_STUB = """#!/bin/sh
echo "$@" >> "$STUB_LOG"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
"""

BUILD_CHILD = """
import json, os, sys, time
from zerokit_tpu_torch.ff import _cuda
_cuda.BUILD_DIR = sys.argv[1]
open(os.path.join(sys.argv[2], "ready.%d" % os.getpid()), "w").close()
while sum(f.startswith("ready.") for f in os.listdir(sys.argv[2])) < 2:
    time.sleep(0.01)
path = _cuda.build()
print(json.dumps({"path": path, "built": _cuda.build_info["built"]}))
"""


def test_two_processes_build_the_kernels_once(tmp_path):
    """Two processes that reach ff/_cuda.build together (as the ranks of a
    mesh do on a fresh checkout) run nvcc for one build: the second waits on
    the build directory's lock and finds the first's library. nvcc is a
    stub that logs its calls and writes its -o file."""
    stub_home = tmp_path / "cuda"
    (stub_home / "bin").mkdir(parents=True)
    nvcc = stub_home / "bin" / "nvcc"
    nvcc.write_text(NVCC_STUB)
    nvcc.chmod(0o755)
    log, build_dir, sync = tmp_path / "nvcc.log", tmp_path / "build", tmp_path / "sync"
    sync.mkdir()
    env = dict(os.environ, CUDA_HOME=str(stub_home), STUB_LOG=str(log), PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CHILD, str(build_dir), str(sync)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    n_sources = sum(name.endswith(".cu") for name in _cuda.SOURCES)
    assert len(log.read_text().splitlines()) == n_sources + 1  # each source, then the link
    assert sorted(o["built"] for o in outs) == [False, True]
    assert outs[0]["path"] == outs[1]["path"] and os.path.exists(outs[0]["path"])
