"""Multi-rank dry run: batched proving over a ("dp", "tp") mesh of ranks.

    python -m zerokit_tpu_torch.parallel.dryrun N TIER [--device cuda|cpu]
        [--backend gloo|nccl] [--depth 10|20] [--timeout SECONDS]

starts N ranks (launch.py) on a mesh of tp = 2 when N is even (else 1) and
dp = N / tp, as the JAX package's dry run builds it, and runs one tier in
every rank. Counterpart of zerokit_tpu/parallel/dryrun.py:

  * pico  - a dp-sharded Montgomery product and a tp-sharded dot gathered
            over tp, checked against host big-int math;
  * toy   - the 2-constraint circuit: the QAP map on each dp rank's lanes
            (the lift sharded over tp), the A/B1/L MSMs through ShardedMSM
            at 4 windows of 4 bits (the toy witness values are < 2^16), G2
            and h on host integers; the proofs verify;
  * depth - the real RLN circuit of --depth levels (10 by default; 20 is
            the embedded default circuit) through RLN(mesh=): a batch of
            dp-size-class proofs from seeded members of a host tree; the
            first and last verify.

Every tier prints DRYRUN-<TIER>-OK. One card takes several gloo ranks (all
on cuda:0); NCCL needs a card a rank.

The rest of this module holds the rank bodies that the CPU tests
(tests/test_torch_parallel.py, tests/test_torch_ntt_sharded.py) and
chip_smoke.py launch: each builds its mesh, runs one piece of the mesh
path on inputs handed in as plain data, and returns plain data.
"""

from __future__ import annotations

import argparse
import pickle
import random
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import NUM_LIMBS, R
from ..ff.field import FrField, decode_canonical_fast, encode_canonical_fast
from .launch import launch
from .sharded import Mesh, all_gather, all_gather_object, make_mesh

_T0 = time.time()


def _log(mesh: Mesh, msg: str) -> None:
    print(f"[dryrun +{time.time() - _T0:6.1f}s rank {mesh.rank}] {msg}", flush=True)


def dryrun_mesh(device: str) -> Mesh:
    """tp = 2 when the world size is even, else 1; dp = world / tp."""
    world = dist.get_world_size()
    tp = 2 if world % 2 == 0 else 1
    return make_mesh(tp=tp, dp=world // tp, device=device)


def _fr_limbs(vals, mesh: Mesh) -> torch.Tensor:
    return encode_canonical_fast(vals).to(mesh.device)


def run_pico(mesh: Mesh) -> dict:
    """A dp-sharded Montgomery product and a tp-sharded dot + all_gather."""
    rng = random.Random(11)
    b, n = 4 * mesh.dp, 8 * mesh.tp
    a_ints = [rng.randrange(R) for _ in range(b)]
    b_ints = [rng.randrange(R) for _ in range(b)]
    per = b // mesh.dp
    mine = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    prod = FrField.mul(FrField.to_mont(_fr_limbs(a_ints[mine], mesh)),
                       FrField.to_mont(_fr_limbs(b_ints[mine], mesh)))
    parts = all_gather(mesh, FrField.from_mont(prod), "dp")  # (dp, 16, per)
    got = decode_canonical_fast(parts.permute(1, 0, 2).reshape(NUM_LIMBS, b).cpu())
    if got != [x * y % R for x, y in zip(a_ints, b_ints)]:
        raise AssertionError("pico: dp-sharded Montgomery product")
    _log(mesh, "pico: dp-sharded Montgomery product checked")

    v_ints = [rng.randrange(R) for _ in range(n)]
    s_ints = [rng.randrange(R) for _ in range(n)]
    per = n // mesh.tp
    mine = slice(mesh.tp_index * per, (mesh.tp_index + 1) * per)
    prod = FrField.mul(FrField.to_mont(_fr_limbs(v_ints[mine], mesh)),
                       FrField.to_mont(_fr_limbs(s_ints[mine], mesh)))
    parts = all_gather(mesh, FrField.from_mont(prod), "tp")  # (tp, 16, per)
    total = sum(decode_canonical_fast(parts.permute(1, 0, 2).reshape(NUM_LIMBS, n).cpu())) % R
    if total != sum(v * s for v, s in zip(v_ints, s_ints)) % R:
        raise AssertionError("pico: tp-sharded dot")
    _log(mesh, "pico: tp-sharded dot + all_gather checked")
    return {"rank": mesh.rank, "ok": True}


TOY_MATRICES = dict(  # public x; witness w1, w2; constraints w1*w1 = w2, w2*w1 = x
    num_instance_variables=2, num_witness_variables=2, num_constraints=2,
    a_num_non_zero=2, b_num_non_zero=2, c_num_non_zero=2,
    a=[[(1, 2)], [(1, 3)]], b=[[(1, 2)], [(1, 2)]], c=[[(1, 3)], [(1, 1)]],
)


def run_toy(mesh: Mesh) -> dict:
    """The 2-constraint circuit: dp-sharded QAP, tp-sharded A/B1/L MSMs."""
    from ..circuit.zkey import ConstraintMatrices
    from ..ff.fq2 import FqAdapter
    from ..groth16.qap import WitnessMapper
    from ..groth16.setup import groth16_setup
    from ..groth16.verifier import prepare_verifying_key, verify_proof
    from ..hostmath import bn254
    from .sharded import ShardedMSM

    matrices = ConstraintMatrices(**TOY_MATRICES)
    pk = groth16_setup(matrices, random.Random(5)).pk
    # witness values < 2^16 whatever dp is (w1 <= 18, so w1^3 < 2^16): the
    # 4 x 4-bit windows cover them exactly
    b = 2 * mesh.dp
    rows = []
    for i in range(b):
        w1 = 3 + i % 16
        rows.append([1, w1 ** 3, w1, w1 * w1])
    canon = encode_canonical_fast([rows[j][i] for i in range(4) for j in range(b)])
    canon = canon.reshape(NUM_LIMBS, 4, b).to(mesh.device)

    # dp: each rank maps its own lanes
    per = b // mesh.dp
    mine = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    h = WitnessMapper(matrices, mesh=mesh).witness_map(FrField.to_mont(canon[:, :, mine]))
    h_canon = FrField.from_mont(h).cpu()
    h_mine = [decode_canonical_fast(h_canon[:, :, j]) for j in range(per)]
    h_host = [lane for share in all_gather_object(mesh, h_mine, "dp") for lane in share]
    _log(mesh, "toy: dp-sharded QAP witness map done")

    # tp: the A/B1/L MSMs through the tensor-parallel path, all lanes back
    msm_a = ShardedMSM(pk.a_query, FqAdapter, mesh, n_windows=4, c_bits=4)
    msm_b1 = ShardedMSM(pk.b_g1_query, FqAdapter, mesh, n_windows=4, c_bits=4)
    msm_l = ShardedMSM(pk.l_query, FqAdapter, mesh, n_windows=4, c_bits=4)
    a_pts = msm_a.to_affine_ints(msm_a(canon))
    b1_pts = msm_b1.to_affine_ints(msm_b1(canon))
    l_pts = msm_l.to_affine_ints(msm_l(canon[:, 2:]))
    _log(mesh, "toy: tp-sharded MSMs A/B1/L done")
    if a_pts[0] != bn254.G1.msm(pk.a_query, rows[0]):
        raise AssertionError("toy: tp-sharded MSM A lane 0 != host MSM")

    proofs = []
    for j in range(b):
        r, s = (7 + j) % R, (11 + j) % R
        b2 = bn254.G2.msm(pk.b_g2_query, rows[j])
        hp = bn254.G1.msm(pk.h_query, h_host[j])
        g_a = bn254.G1.add(bn254.G1.add(pk.vk.alpha_g1, a_pts[j]), bn254.G1.mul(pk.delta_g1, r))
        g1_b = bn254.G1.add(bn254.G1.add(pk.beta_g1, b1_pts[j]), bn254.G1.mul(pk.delta_g1, s))
        g2_b = bn254.G2.add(bn254.G2.add(pk.vk.beta_g2, b2), bn254.G2.mul(pk.vk.delta_g2, s))
        g_c = bn254.G1.add(bn254.G1.mul(g_a, s), bn254.G1.mul(g1_b, r))
        g_c = bn254.G1.add(g_c, bn254.G1.neg(bn254.G1.mul(pk.delta_g1, r * s % R)))
        g_c = bn254.G1.add(bn254.G1.add(g_c, l_pts[j]), hp)
        proofs.append((g_a, g2_b, g_c))
    pvk = prepare_verifying_key(pk.vk)
    for j in (0, b - 1):
        if not verify_proof(pvk, proofs[j], [rows[j][1]]):
            raise AssertionError(f"toy: proof {j} invalid")
    _log(mesh, f"toy: {b} proofs assembled from the mesh's QAP and MSMs; verified")
    return {"rank": mesh.rank, "proofs": proofs}


def _rln(mesh: Mesh, depth: int):
    """RLN.stateless(mesh=) on the embedded single-message circuit of this
    depth (20: the package's default)."""
    from .. import RLN
    from ..resources import load_resource

    if depth == 20:
        return RLN.stateless(mesh=mesh)
    return RLN.stateless(zkey_bytes=load_resource(f"tree_depth_{depth}/rln_final.arkzkey"),
                         graph_bytes=load_resource(f"tree_depth_{depth}/graph.bin"), mesh=mesh)


def run_depth(mesh: Mesh, depth: int = 10) -> dict:
    """The real RLN circuit through RLN(mesh=): one batch of the mesh's
    size class from seeded members of a host tree."""
    from .. import hash_to_field_le, poseidon_hash, poseidon_hash_pair
    from ..protocol.witness import RLNWitnessInput
    from ..tree.merkle import OptimalMerkleTree

    t0 = time.perf_counter()
    rln = _rln(mesh, depth)
    _log(mesh, f"depth {depth}: sharded engine built in {time.perf_counter() - t0:.1f} s")
    b = rln.prover._batch_target(mesh.dp)
    tree = OptimalMerkleTree(depth, device="cpu")
    ext = poseidon_hash_pair(hash_to_field_le(b"dry-epoch"), hash_to_field_le(b"dry-app"))
    secrets = [hash_to_field_le(b"dry-%d" % i) for i in range(b)]
    for i, s in enumerate(secrets):
        tree.set(i, poseidon_hash_pair(poseidon_hash([s]), 10))
    witnesses = []
    for i, s in enumerate(secrets):
        mp = tree.proof(i)
        witnesses.append(RLNWitnessInput.new_single(
            s, 10, 1, mp.get_path_elements(), mp.get_path_index(),
            hash_to_field_le(b"m%d" % i), ext))
    t0 = time.perf_counter()
    out = rln.generate_proofs(witnesses, list(range(1, b + 1)), list(range(11, 11 + b)))
    _log(mesh, f"depth {depth}: batch of {b} proved over the mesh in "
               f"{time.perf_counter() - t0:.1f} s")
    for proof, values in (out[0], out[-1]):
        if not rln.verify(proof, values):
            raise AssertionError(f"depth {depth}: mesh proof invalid")
    _log(mesh, f"depth {depth}: first and last proofs verified under the embedded vk")
    return {"rank": mesh.rank, "proofs": [p for p, _ in out]}


TIERS = {"pico": run_pico, "toy": run_toy, "depth": run_depth}


def run_tier(tier: str, device: str, depth: int) -> dict:
    """Rank body of the command line: one tier on dryrun_mesh."""
    mesh = dryrun_mesh(device)
    _log(mesh, f"{tier} tier on {mesh}")
    return run_depth(mesh, depth) if tier == "depth" else TIERS[tier](mesh)


# ---------------------------------------------------------------------------
# Rank bodies of the CPU tests and of chip_smoke.py
# ---------------------------------------------------------------------------


def mesh_layout(tp: int, dp: int, device: str) -> dict:
    """The mesh's coordinates and groups, and the ValueError of a dp * tp
    that is not the world size."""
    mesh = make_mesh(tp=tp, dp=dp, device=device)
    try:
        make_mesh(tp=tp, dp=dp + 1, device=device)
        error = None
    except ValueError as e:
        error = str(e)
    return {
        "rank": mesh.rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index,
        "tp_ranks": dist.get_process_group_ranks(mesh.tp_group),
        "dp_ranks": dist.get_process_group_ranks(mesh.dp_group),
        "device": str(mesh.device), "backend": mesh.backend, "error": error,
    }


def sharded_msm_ints(tp: int, dp: int, device: str, points, scalars, g2: bool,
                     n_windows: int, c_bits: int) -> list:
    """ShardedMSM(points) of the scalar columns scalars[lane][i]: affine ints
    of every lane."""
    from ..ff.fq2 import Fq2Adapter, FqAdapter
    from .sharded import ShardedMSM

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    msm = ShardedMSM(points, Fq2Adapter if g2 else FqAdapter, mesh, n_windows, c_bits)
    b = len(scalars)
    canon = encode_canonical_fast([scalars[j][i] for i in range(len(points)) for j in range(b)])
    return msm.to_affine_ints(msm(canon.reshape(NUM_LIMBS, len(points), b).to(mesh.device)))


def sharded_msm_fn_ints(tp: int, dp: int, device: str, points, scalars) -> list:
    """sharded_msm (the one-shot form) of the scalar columns: affine ints of
    every lane."""
    from ..ff.fq2 import FqAdapter
    from ..groth16.msm import affine_ints
    from .sharded import sharded_msm

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    b = len(scalars)
    canon = encode_canonical_fast([scalars[j][i] for i in range(len(points)) for j in range(b)])
    acc = sharded_msm(FqAdapter, points, canon.reshape(NUM_LIMBS, len(points), b).to(mesh.device),
                      mesh)
    return affine_ints(FqAdapter, acc)


def sharded_fft_np(tp: int, dp: int, device: str, values: np.ndarray, inverse: bool,
                   lift_root=None) -> np.ndarray:
    """sharded_fft of values (16, B, N) int32 limbs; with lift_root, the
    sharded coset lift by that root, its rows gathered."""
    from . import ntt_sharded

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    x = torch.from_numpy(values).to(mesh.device)
    if lift_root is None:
        out = ntt_sharded.sharded_fft(x, mesh, inverse=inverse)
    else:
        out = ntt_sharded.gather_rows(ntt_sharded.sharded_coset_lift(x, mesh, lift_root), mesh)
    return out.cpu().numpy()


def witness_map_np(tp: int, dp: int, device: str, matrices, assignment: np.ndarray) -> dict:
    """The mesh WitnessMapper on this rank's dp share of the lanes of the
    Montgomery assignment (16, n_wires, B): its h lanes, and whether the
    lift was sharded."""
    from ..groth16.qap import WitnessMapper

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    mapper = WitnessMapper(matrices, mesh=mesh)
    per = assignment.shape[2] // dp
    mine = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    h = mapper.witness_map(torch.from_numpy(assignment[:, :, mine].copy()).to(mesh.device))
    return {"dp_index": mesh.dp_index, "h": h.cpu().numpy(), "sharded": mapper.mesh is not None}


def prove_np(tp: int, dp: int, device: str, zkey, assignment: np.ndarray, rs, ss,
             partial_mask=None) -> dict:
    """Groth16Prover(mesh=) on the whole Montgomery assignment (16, n_wires,
    B): the batch's proofs, and with partial_mask (over entries 1..) the
    partial + finish proof of lane 0 at (rs[0], ss[0])."""
    from ..groth16.prover import Groth16Prover

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    prover = Groth16Prover(zkey, None, mesh=mesh)
    x = torch.from_numpy(assignment).to(mesh.device)
    out = {"proofs": prover.prove_batch_with_assignment(x, rs, ss),
           "fused": prover._g1_group is not None, "sharded_lift": prover.mapper.mesh is not None}
    if partial_mask is not None:
        z = decode_canonical_fast(FrField.from_mont(x[:, :, 0]).cpu())
        partial = prover.prove_partial([v if k else None for v, k in zip(z[1:], partial_mask)])
        out["finished"] = prover.finish_proof(partial, x[:, :, :1], rs[0], ss[0])
    return out


def facade_scalars(tp: int, dp: int, device: str, zkey, count: int) -> list:
    """The blinding scalars RLN(mesh=) draws when the caller gives none."""
    from ..api import RLN

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    return RLN(zkey, None, mesh=mesh)._random_scalars(count)


def facade_values(tp: int, dp: int, device: str, witnesses) -> dict:
    """RLN(mesh=) on the depth-10 circuit: generate_proofs of the
    witnesses, whose values each dp rank reads from its own lanes' public
    wires and gathers over dp beside the MSM results. The witness map, the
    MSMs and the assembly are stand-ins (each lane's points and proof None;
    test_mesh_prover_equals_jax holds the mesh's proofs): the witness
    evaluator, the readout and the gather run. Returns the values, the
    counts and the stages."""
    from ..groth16.prover import _POINT_KEYS
    from ..runtime.profiling import PipelineMetrics

    mesh = make_mesh(tp=tp, dp=dp, device=device)
    rln = _rln(mesh, 10)
    rln.prover._affine_results = lambda part, metrics: {
        key: [None] * part.shape[2] for key in _POINT_KEYS}
    rln.prover._assemble_batch = lambda points, rs, ss, metrics: [None] * len(rs)
    metrics = PipelineMetrics()
    out = rln.generate_proofs(witnesses, metrics=metrics)
    return {"rank": mesh.rank, "proofs": [p for p, _ in out], "values": [v for _, v in out],
            "counts": metrics.counts, "stages": sorted(metrics.stages)}


def prove_file(path: str, device: str) -> dict:
    """chip_smoke.py phase 12's rank body. The file (written by this
    program's caller) holds the circuit's depth (20 unless given), the named
    inputs, r, s, the public inputs and the single-device proofs of one
    batch. RLN(mesh=) on dryrun_mesh proves the batch twice: the first
    (cold) batch, then, with the launch counters and the collective records
    at 0, the second. Both must equal the single-device proofs, and the
    second's proofs verify. Returns the rank's launch counts, stage times,
    wall clock and collective records of the second batch."""
    from ..groth16.verifier import prepare_verifying_key, verify_proof
    from ..runtime.profiling import PipelineMetrics, launch_counts, reset_launches

    with open(path, "rb") as f:
        job = pickle.load(f)
    mesh = dryrun_mesh(device)
    if mesh.device.type == "cuda" and torch.cuda.current_device() != mesh.device.index:
        raise AssertionError(f"rank {mesh.rank}: make_mesh left cuda:"
                             f"{torch.cuda.current_device()} current, not {mesh.device}")
    t0 = time.perf_counter()
    rln = _rln(mesh, job.get("depth", 20))
    ready = time.perf_counter() - t0
    prover = rln.prover
    named, rs, ss, want = job["named"], job["rs"], job["ss"], job["proofs"]
    t0 = time.perf_counter()
    cold = prover.prove_batch(named, rs, ss)
    cold_wall = time.perf_counter() - t0
    if cold != want:
        raise AssertionError(f"rank {mesh.rank}: the first batch differs from the single-device "
                             "proofs")
    reset_launches()
    mesh.collectives.clear()
    metrics = PipelineMetrics()
    t0 = time.perf_counter()
    proofs = prover.prove_batch(named, rs, ss, metrics=metrics)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    collectives = {k: dict(v) for k, v in mesh.collectives.items()}
    if proofs != want:
        raise AssertionError(f"rank {mesh.rank}: the second batch differs from the "
                             "single-device proofs")
    pvk = prepare_verifying_key(rln.zkey.pk.vk)
    for j, (proof, inputs) in enumerate(zip(proofs, job["public_inputs"])):
        if not verify_proof(pvk, proof, inputs):
            raise AssertionError(f"rank {mesh.rank}: proof {j} failed pairing verification")
    report = {
        "rank": mesh.rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index,
        "backend": mesh.backend, "device": str(mesh.device),
        "ready_s": ready, "cold_wall_s": cold_wall, "wall_s": wall,
        "stages": metrics.report()["stages"], "counts": counts, "collectives": collectives,
        "fused": prover._g1_group is not None, "sharded_lift": prover.mapper.mesh is not None,
    }
    print(f"[phase 12 rank {mesh.rank} {mesh}] {report}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", type=int)
    ap.add_argument("tier", choices=sorted(TIERS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    launch(args.world, "zerokit_tpu_torch.parallel.dryrun:run_tier",
           (args.tier, args.device, args.depth), backend=args.backend, timeout=args.timeout)
    print(f"DRYRUN-{args.tier.upper()}-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
