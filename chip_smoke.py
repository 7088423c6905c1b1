"""Drives zerokit_tpu_torch's proving path once on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases: (1) device, (2) build of the CUDA kernels from csrc/ and load of
the depth-20 circuit, (3) every kernel against its plain PyTorch version,
bit for bit, on the same tensors on the card, at the shapes the proving
path gives it, with both timed on the card, (4) a batch of 16 depth-20 RLN
proofs through Groth16Prover.prove_batch with pairing verification and
lane-0 MSMs held against the native host MSMs, (5) a second, warm batch,
(6) the kernels' launch counts in the proving run of phase 4. Any failed
check raises, so the script exits non-zero. It imports no JAX. The line
before the last is the kernel JSON, the last line the device JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEPTH, BATCH = 20, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn() over reps calls, by CUDA events; one
    warm-up call first unless the caller has just run fn."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def random_elems(rng, p: int, n: int) -> np.ndarray:
    """(16, n) limbs of seeded values < p, with 0, 1 and p-1 in lanes 0-2."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= (p >> 240) & 0xFFFF
    for j, v in enumerate((0, 1, p - 1)):
        limbs[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return limbs


def on_card(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).cuda()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    """Runs kernel and plain version on the same card tensors, requires
    equal integers, and keeps each check's error and times."""

    def __init__(self):
        self.errors: dict = {}
        self.times: dict = {}

    def run(self, key: str, what: str, kernel, plain, reps: int = 10) -> None:
        got = kernel()
        want = plain()  # also the plain version's warm-up
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"  {key} {what}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{key} {what}: kernel disagrees with its plain version")
        self.errors.setdefault(key, []).append(err)
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, 1, warm=False)
        self.times.setdefault(key, (ms, plain_ms, what))
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.2f} ms (both on the card)")


def ec_inputs(rng, comps: int, n: int):
    """p, q (16, C, 3, n) of seeded field elements (the formulas are
    polynomials, so any values compare), with curve points in lanes 0-3:
    (identity, P), (P, P), (P, -P), (P, identity)."""
    from zerokit_tpu_torch.constants import Q
    from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
    from zerokit_tpu_torch.hostmath import bn254

    p = random_elems(rng, Q, comps * 3 * n).reshape(16, comps, 3, n)
    q = random_elems(rng, Q, comps * 3 * n).reshape(16, comps, 3, n)
    if comps == 1:
        ad, grp, gen, zero, one = FqAdapter, bn254.G1, bn254.G1_GENERATOR, 0, 1
    else:
        ad, grp, gen, zero, one = Fq2Adapter, bn254.G2, bn254.G2_GENERATOR, (0, 0), (1, 0)
    pt = grp.mul(gen, 12345)

    def proj(point):
        coords = [zero, one, zero] if point is None else [point[0], point[1], one]
        return ad.encode(coords).reshape(16, comps, 3).numpy()

    for j, (a, b) in enumerate([(None, pt), (pt, pt), (pt, grp.neg(pt)), (pt, None)]):
        p[:, :, :, j] = proj(a)
        q[:, :, :, j] = proj(b)
    return p, q


def main_path_shapes(prover) -> dict:
    """The widths the proving path of one BATCH gives the curve kernels:
    the fine and coarse scans and the bucket adds of the a/b1/l group (G1)
    and of b2 (G2)."""
    from zerokit_tpu_torch.groth16.msm import N_BUCKETS, _window_group, block_size_for

    shapes = {}
    for comps, msm, members in ((1, prover.msm_a, 3), (2, prover.msm_b2, 1)):
        lanes = members * BATCH
        g = _window_group(lanes, comps)
        k = block_size_for(msm.n)
        nb = msm.n // k
        shapes[comps] = {"fine": (k, g * nb * lanes), "coarse": (nb, g * lanes),
                         "buckets": g * N_BUCKETS * lanes}
    return shapes


def phase_kernels(rng, prover) -> KernelChecks:
    from zerokit_tpu_torch.constants import Q, R
    from zerokit_tpu_torch.ff import field_kernels as fk
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.groth16 import ntt as ntt_host

    checks = KernelChecks()
    shapes = main_path_shapes(prover)
    log(f"  main-path widths: {shapes}")
    # K1 ----------------------------------------------------------------
    n1 = 1 << 17
    for name, p in (("fr", R), ("fq", Q)):
        a = on_card(random_elems(rng, p, n1))
        b = on_card(random_elems(rng, p, n1)[:, ::-1])
        checks.run("K1", f"mont_mul {name}, {n1} lanes",
                   lambda: fk.mont_mul(name, a, b), lambda: fk.mont_mul_plain(name, a, b))
    # K2 ----------------------------------------------------------------
    for comps in (1, 2):
        n2 = shapes[comps]["buckets"]
        p_np, q_np = ec_inputs(rng, comps, n2)
        p = on_card(p_np)
        for op in ("add", "add_mixed", "double"):
            if op == "double":
                q = None
            elif op == "add":
                q = on_card(q_np)
            else:
                aff = q_np[:, :, :2].copy()
                aff[:, :, :, 3] = 0  # the (0, 0) affine sentinel
                q = on_card(aff)
            checks.run("K2", f"ec_op g{comps} {op}, {n2} lanes",
                       lambda: fk.ec_op(op, comps, p, q), lambda: fk.ec_op_plain(op, comps, p, q))
    # K3 ----------------------------------------------------------------
    for comps in (1, 2):
        for kind, stage in (("mixed", "fine"), ("excl", "coarse")):
            k, n = shapes[comps][stage]
            coords = 2 if kind == "mixed" else 3
            rows = 16 * comps * coords
            x_np = (random_elems(rng, Q, k * rows * n // 16)
                    .reshape(16, k, rows // 16, n).transpose(1, 0, 2, 3).reshape(k, rows, n))
            if kind == "mixed":  # a (0, 0) affine sentinel in lane 1 of every step
                x_np.reshape(k, 16, comps, 2, n)[:, :, :, :, 1] = 0
            x = on_card(x_np)
            checks.run("K3", f"ec_scan g{comps} {kind} ({stage}), k={k}, N={n}",
                       lambda: fk.ec_scan_rows(comps, x, kind),
                       lambda: fk.ec_scan_rows_plain(comps, x, kind), reps=3)
    # K4 + K5 at the witness map's shape: a/b/c of BATCH lanes -------------
    n_dom, rows_3b = prover.mapper.domain_size, 3 * BATCH
    root = ntt_host.coset_root_2n(n_dom)
    x = on_card(random_elems(rng, R, rows_3b * n_dom).reshape(16, rows_3b, n_dom))
    for inverse, direction in ((True, "dif"), (False, "dit")):
        m = n_dom // 2
        while m >= nk.tail_size(n_dom):
            tw = nk._stage_tw(n_dom, m, inverse, "cuda")
            checks.run("K4", f"ntt_stage {direction} m={m}, (16, {rows_3b}, {n_dom})",
                       lambda: nk.ntt_stage(x, tw, m, direction),
                       lambda: nk.ntt_stage_plain(x, tw, m, direction))
            m //= 2
        tail_tw = nk._tail_tw(n_dom, inverse, "cuda")
        for table in (nk._coset_table(n_dom, root, "cuda"), None):
            fused = "with" if table is not None else "without"
            checks.run("K5", f"ntt_tail {direction} {fused} table, (16, {rows_3b}, {n_dom})",
                       lambda: nk.ntt_tail(x, tail_tw, table, direction),
                       lambda: nk.ntt_tail_plain(x, tail_tw, table, direction))
    checks.run("K4+K5", f"coset_lift_bn, (16, {rows_3b}, {n_dom})",
               lambda: nk.coset_lift_bn(x, root),
               lambda: ntt_host.coset_lift(x.transpose(1, 2), root).transpose(1, 2), reps=3)
    return checks


# ---------------------------------------------------------------------------
# Phases 4-6: the proving path
# ---------------------------------------------------------------------------


def named_inputs(rng, batch: int, depth: int):
    """Batched witness inputs shaped like RLN.generate_proofs builds them
    (name -> slots -> lanes): seeded Fr values, userMessageLimit 100,
    messageId 1."""
    from zerokit_tpu_torch.constants import R

    def fr():
        return int.from_bytes(rng.bytes(32), "little") % R

    lanes = []
    for _ in range(batch):
        lanes.append({
            "identitySecret": [fr()],
            "userMessageLimit": [100],
            "messageId": [1],
            "pathElements": [fr() for _ in range(depth)],
            "identityPathIndex": [int(v) for v in rng.integers(0, 2, size=depth)],
            "x": [fr()],
            "externalNullifier": [fr()],
        })
    return {
        name: [[lane[name][slot] for lane in lanes] for slot in range(len(lanes[0][name]))]
        for name in lanes[0]
    }


def ensure_native():
    from zerokit_tpu_torch.runtime import build, native

    if not native.available():
        log("native: the tracked library did not load; building with g++")
        build.build()
    if not native.available():
        raise RuntimeError("native host library unavailable")
    log(f"native: {os.path.relpath(native.loaded_path())} (assembly: "
        f"{'native batched' if native.assemble_available() else 'python'}, pairing: "
        f"{'native' if native.pairing_available() else 'python'})")


def prove_and_check(prover, rng, metrics) -> float:
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.ff.field import decode_canonical_fast
    from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof

    named = named_inputs(rng, BATCH, DEPTH)
    rs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(BATCH)]
    ss = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(BATCH)]
    t0 = time.perf_counter()
    proofs = prover.prove_batch(named, rs, ss, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(proofs) != BATCH:
        raise AssertionError(f"expected {BATCH} proofs, got {len(proofs)}")
    zc = prover.last_batch["z_canon"].cpu()
    pvk = prepare_verifying_key(prover.zkey.pk.vk)
    for b, proof in enumerate(proofs):
        if not verify_proof(pvk, proof, decode_canonical_fast(zc[:, 1:6, b])):
            raise AssertionError(f"proof {b} failed pairing verification")
    log(f"  {len(proofs)} proofs verified (pairing)")
    return wall


def check_lane0(prover):
    """Lane 0's five MSM results of the last batch against the native MSMs."""
    from zerokit_tpu_torch.ff.field import decode_canonical_fast
    from zerokit_tpu_torch.runtime import native

    pk = prover.zkey.pk
    z0 = decode_canonical_fast(prover.last_batch["z_canon"].cpu()[:, :, 0])
    h0 = decode_canonical_fast(prover.last_batch["h_canon"].cpu()[:, :, 0])
    ni = prover.num_inputs
    want = {
        "a": native.g1_msm_native(pk.a_query, z0),
        "b1": native.g1_msm_native(pk.b_g1_query, z0),
        "b2": native.g2_msm_native(pk.b_g2_query, z0),
        "l": native.g1_msm_native(pk.l_query, z0[ni:]),
        "h": native.g1_msm_native(pk.h_query, h0),
    }
    for key, ref in want.items():
        if prover.last_batch[key][0] != ref:
            raise AssertionError(f"lane-0 MSM {key} differs from the native MSM")
    log("  lane-0 MSMs a, b1, b2, l, h equal the native host MSMs")


KERNELS = {  # key -> (name, source, TPU kernel it replaces, launch counter)
    "K1": ("mont_mul", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:571", "mont_mul"),
    "K2": ("ec_op", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:571", "ec_op"),
    "K3": ("ec_scan", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:789", "ec_scan_rows"),
    "K4": ("ntt_stage", "ntt_kernels.cu", "zerokit_tpu/ff/pallas_ntt.py:201", "ntt_stage"),
    "K5": ("ntt_tail", "ntt_kernels.cu", "zerokit_tpu/ff/pallas_ntt.py:245", "ntt_tail"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()

    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from zerokit_tpu_torch.ff import _cuda
    from zerokit_tpu_torch.ff import field_kernels as fk
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.groth16.prover import Groth16Prover
    from zerokit_tpu_torch.resources import load_circuit
    from zerokit_tpu_torch.runtime.profiling import PipelineMetrics

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1] device: {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    rng = np.random.default_rng(args.seed)

    # 2. build, circuit -----------------------------------------------------
    _cuda.lib()
    info = _cuda.build_info
    log(f"[2] build: {os.path.relpath(info['path'])} "
        f"({'built' if info['built'] else 'reused'} in {info['seconds']:.1f} s)")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    zkey, graph = load_circuit(DEPTH)
    prover = Groth16Prover(zkey, graph, device="cuda")
    log(f"  depth-{DEPTH} circuit and prover ready in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions -------------------------------
    log("[3] kernels against their plain versions, on the card")
    checks = phase_kernels(rng, prover)

    # 4. the slice --------------------------------------------------------
    log(f"[4] depth-{DEPTH} batch of {BATCH} through Groth16Prover.prove_batch")
    ensure_native()
    fk.reset_launches()
    nk.reset_launches()
    m1 = PipelineMetrics()
    wall1 = prove_and_check(prover, rng, m1)
    counts = {**fk.launches, **nk.launches}
    log(f"  first batch (window tables built inside): {wall1:.3f} s; stages {m1.dumps()}")
    check_lane0(prover)

    # 5. warm batch -------------------------------------------------------
    log("[5] second (warm) batch")
    m2 = PipelineMetrics()
    wall2 = prove_and_check(prover, rng, m2)
    log(f"  warm batch: {wall2:.3f} s, {BATCH / wall2:.3f} proofs/s on {smi}; "
        f"stages {m2.dumps()}")

    # 6. launch counts ----------------------------------------------------
    log(f"[6] launches in the proving run of phase 4: {counts}")
    kernels = []
    for key, (kname, src, replaces, counter) in KERNELS.items():
        if counts[counter] <= 0:
            raise AssertionError(f"{key} {kname} was not launched on the proving path")
        ms, plain_ms, what = checks.times[key]
        kernels.append({
            "name": f"{kname} ({key}: {what})", "route": "cuda",
            "source": f"zerokit_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[counter], "max_abs_err": max(checks.errors[key]),
            "ms": ms, "plain_ms": plain_ms,
        })
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
