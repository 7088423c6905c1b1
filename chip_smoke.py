"""Drives zerokit_tpu_torch's prover, trees, RLN API, serving surface and tools on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases: (1) device, (2) build of the CUDA kernels from csrc/ (ptxas
registers, stack and spills of every kernel; SASS opcode counts of K2's G1
and G2 add) and load of the depth-20 circuit, (3) every kernel of the
proving path against its plain PyTorch version, bit for bit, on the same
tensors on the card, at the shapes the proving path gives it (K3's fine
scan through a sorted index made by the pass's own sort, K2's bucket add
through the rows the pass's own counts give), with both timed on the card;
the inputs hold edge values of the lazy field core (sums of exactly p,
(p-1)^2, values just above p - 2^32); the sweeps of K2's block size, the
fine scan's block size, the coarse scan's threads per lane and K5's chunk
P (each P's tail calls against the plain version at that P, its
occupancy, and each P's whole coset lift, equal to P = 512's), (3b) the
witness evaluator's kernels W1 (a segment's steps) and W2 (a Div group)
against their plain versions, bit for bit, segment by segment, on both
depth-20 graphs at 16 lanes and on a graph holding every op code with edge
inputs (tools/witness_graphs.edge_case_graph), each W1 launch on its
segment's slot-file plan (circuit/witness_plan.py; its registers,
preloaded values, shared memory and blocks per SM printed), lane 0's
assignment against the host interpreter's integers, W2 alone on 441 Divs x
16 lanes whose divisors start with edge values (0, 1, r - 1, R mod r,
every 2^k, just above r - 2^32, (r -+ 1) / 2; the kernel's own time, its
wrapper's with the index checks, and its threads a block swept), and the
evaluator's lane sweep (16 / 64 / 256 lanes, each equal to the first lanes
of the widest), (4) a batch of 16
depth-20 RLN proofs through Groth16Prover.prove_batch (witnesses from W1)
with pairing verification and lane-0 MSMs held against the native host
MSMs, then a batch of 16 of the multi-message-id circuit (witnesses from
W1 and W2), each with the launch counters at 0 before and read after,
(5) a second, warm batch, (6) the kernels' launch counts in each proving
run of phases 4 and 5 (every kernel of its path launched), (6b) one depth-20
partial + finish proof against the full proof, (7) the K6 tool: K6 (tensor-core Montgomery product)
against its plain version and K1 fq at 2^17 lanes, its persistent grid
and tensor-core opcodes, (8) the tools path with
its launch counts: the microbenchmark, whose chains are checked against
their plain version at the shape they are timed at (with the latencies
behind W1's step chain: a dependent CIOS product, shared and global
memory round trips, and W1's step on chains
of one op class), and the profile of a
warm batch (device busy share, the witness range's device time, top
kernels), (9) each kernel's work, bound and share of the bound (W1's ms
and cycles a step beside, and its share of the chain model of
runtime/profiling.w1_chain_model on phase 8's latencies; W2's cycles an
inversion), (10) the tree
and the RLN API, with the launch counters at 0 before and read after: 2^20
seeded member secrets made Montgomery by K1, their id and rate
commitments by P1 (the Poseidon kernel) at t = 2 and 3, a depth-20
DeviceMerkleTree of them (its warm rebuild of 20 P1 launches timed), its
leaves, paths and a depth-14 tree held against the native host library,
then RLN.stateless() proving two batches of 16 from the tree's paths
(verify, verify_batch, verify_with_roots, recover_id_secret) and the README
quick start on RLN.stateful(); then the warm rebuild's time and each
level's P1 call beside its bound (tools/profile_tree), and P1 (the sparse
partial-round form) against its dense plain version at every launch shape
it picks: on the tree's own leaf level and two upper levels in place, on
the id and rate commitment calls at their own 2^20 lanes, at every
t = 2..9 from 1 to 4096 lanes with edge lanes, and in its strided form
against copied inputs, (11) the serving surface at depth 20, with the
launch counters at 0 before (a) and read after (d): (a) 48 concurrent
POST /prove from 48 client threads through server.ProverService behind
its ProverHTTPServer on 127.0.0.1 (the batch sizes, wall proofs/s beside
the batches' prove_batch time; every reply through POST /verify, all by
verify_batch, a tampered one invalid; /prove_partial then /finish,
/keygen, /poseidon, /healthz), (b) runtime/batch_job's checkpointed
prover on 40 witnesses and its resume, (c) RLN.stateful over a
persistent PmTree (init_tree_with_leaves, a proof, close and reopen),
(d) the C ABI (runtime/build.build_ffi, then librln_ffi.so by ctypes
with ZEROKIT_TORCH_DEVICE=cuda: tree ops, proofs, verify, slashing,
rln_generate_proof_with_rs byte for byte against the facade,
rln_generate_proofs of 16), (e) the four CLIs as subprocesses with
--device cuda, (12) the mesh prover at depth 20 (parallel/): the
single-device proofs of a seeded batch of 16 (the phase-5 prover) go to
the ranks through a file, and launch.py starts (a) one NCCL rank, mesh
(dp, tp) = (1, 1), (b) two gloo ranks, (1, 2), (c) four gloo ranks,
(2, 2), all on cuda:0; each rank proves the batch twice through
RLN.stateless(mesh=) (parallel/dryrun.prove_file) and every rank's
proofs must equal the single-device proofs and verify; each rank prints
the second batch's launch counts (counters at 0 before it; K1-K5 and W1
above 0 in every rank), stage times, wall clock and each collective's
calls, bytes and seconds. Ranks sharing one card measure parity and
the collectives' cost, not scaling. (13) the component tools, with the
launch counters at 0 before (a) and read after (c): (a)
tools/bench_components at BC_MAX_LOG2 = 20 (Poseidon pairs up to 2^20, the
bulk insert of 2^20 leaves, the G1 MSM at 2^16-2^20 points x 4 lanes, fft
and ifft at 2^20), each config checked exactly against the native host
library (fft and ifft also on an input that repeats nowhere, against
their plain versions and fft against the native NTT); (b) tools/ntt_micro
at n = 8192, B = 64, every kernel call (K4 at m = 1, 8, 64, 512 and n/2
among them) bit for bit against its plain version, and K4 at m = 2^16 and
2^19 of n = 2^20 likewise; (c) tools/export_js_fixture --compare, the
depth-10 fixture proved on the card and equal byte for byte to the tracked
file; K1-K5, P1 and W1 must each launch. Times are CUDA-event times of calls run back
to back (profiling.device_ms); K1, K4, K5, the coset lift and K6, whose
calls each move 25-50 MB, are timed on rotating copies of their tensors
that together exceed L2 (profiling.l2_cold), the L2-warm time beside.
Any failed check raises, so the script exits non-zero. It imports no JAX.
The line before the last is the kernel JSON, the last line the device JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

DEPTH, BATCH = 20, 16
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH_DIR = os.path.join(REPO_ROOT, "build")  # git-ignored; phase 11's files


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def edge_values(p: int) -> list:
    """Values < p that reach the lazy field core's edges (csrc/bn254.cuh):
    0, 1, p-1 ((p-1)^2 where two meet), a pair summing to exactly p, values
    just above p - 2^32 (every word but the lowest is p's), p - 2."""
    x = p // 3
    return [0, 1, p - 1, x, p - x, p - (1 << 32) + 1, p - (1 << 32) + 0x7FFFFFFF, p - 2]


def limbs_of(v: int) -> list:
    return [(v >> (16 * i)) & 0xFFFF for i in range(16)]


def random_elems(rng, p: int, n: int) -> np.ndarray:
    """(16, n) limbs of seeded values < p, with edge_values(p) in the first
    lanes."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= (p >> 240) & 0xFFFF
    for j, v in enumerate(edge_values(p)[:n]):
        limbs[:, j] = limbs_of(v)
    return limbs


def put_edges(rows: np.ndarray, comps: int, coords: int, p: int) -> None:
    """Writes edge points into the first AoS rows (16*C*coords words, word
    (limb*C + m)*coords + c) of `rows`, every component alike: all
    coordinates p-1; x + y = p and y + z = p; all just above p - 2^32."""
    x = p // 3
    hi = p - (1 << 32)
    points = [[p - 1] * coords, [x, p - x, x][:coords], [hi + 1, hi + 5, hi + 9][:coords]]
    for r, point in enumerate(points[: rows.shape[0]]):
        for c, v in enumerate(point):
            for m in range(comps):
                rows[r, [(i * comps + m) * coords + c for i in range(16)]] = limbs_of(v)


def sass_summary(ops) -> str:
    """Opcode counts grouped: every IMAD variant, IADD3 (with .X), local
    loads and stores (spills), the six most common others, the total."""
    if not ops:
        return "no function matched"
    groups = {"IMAD*": ("IMAD",), "IADD3*": ("IADD3",), "LDL/STL": ("LDL", "STL")}
    parts, rest = [], dict(ops)
    for label, prefixes in groups.items():
        hit = {op: c for op, c in ops.items() if op.startswith(prefixes)}
        for op in hit:
            rest.pop(op)
        detail = ", ".join(f"{op} {c}" for op, c in sorted(hit.items(), key=lambda t: -t[1]))
        parts.append(f"{label} {sum(hit.values())}" + (f" ({detail})" if detail else ""))
    top = sorted(rest.items(), key=lambda t: -t[1])[:6]
    parts.append("others " + ", ".join(f"{op} {c}" for op, c in top)
                 + f" ({sum(rest.values())} in all)")
    return f"{sum(ops.values())} instructions: " + "; ".join(parts)


def on_card(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).cuda()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    """Runs kernel and plain version on the same card tensors, requires
    equal integers, and keeps each check's error, device times
    (profiling.device_ms) and the shape that profiling.kernel_work reads.
    With `cold` (l2_cold of the kernel), the kernel's time is that of the
    L2-cold calls; the same tensors back to back are printed beside it."""

    def __init__(self):
        self.errors: dict = {}
        self.times: dict = {}
        self.rows: list = []  # (key, what, ms, shape)
        self.wrapper_ms: dict = {}  # W2: the wrapper's time beside its kernel's, first check

    def run(self, key: str, what: str, kernel, plain, shape, reps: int = 10,
            cold=None) -> None:
        from zerokit_tpu_torch.runtime.profiling import device_ms, host_call

        got, kernel_s = host_call(kernel)  # also the kernel's warm-up
        want, plain_s = host_call(plain)  # and the plain version's
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"  {key} {what}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{key} {what}: kernel disagrees with its plain version")
        ms = device_ms(kernel, reps, kernel_s)
        if cold is not None:
            log(f"    kernel on the same tensors back to back (L2-warm): {ms:.4f} ms")
            ms = device_ms(cold, reps)
        self.record(key, what, err, ms, device_ms(plain, 1, plain_s), shape,
                    "L2-cold, rotating copies" if cold is not None else "calls back to back")

    def record(self, key: str, what: str, err: int, ms: float, plain_ms: float, shape,
               how: str = "calls back to back") -> None:
        self.errors.setdefault(key, []).append(err)
        self.times.setdefault(key, (ms, plain_ms, what, shape))
        self.rows.append((key, what, ms, shape))
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.2f} ms (on the card, {how})")


def block_sweep(what: str, call, reps: int = 10) -> str:
    """call(threads) at each of SWEEP_THREADS threads per block (the
    kernels' defaults among them), every output equal to the first, timed
    by device_ms; the line that reports it."""
    from zerokit_tpu_torch.runtime.profiling import device_ms

    ref = call(SWEEP_THREADS[0])
    times = []
    for threads in SWEEP_THREADS:
        if not torch.equal(call(threads), ref):
            raise AssertionError(f"{what} threads={threads} differs from "
                                 f"threads={SWEEP_THREADS[0]}")
        times.append(f"{threads}: {device_ms(lambda: call(threads), reps):.4f}")
    return f"    {what}: " + ", ".join(times) + " ms"


def ec_inputs(rng, comps: int, n: int):
    """p, q (16, C, 3, n) of seeded field elements (the formulas are
    polynomials, so any values compare), with curve points in lanes 0-3:
    (identity, P), (P, P), (P, -P), (P, identity); lanes 4-7 hold x
    coordinates from edge_values (products of two equal edge values), lanes
    8-10 put_edges points in p and q."""
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
    for arr in (p, q):
        rows = arr[:, :, :, 8:11].transpose(3, 0, 1, 2).reshape(3, -1).copy()
        put_edges(rows, comps, 3, Q)
        arr[:, :, :, 8:11] = rows.reshape(3, 16, comps, 3).transpose(1, 2, 3, 0)
    return p, q


def main_path_shapes(prover, tp: int = 1, batch: int = BATCH) -> dict:
    """The widths the proving path of `batch` lanes gives the curve kernels,
    by MSM pass (the a/b1/l group and h on G1, b2 on G2): the fine scan's
    (outer, k, inner) index, the coarse scan's (outer, k, inner) rows and
    the bucket adds' lanes. With tp > 1, those of the last tp rank's shard
    of a ShardedMSM (parallel/sharded.py: the points padded to a multiple
    of tp * K_BLOCK, the last shard holding the padding)."""
    from zerokit_tpu_torch.groth16.msm import (K_BLOCK, N_BUCKETS, _window_group,
                                               block_size_for)

    shapes = {}
    for name, comps, msm, members in (("ab1l", 1, prover.msm_a, 3), ("b2", 2, prover.msm_b2, 1),
                                      ("h", 1, prover.msm_h, 1)):
        n, n_real = msm.n, msm.n_real
        if tp > 1:
            gran = tp * K_BLOCK
            n = max(gran, -(-n_real // gran) * gran) // tp
            n_real = min(max(n_real - (tp - 1) * n, 0), n)
        lanes = members * batch
        g = _window_group(lanes, comps, n=n)
        k = block_size_for(n)
        nb = n // k
        shapes[name] = {"comps": comps, "n": n, "n_real": n_real, "members": members,
                        "fine": (g * nb, k, lanes), "coarse": (g, nb, lanes),
                        "buckets": g * N_BUCKETS * lanes}
    return shapes


def fine_scan_inputs(rng, sh: dict):
    """Table rows, the index and the digits of one window group, as a pass
    makes them: random field elements (put_edges points in the first rows)
    in the rows of the MSM's real points and the (0, 0) sentinel in its
    padding rows, and the index from the pass's own sort
    (sorted_table_index) of seeded scalars' digits."""
    from zerokit_tpu_torch.constants import Q, R
    from zerokit_tpu_torch.groth16.msm import C_BITS, N_WINDOWS
    from zerokit_tpu_torch.groth16.msm_fused import digits_for_windows, sorted_table_index

    comps, n, members = sh["comps"], sh["n"], sh["members"]
    outer, k, lanes = sh["fine"]
    group = outer * k // n
    n_rows = members * N_WINDOWS * n
    rows = (random_elems(rng, Q, n_rows * comps * 2)
            .reshape(16, n_rows, comps * 2).transpose(1, 0, 2).reshape(n_rows, -1))
    put_edges(rows, comps, 2, Q)
    table = on_card(rows)
    table.view(members * N_WINDOWS, n, -1)[:, sh["n_real"]:] = 0
    scalars = on_card(random_elems(rng, R, n * lanes).reshape(16, n, lanes))
    scalars[:, sh["n_real"]:] = 0
    digits = digits_for_windows(scalars, N_WINDOWS, C_BITS)[:group]
    index = sorted_table_index(digits, 0, N_WINDOWS, members).view(outer, k, lanes)
    sentinel = (table == 0).all(dim=1)
    work = {"skipped": int(sentinel[index.long()].sum()),
            "table_rows": int(torch.unique(index).numel())}
    return table, index, digits, work


def coarse_scan_inputs(rng, sh: dict) -> torch.Tensor:
    """Projective rows (outer, k, inner, 16*C*3) of seeded field elements,
    strided along k as the pass's block totals are (every other row)."""
    from zerokit_tpu_torch.constants import Q

    comps = sh["comps"]
    outer, k, inner = sh["coarse"]
    rows = outer * k * 2 * inner
    x = random_elems(rng, Q, rows * comps * 3).reshape(16, rows, comps * 3).transpose(1, 0, 2)
    x = x.reshape(outer, k, 2, inner, -1).copy()
    put_edges(x[0, :, 1, 0], comps, 3, Q)  # lane 0's first steps
    return on_card(x)[:, :, 1]


SWEEP_CHUNKS = (8, 16, 32, 64, 128)
SWEEP_THREADS = (64, 128, 256)  # threads per block of K2 and of the fine scan


def phase_scans(rng, checks: KernelChecks, shapes: dict, sweep: bool = True) -> dict:
    """K3: the fine scan through a real sorted index (a/b1/l and b2) and the
    coarse scan (a/b1/l, b2, h), bit for bit against their plain versions;
    with sweep, the fine scan's block sizes (the same arithmetic, so each
    equals the default's output) and the coarse scan's chunk counts (each
    held against the plain version of its own grouping), timed. Returns
    each fine scan's (table, index, digits) by pass."""
    from zerokit_tpu_torch.ff import field_kernels as fk
    from zerokit_tpu_torch.runtime.profiling import device_ms

    fine_sweep, passes = [], {}
    for name in ("ab1l", "b2"):
        sh = shapes[name]
        comps = sh["comps"]
        table, index, digits, work = fine_scan_inputs(rng, sh)
        passes[name] = (table, index, digits)
        outer, k, inner = sh["fine"]
        checks.run("K3 fine", f"ec_scan_gather g{comps} ({name}), k={k}, N={outer * inner}, "
                   f"{work['table_rows']} table rows",
                   lambda: fk.ec_scan_gather(comps, table, index),
                   lambda: fk.ec_scan_gather_plain(comps, table, index),
                   {"kind": "mixed", "comps": comps, "k": k, "lanes": outer * inner, **work},
                   reps=3)
        if sweep:
            fine_sweep.append(block_sweep(
                f"ec_scan_gather {name} g{comps} N={outer * inner}",
                lambda threads: fk.ec_scan_gather(comps, table, index, threads), reps=3))
    if sweep:
        log("  fine-scan block sweep (threads per block; kernel ms by device_ms over 3 calls):")
        for line in fine_sweep:
            log(line)
    coarse_x = {}
    for name in ("ab1l", "b2", "h"):
        sh = shapes[name]
        comps = sh["comps"]
        x = coarse_x[name] = coarse_scan_inputs(rng, sh)
        outer, k, inner = sh["coarse"]
        checks.run("K3 coarse", f"ec_scan_excl g{comps} ({name}), k={k}, N={outer * inner}, "
                   f"chunks={fk.SCAN_CHUNKS}",
                   lambda: fk.ec_scan_excl(comps, x), lambda: fk.ec_scan_excl_plain(comps, x),
                   {"kind": "excl", "comps": comps, "k": k, "lanes": outer * inner}, reps=10)
    if not sweep:
        return passes
    log("  coarse-scan chunk sweep (threads per lane; kernel ms by device_ms over 10 calls, "
        "each bit-exact against the plain version of its grouping):")
    for name, x in coarse_x.items():
        comps = shapes[name]["comps"]
        times = []
        for chunks in SWEEP_CHUNKS:
            err = max_abs_err(fk.ec_scan_excl(comps, x, chunks),
                              fk.ec_scan_excl_plain(comps, x, chunks))
            if err != 0:
                raise AssertionError(f"ec_scan_excl {name} chunks={chunks} disagrees with its "
                                     "plain version")
            times.append(f"{chunks}: {device_ms(lambda: fk.ec_scan_excl(comps, x, chunks)):.4f}")
        outer, k, inner = shapes[name]["coarse"]
        log(f"    {name} g{comps} k={k} N={outer * inner}: " + ", ".join(times) + " ms")
    return passes


def phase_ec_sweep(rng, shapes: dict) -> None:
    """K2's block size: each op at the bucket adds' widths with 64, 128 and
    256 threads per block, each output equal to the default's, timed
    (ec_add_gather's sweep is in phase_bucket_adds)."""
    from zerokit_tpu_torch.ff import field_kernels as fk

    log("  K2 block sweep (threads per block; kernel ms by device_ms over 10 calls):")
    for name in ("ab1l", "b2"):
        comps, n2 = shapes[name]["comps"], shapes[name]["buckets"]
        p_np, q_np = ec_inputs(rng, comps, n2)
        p, q3, q2 = on_card(p_np), on_card(q_np), on_card(q_np[:, :, :2])
        for op, q in (("add", q3), ("add_mixed", q2), ("double", None)):
            log(block_sweep(f"ec_op g{comps} {op}, {n2} lanes",
                            lambda threads: fk.ec_op(op, comps, p, q, threads)))


def phase_bucket_adds(checks: KernelChecks, shapes: dict, passes: dict,
                      sweep: bool = True) -> None:
    """K2's Q_d add (ec_add_gather) at the bucket adds' widths, on the fine
    and coarse prefixes of phase_scans' fine-scan inputs, through the rows
    that the pass's own counts give (msm_fused.bucket_counts, bucket_rows);
    every 7th bucket is flagged empty besides the pass's own empty ones.
    With sweep, its block sizes too."""
    from zerokit_tpu_torch.ff import field_kernels as fk
    from zerokit_tpu_torch.groth16.msm import N_BUCKETS
    from zerokit_tpu_torch.groth16.msm_fused import bucket_counts, bucket_rows

    for name in ("ab1l", "b2"):
        sh = shapes[name]
        comps, n = sh["comps"], sh["n"]
        outer, k, lanes = sh["fine"]
        table, index, digits = passes[name]
        group = digits.shape[0]
        fine = fk.ec_scan_gather(comps, table, index)
        rows = fine.shape[-1]
        coarse = fk.ec_scan_excl(comps, fine.view(group, n // k, k, lanes, rows)[:, :, k - 1])
        fidx, cidx, empty = bucket_rows(bucket_counts(digits, N_BUCKETS), n, k)
        empty = empty | (torch.arange(empty.numel(), device=empty.device) % 7 == 3).view(
            empty.shape)
        fine_rows, coarse_rows = fine.view(-1, rows), coarse.view(-1, rows)
        live = ~empty
        work = {"op": "add_gather", "comps": comps, "lanes": empty.numel(),
                "skipped": int(empty.sum()),
                "rows_read": int(torch.unique(fidx[live]).numel()
                                 + torch.unique(cidx[live]).numel())}
        checks.run("K2 gather", f"ec_add_gather g{comps} ({name}), {empty.numel()} lanes, "
                   f"{work['skipped']} empty",
                   lambda: fk.ec_add_gather(comps, fine_rows, fidx, coarse_rows, cidx, empty),
                   lambda: fk.ec_add_gather_plain(comps, fine_rows, fidx, coarse_rows, cidx,
                                                  empty),
                   work)
        if not sweep:
            continue
        log("  K2 gather block sweep (threads per block; kernel ms by device_ms over 10 calls):")
        log(block_sweep(f"ec_add_gather g{comps} ({name}), {empty.numel()} lanes",
                        lambda threads: fk.ec_add_gather(comps, fine_rows, fidx, coarse_rows,
                                                         cidx, empty, threads)))


SWEEP_TAIL = (512, 1024, 2048)  # K5's chunk sizes


def phase_tail_sweep(x: torch.Tensor, root: int) -> None:
    """K5's chunk P: at each P, both tail calls of the lift (DIF with the
    table, DIT without) and the other two, bit for bit against the plain
    version at that P; the kernels' occupancy; each call and the whole
    coset_lift_bn timed L2-cold, and each P's lift equal to P = 512's."""
    from zerokit_tpu_torch.ff import _cuda
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.runtime.profiling import ChipSpec, device_ms, kernel_bound, l2_cold

    chip = ChipSpec.from_device(torch.cuda.current_device())
    _, rows, n = x.shape
    log(f"  K5 chunk sweep (kernel ms by device_ms over 10 calls, L2-cold; lift over 3; "
        f"{chip.label()}):")
    ref = nk.coset_lift_bn(x, root, SWEEP_TAIL[0])
    for p in SWEEP_TAIL:
        parts = []
        for direction, fused in (("dif", True), ("dit", False), ("dif", False), ("dit", True)):
            inverse = direction == "dif"
            tw = nk._tail_tw(n, inverse, "cuda", p)
            table = nk._coset_table(n, root, "cuda") if fused else None
            err = max_abs_err(nk.ntt_tail(x, tw, table, direction, p),
                              nk.ntt_tail_plain(x, tw, table, direction, p))
            if err != 0:
                raise AssertionError(f"ntt_tail {direction} P={p} table={fused} disagrees with "
                                     "its plain version")
            ms = device_ms(l2_cold(lambda x: nk.ntt_tail(x, tw, table, direction, p), x))
            bound = kernel_bound("K5", chip, rows=rows, n=n, p=p, table=fused)[0] * 1e3
            blocks = _cuda.occupancy("zk_ntt_tail_occupancy", int(inverse), int(fused), p)
            parts.append(f"{direction}{'+table' if fused else ''} {ms:.4f} ms "
                         f"({bound / ms:.1%} of {bound:.4f}), {blocks} blocks/SM")
        lift = nk.coset_lift_bn(x, root, p)
        if not torch.equal(lift, ref):
            raise AssertionError(f"coset_lift_bn P={p} differs from P={SWEEP_TAIL[0]}")
        ms = device_ms(l2_cold(lambda x: nk.coset_lift_bn(x, root, p), x), 3)
        bound = kernel_bound("K4+K5", chip, rows=rows, n=n, p=p)[0] * 1e3
        cross = 2 * max(0, n.bit_length() - 1 - (min(n, p).bit_length() - 1))
        log(f"    P={p}: " + "; ".join(parts) + f"; coset_lift_bn {ms:.4f} ms "
            f"({bound / ms:.1%} of {bound:.4f}, {cross} K4 + 2 K5 launches)")


def phase_kernels(rng, prover) -> KernelChecks:
    from zerokit_tpu_torch.constants import Q, R
    from zerokit_tpu_torch.ff import field_kernels as fk
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.groth16 import ntt as ntt_host
    from zerokit_tpu_torch.runtime.profiling import l2_cold

    checks = KernelChecks()
    shapes = main_path_shapes(prover)
    log(f"  main-path widths: {shapes}")
    # K1 (the edge values meet themselves: (p-1)^2 in lane 2) -------------
    n1 = 1 << 17
    for name, p in (("fr", R), ("fq", Q)):
        a = on_card(random_elems(rng, p, n1))
        b = on_card(random_elems(rng, p, n1))
        checks.run("K1", f"mont_mul {name}, {n1} lanes",
                   lambda: fk.mont_mul(name, a, b), lambda: fk.mont_mul_plain(name, a, b),
                   {"lanes": n1, "field": name},
                   cold=l2_cold(lambda a, b: fk.mont_mul(name, a, b), a, b))
    # K2 ----------------------------------------------------------------
    for name in ("ab1l", "b2"):
        comps, n2 = shapes[name]["comps"], shapes[name]["buckets"]
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
                       lambda: fk.ec_op(op, comps, p, q), lambda: fk.ec_op_plain(op, comps, p, q),
                       {"op": op, "comps": comps, "lanes": n2,
                        "skipped": 1 if op == "add_mixed" else 0})
    phase_ec_sweep(rng, shapes)
    # K3, then K2's Q_d add on the scans' outputs ----------------------------
    passes = phase_scans(rng, checks, shapes)
    phase_bucket_adds(checks, shapes, passes)
    del passes
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
                       lambda: nk.ntt_stage_plain(x, tw, m, direction),
                       {"rows": rows_3b, "n": n_dom, "m": m, "dif": direction == "dif"},
                       cold=l2_cold(lambda x: nk.ntt_stage(x, tw, m, direction), x))
            m //= 2
        tail_tw = nk._tail_tw(n_dom, inverse, "cuda")
        for table in (nk._coset_table(n_dom, root, "cuda"), None):
            fused = "with" if table is not None else "without"
            checks.run("K5", f"ntt_tail {direction} {fused} table, P={nk.TAIL}, "
                       f"(16, {rows_3b}, {n_dom})",
                       lambda: nk.ntt_tail(x, tail_tw, table, direction),
                       lambda: nk.ntt_tail_plain(x, tail_tw, table, direction),
                       {"rows": rows_3b, "n": n_dom, "p": nk.TAIL, "table": table is not None,
                        "dif": direction == "dif"},
                       cold=l2_cold(lambda x: nk.ntt_tail(x, tail_tw, table, direction), x))
    checks.run("K4+K5", f"coset_lift_bn, P={nk.TAIL}, (16, {rows_3b}, {n_dom})",
               lambda: nk.coset_lift_bn(x, root),
               lambda: ntt_host.coset_lift(x.transpose(1, 2), root).transpose(1, 2),
               {"rows": rows_3b, "n": n_dom, "p": nk.TAIL}, reps=3,
               cold=l2_cold(lambda x: nk.coset_lift_bn(x, root), x))
    phase_tail_sweep(x, root)
    return checks


# ---------------------------------------------------------------------------
# Phase 3b: the witness evaluator's kernels
# ---------------------------------------------------------------------------

MULTI_GRAPH = "tree_depth_20/multi_message_id/max_out_4"
SWEEP_LANES = (16, 64, 256)  # the evaluator's chunk


def load_multi():
    """(Zkey, Graph) of the depth-20 multi-message-id RLN circuit (max_out 4)."""
    from zerokit_tpu_torch.circuit.graph import graph_from_bytes
    from zerokit_tpu_torch.circuit.zkey import zkey_from_bytes
    from zerokit_tpu_torch.resources import load_resource

    return (zkey_from_bytes(load_resource(f"{MULTI_GRAPH}/rln_final.arkzkey")),
            graph_from_bytes(load_resource(f"{MULTI_GRAPH}/graph.bin"), DEPTH, 4))


def multi_batch_inputs(rng, batch: int):
    """random_batch_inputs for the multi-message-id circuit: four message ids
    (1, 2, 3, 0), the first two slots used."""
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs

    named, rs, ss = random_batch_inputs(rng, batch, DEPTH)
    named["messageId"] = [[m] * batch for m in (1, 2, 3, 0)]
    named["selectorUsed"] = [[u] * batch for u in (1, 1, 0, 0)]
    return named, rs, ss


def witness_segments(checks: KernelChecks, label: str, ev, inputs: np.ndarray) -> torch.Tensor:
    """Each segment of the graph, in order, through W1 (its steps) and W2
    (its Divs) and through their plain versions on a copy of the same slot
    buffer, every slot held bit for bit (the padding slots too); the
    kernel timed by device_ms (a rerun writes the same slots again), the
    plain version by the host clock (one call). W1's largest segment is
    recorded first, with its slot file's size and W1's blocks per SM at
    that size. Returns the assignment (16, n_signals, B)."""
    from zerokit_tpu_torch.circuit import witness_kernels as wk
    from zerokit_tpu_torch.ff import _cuda
    from zerokit_tpu_torch.runtime.profiling import device_ms, host_call, segment_work

    buf = ev.load(inputs)
    ref = buf.clone()
    lanes = buf.shape[0]
    rows = []
    for i, (seg, cseg, sp) in enumerate(zip(ev.segments, ev.compiled.segments,
                                            ev.plan.segments)):
        calls = []
        if seg.records.shape[0]:
            smem = wk.steps_smem_bytes(len(sp.preload), sp.n_regs, ev.plan.n_consts)
            blocks = _cuda.occupancy("zk_witness_steps_occupancy", int(sp.rich), smem)
            calls.append(("W1", f"witness_steps {cseg.kind} ({label} segment {i}, "
                          f"{seg.records.shape[0]} steps, {lanes} lanes; file: {sp.n_regs} "
                          f"registers, {len(sp.preload)} preloaded, {ev.plan.n_consts} constants; "
                          f"{smem} B a block, {blocks} blocks/SM)",
                          lambda s=seg: ev.steps_of(buf, s),
                          lambda s=seg: ev.steps_of(ref, s, plain=True),
                          segment_work(cseg, lanes, sp.records, ev.plan.n_consts)
                          | {"rich": seg.rich}))
        if seg.div_out.numel():
            args = (seg.div_ia, seg.div_ib, seg.div_out)
            calls.append(("W2", f"witness_div ({label} segment {i}, {seg.div_out.numel()} Divs, "
                          f"{lanes} lanes)", lambda a=args: wk.witness_div(buf, *a),
                          lambda a=args: wk.witness_div_plain(ref, *a),
                          {"divs": seg.div_out.numel(), "lanes": lanes}))
        for key, what, kernel, plain, shape in calls:
            _, kernel_s = host_call(kernel)
            _, plain_s = host_call(plain)
            torch.cuda.synchronize()
            err = max_abs_err(buf, ref)
            log(f"  {key} {what}: max_abs_err {err}")
            if err != 0:
                raise AssertionError(f"{key} {what}: kernel disagrees with its plain version")
            ms = device_ms(kernel, 3, kernel_s)
            if key == "W2":  # the kernel alone; its wrapper's index checks beside
                log(f"    wrapper (index checks + kernel) {ms:.4f} ms")
                checks.wrapper_ms.setdefault(key, ms)
                ms = device_ms(lambda a=args: div_kernel(buf, *a, wk.DIV_THREADS), 3)
            rows.append((key, what, err, ms, plain_s * 1e3, shape))
    rows.sort(key=lambda r: -r[5].get("steps", 0))
    for key, what, err, ms, plain_ms, shape in rows:
        checks.record(key, what, err, ms, plain_ms, shape, "kernel back to back; plain: host "
                      "clock, one call")
    return wk.words_to_limbs(buf[:, ev.output_slots])


DIV_DIRECT = (16, 441)  # W2's direct check: lanes x Divs (the edge graph's group)
DIV_SWEEP = (32, 64, 128, 256)  # W2's threads per block


def div_edge_values() -> list:
    """W2's edge divisors: 0, 1, r - 1, one in Montgomery form (2^256 mod
    r), 2^k for k = 0..253, values just above r - 2^32, (r -+ 1) / 2."""
    from zerokit_tpu_torch.constants import R

    return ([0, 1, R - 1, (1 << 256) % R, (R - 1) // 2, (R + 1) // 2]
            + [1 << k for k in range(254)]
            + [R - (1 << 32) + k for k in (1, 2, 3, 5, 1 << 16, (1 << 31) + 7)])


def div_kernel(buf, ia, ib, out, threads: int) -> torch.Tensor:
    """W2's kernel alone: the launch witness_div makes, without the
    wrapper's index checks (three device-side asserts, ~15 small torch
    kernels) and without its launch count."""
    from zerokit_tpu_torch.ff import _cuda

    lanes, n_slots, _ = buf.shape
    _cuda.launch("zk_witness_div", buf, ia, ib, out, ia.numel(), n_slots, lanes, threads)
    return buf


def phase_div_direct(rng, checks: KernelChecks, chip) -> None:
    """W2 on DIV_DIRECT (Div, lane) pairs of seeded values, the divisors
    led by div_edge_values(), bit for bit against witness_div_plain (the
    JAX package's Fermat form) through the kernel alone and through the
    wrapper; each timed, with the kernel's cycles an inversion (its time x
    the SM clock: one thread's chain); then the kernel at each of DIV_SWEEP
    threads a block on the first 6 Divs (the multi-message-id graph's group
    size) and on all of them, each output equal to the plain version's."""
    from zerokit_tpu_torch.circuit import witness_kernels as wk
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.runtime.profiling import device_ms

    lanes, n = DIV_DIRECT
    edges = div_edge_values()
    b = random_elems(rng, R, lanes * n)
    for j, v in enumerate(edges):
        b[:, j] = limbs_of(v)
    limbs = np.zeros((16, 3 * n, lanes), dtype=np.uint32)  # a, b, the quotients
    limbs[:, :n] = random_elems(rng, R, lanes * n).reshape(16, lanes, n).transpose(0, 2, 1)
    limbs[:, n:2 * n] = b.reshape(16, lanes, n).transpose(0, 2, 1)
    buf = wk.limbs_to_words(on_card(limbs))
    ref = buf.clone()
    ia = torch.arange(n, dtype=torch.int32, device=buf.device)
    idx = (ia, ia + n, ia + 2 * n)
    checks.run("W2", f"witness_div (direct: {n} Divs x {lanes} lanes, {len(edges)} edge "
               f"divisors)", lambda: div_kernel(buf, *idx, wk.DIV_THREADS),
               lambda: wk.witness_div_plain(ref, *idx), {"divs": n, "lanes": lanes})
    ms = checks.rows[-1][2]
    buf[:, 2 * n:] = 0
    err = max_abs_err(wk.witness_div(buf, *idx), ref)
    if err != 0:
        raise AssertionError("W2 direct: the wrapper disagrees with the plain version")
    log(f"    wrapper (index checks + kernel) {device_ms(lambda: wk.witness_div(buf, *idx)):.4f} "
        f"ms, max_abs_err {err}; kernel {ms * 1e-3 * chip.sm_clock_hz:.0f} cycles an "
        f"inversion; {chip.label()}")
    for k in (6, n):
        sub = tuple(t[:k] for t in idx)
        parts = []
        for threads in DIV_SWEEP:
            buf[:, 2 * n:] = 0
            div_kernel(buf, *sub, threads)
            if not torch.equal(buf[:, 2 * n:2 * n + k], ref[:, 2 * n:2 * n + k]):
                raise AssertionError(f"W2 at {threads} threads a block differs from the plain "
                                     f"version")
            t = device_ms(lambda: div_kernel(buf, *sub, threads))
            parts.append(f"{threads}: {t:.4f} ({t * 1e-3 * chip.sm_clock_hz:.0f} cycles)")
        log(f"    W2 threads a block, {k} Divs x {lanes} lanes (kernel alone, ms): "
            + ", ".join(parts))


def host_lane0(graph, named: dict) -> list:
    from zerokit_tpu_torch.circuit import witness_host

    return witness_host.calc_witness({k: [col[0] for col in v] for k, v in named.items()}, graph)


def phase_witness(rng, checks: KernelChecks, graph, chip) -> None:
    """W1 and W2 against their plain versions, bit for bit, segment by
    segment: on the every-op edge graph (tools/witness_graphs.edge_case_graph)
    and on both depth-20 graphs at BATCH lanes; lane 0's assignment of each
    depth-20 graph against the host interpreter's integers; W2's direct
    check (phase_div_direct); then the evaluator's lane sweep (16 / 64 /
    256 lanes of one input set), each assignment equal to the first lanes
    of the widest one's."""
    from zerokit_tpu_torch.circuit.witness_eval import WitnessEvaluator, compile_graph
    from zerokit_tpu_torch.ff.field import FR
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs
    from zerokit_tpu_torch.runtime.profiling import device_ms
    from zerokit_tpu_torch.tools.witness_graphs import edge_case_graph

    multi_graph = load_multi()[1]
    for label, g, inputs in (("depth-20", graph, random_batch_inputs(rng, BATCH, DEPTH)[0]),
                             ("depth-20 multi", multi_graph, multi_batch_inputs(rng, BATCH)[0])):
        ev = WitnessEvaluator(compile_graph(g), "cuda")
        out = witness_segments(checks, label, ev, ev.build_input_buffer(inputs, BATCH))
        lane0 = [int(v) for v in FR.decode(out[:, :, 0].cpu())]
        if lane0 != host_lane0(g, inputs):
            raise AssertionError(f"{label}: lane 0's assignment differs from the host interpreter")
        log(f"  {label}: lane 0's {len(lane0)} signals equal witness_host.calc_witness's")
    edge, values = edge_case_graph(rng, BATCH)
    ev = WitnessEvaluator(compile_graph(edge), "cuda")
    witness_segments(checks, "edge graph", ev,
                     ev.build_input_buffer({"x": [list(row) for row in values]}, BATCH))
    phase_div_direct(rng, checks, chip)

    ev = WitnessEvaluator(compile_graph(graph), "cuda")
    log(f"  evaluator lane sweep, depth-20 graph, {ev.steps} steps (ms by device_ms over 3 "
        f"calls; {chip.label()}):")
    widest = max(SWEEP_LANES)
    all_inputs = ev.build_input_buffer(random_batch_inputs(rng, widest, DEPTH)[0], widest)
    ref = ev.evaluate_mont(all_inputs)
    for lanes in SWEEP_LANES:
        inputs = np.ascontiguousarray(all_inputs[:, :, :lanes])
        if not torch.equal(ev.evaluate_mont(inputs), ref[:, :, :lanes]):
            raise AssertionError(f"the evaluator at {lanes} lanes differs from the first "
                                 f"{lanes} lanes at {widest}")
        whole = device_ms(lambda: ev.evaluate_mont(inputs), 3)
        buf = ev.load(inputs)
        ms = device_ms(lambda: ev.run(buf), 3)
        log(f"    {lanes} lanes: evaluate_mont {whole:.3f} ms; W1+W2 {ms:.3f} ms, "
            f"{ms / ev.steps * 1e3:.3f} us/step, "
            f"{ms * 1e-3 * chip.sm_clock_hz / ev.steps:.0f} cycles/step")


# ---------------------------------------------------------------------------
# Phases 4-6: the proving path
# ---------------------------------------------------------------------------


def verify_batch(prover, proofs) -> None:
    """Pairing-verifies the proofs of the prover's last batch."""
    from zerokit_tpu_torch.ff.field import decode_canonical_fast
    from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof

    if len(proofs) != BATCH:
        raise AssertionError(f"expected {BATCH} proofs, got {len(proofs)}")
    zc = prover.last_batch["z_canon"].cpu()
    pvk = prepare_verifying_key(prover.zkey.pk.vk)
    for b, proof in enumerate(proofs):
        if not verify_proof(pvk, proof, decode_canonical_fast(zc[:, 1:prover.num_inputs, b])):
            raise AssertionError(f"proof {b} failed pairing verification")
    log(f"  {len(proofs)} proofs verified (pairing)")


def prove_and_check(prover, rng, metrics, multi: bool = False) -> float:
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs

    named, rs, ss = (multi_batch_inputs(rng, BATCH) if multi
                     else random_batch_inputs(rng, BATCH, DEPTH))
    t0 = time.perf_counter()
    proofs = prover.prove_batch(named, rs, ss, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    verify_batch(prover, proofs)
    return wall


def phase_partial(prover, rng) -> None:
    """One depth-20 partial + finish proof (a seeded half of the assignment
    known) against the full proof at the same (r, s), pairing-verified."""
    from zerokit_tpu_torch.ff.field import FrField, decode_canonical_fast
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs
    from zerokit_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof

    named, rs, ss = random_batch_inputs(rng, 1, DEPTH)
    assignment = prover.full_assignments(named, 1)[:, :, :1].contiguous()
    z = decode_canonical_fast(FrField.from_mont(assignment)[:, :, 0])
    known = rng.random(len(z) - 1) < 0.5
    t0 = time.perf_counter()
    partial = prover.prove_partial([v if k else None for v, k in zip(z[1:], known)])
    t1 = time.perf_counter()
    proof = prover.finish_proof(partial, assignment, rs[0], ss[0])
    t2 = time.perf_counter()
    if proof != prover.prove_batch_with_assignment(assignment, rs, ss)[0]:
        raise AssertionError("partial + finish proof differs from the full proof")
    pvk = prepare_verifying_key(prover.zkey.pk.vk)
    if not verify_proof(pvk, proof, z[1:prover.num_inputs]):
        raise AssertionError("partial + finish proof failed pairing verification")
    log(f"  partial ({int(known.sum())} of {len(known)} entries known) {t1 - t0:.3f} s + finish "
        f"{t2 - t1:.3f} s: equals the full proof at the same (r, s), verified (pairing)")


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


# ---------------------------------------------------------------------------
# Phases 7-9: the tools path
# ---------------------------------------------------------------------------


def phase_tool_kernels(checks: KernelChecks) -> None:
    """K6 through its tool at 2^17 lanes: against its plain version and K1
    fq bit for bit, both timed L2-cold (L2-warm beside); its persistent
    grid's occupancy and its tensor-core instructions (IMMA or GMMA) in the
    SASS.
    The microbenchmark chains' SASS (the chains are held against their
    plain version at their timed shape inside the tool, phase 8)."""
    from zerokit_tpu_torch.ff import _cuda
    from zerokit_tpu_torch.tools import microbench as mb
    from zerokit_tpu_torch.tools import tc_mont_prototype as tc

    n6 = 1 << 17
    rep = tc.main(n6)
    checks.record("K6", f"mont_mul_tc fq, {n6} lanes", 0, rep["k6_ms"], rep["plain_ms"],
                  {"lanes": n6}, "L2-cold, rotating copies")
    log(f"    L2-warm: K6 {rep['k6_warm_ms']:.4f} ms; K1 fq at {n6} lanes {rep['k1_ms']:.4f} ms "
        f"L2-cold, {rep['k1_warm_ms']:.4f} ms L2-warm")
    blocks = _cuda.occupancy("zk_mont_mul_tc_occupancy")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  K6: persistent grid of {blocks} blocks/SM x {sms} SMs = {blocks * sms} blocks of "
        f"4 warps over {-(-n6 // 32)} 32-lane tiles")
    sass = _cuda.sass_opcodes("mont_tc_kernel")
    tensor = {op: c for op, c in sass.items() if op.startswith("IMMA") or "GMMA" in op}
    log(f"  SASS of mont_tc_kernel (cuobjdump -sass): {tensor}, "
        f"IMAD* {sum(c for op, c in sass.items() if op.startswith('IMAD'))}")
    if not tensor:
        raise AssertionError("mont_tc_kernel has no tensor-core instruction (IMMA or GMMA)")
    for op in mb.OPS:
        ops = _cuda.sass_opcodes(f"chain_kernelILi{mb.OPS[op]}E")
        log(f"  SASS of chain_kernel<{mb.OPS[op]}> ({op}): {dict(ops.most_common(6))}")


def phase_tools_path(rng, prover, chip_label: str) -> dict:
    """The tools path, as a user runs it: the microbenchmark (chains, tensor
    cores, K1 / K2 / K6 lane throughput) and the profile of a warm batch,
    with every launch counter at 0 before and read after."""
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs
    from zerokit_tpu_torch.runtime.profiling import launch_counts, reset_launches
    from zerokit_tpu_torch.tools import microbench as mb
    from zerokit_tpu_torch.tools import profile_batch as pb

    reset_launches()
    mb_rep = mb.main()
    rep = pb.profile_batch(prover, random_batch_inputs(rng, BATCH, DEPTH))
    verify_batch(prover, rep["proofs"])
    pb.print_report(rep, chip_label, log)
    counts = launch_counts()
    log(f"  launches on the tools path: {counts}")
    for counter in ("mont_mul_tc", "chain"):
        if counts[counter] <= 0:
            raise AssertionError(f"{counter} was not launched on the tools path")
    return {"counts": counts, "chip": mb_rep["chip"], "latency": mb_rep["latency"],
            "profile": rep}


# ---------------------------------------------------------------------------
# Phase 10: batched Poseidon (P1), the depth-20 device tree, the RLN API
# ---------------------------------------------------------------------------

TREE_DEPTH = 20  # the tree users run: 2^20 leaves, the depth-20 circuit's
NATIVE_DEPTH = 14  # the device tree rebuilt level by level natively
USER_LIMIT = 100  # userMessageLimit of every member
P1_LANES = (1, 7, 255, 4096)  # P1's checks at every t: below a warp to 128 warps
P1_TIMED = 4096


def poseidon_edge_values() -> list:
    """Raw Montgomery limb values of P1's edge lanes: 0, 1, r - 1, the
    Montgomery images of r - 1 and of values near 2^253, 2^253 + 1, r - 2.
    Lane 2 holds r - 1 in every input, so every state lane but 0 starts there."""
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.ff.field import FR

    return [0, 1, R - 1, FR.to_mont_int(R - 1), FR.to_mont_int((1 << 253) + 1),
            FR.to_mont_int((1 << 253) - 3), (1 << 253) + 1, R - 2]


def poseidon_inputs(rng, n: int) -> torch.Tensor:
    """(16, n) seeded values < r on the card, the edge lanes first."""
    from zerokit_tpu_torch.constants import R

    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= R >> 240
    for j, v in enumerate(poseidon_edge_values()[:n]):
        limbs[:, j] = limbs_of(v)
    return on_card(limbs)


def build_member_tree(rng):
    """The main path's tree: 2^20 seeded secrets as canonical limbs straight
    from numpy, to Montgomery form by K1, id commitments H(secret) by P1 at
    t = 2, rate commitments H(id, limit) by P1 at t = 3 (the limit a
    stride-0 view of one column), then set_leaves_mont(0, .) on a depth-20
    DeviceMerkleTree. Returns (tree, canonical secrets, rate commitments,
    the two commitment calls as {name: (P1's inputs, its output)})."""
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.ff.field import FR, FrField
    from zerokit_tpu_torch.hash.poseidon import poseidon_hash_mont, poseidon_hash_pair_mont
    from zerokit_tpu_torch.tree.batched import DeviceMerkleTree

    n = 1 << TREE_DEPTH
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] %= R >> 240
    secrets = on_card(limbs)
    mont = FrField.to_mont(secrets)
    ids = poseidon_hash_mont([mont])
    limit = FR.encode([USER_LIMIT]).cuda().expand(16, n)
    rate = poseidon_hash_pair_mont(ids, limit)
    tree = DeviceMerkleTree(TREE_DEPTH)
    tree.set_leaves_mont(0, rate)
    calls = {"id commitments H(secret), t=2": ([mont], ids),
             "rate commitments H(id, limit), t=3, limit at lane stride 0": ([ids, limit], rate)}
    return tree, secrets, rate, calls


def check_tree_natively(idx: np.ndarray, tree, secrets, rate) -> None:
    """The device tree against the native host library (independent code):
    the leaves at idx (64 sampled indices) equal H(H(secret), limit) by the
    host poseidon_hash, the paths of every fourth of them from proofs_batch
    give the device root through merkle_compute_root_native, and a depth-14
    device tree of the first 2^14 rate commitments equals a native rebuild
    level by level."""
    from zerokit_tpu_torch.ff.field import FR, decode_canonical_fast
    from zerokit_tpu_torch.hash.poseidon import poseidon_hash
    from zerokit_tpu_torch.runtime import native
    from zerokit_tpu_torch.tree.batched import DeviceMerkleTree

    sec = decode_canonical_fast(secrets[:, torch.as_tensor(idx).cuda()].cpu())
    leaves = FR.decode(tree._levels[TREE_DEPTH][:, torch.as_tensor(idx).cuda()])
    for s, leaf in zip(sec, leaves):
        if int(leaf) != poseidon_hash([poseidon_hash([s]), USER_LIMIT]):
            raise AssertionError("a device leaf differs from the host H(H(secret), limit)")
    log(f"  64 sampled leaves equal the host (native) H(H(secret), {USER_LIMIT})")
    paths = [int(i) for i in idx[:: 64 // BATCH]]
    elems, bits = tree.proofs_batch(paths)
    root = tree.root()
    for k, i in enumerate(paths):
        if native.merkle_compute_root_native(tree.get(i), elems[k], bits[k]) != root:
            raise AssertionError(f"the native root of leaf {i}'s path differs from the device root")
    log(f"  {len(paths)} paths from proofs_batch give the device root through "
        f"merkle_compute_root_native")
    small = DeviceMerkleTree(NATIVE_DEPTH)
    small.set_leaves_mont(0, rate[:, : 1 << NATIVE_DEPTH])
    level = [int(v) for v in FR.decode(small._levels[NATIVE_DEPTH])]
    hashes = 0
    for lv in range(NATIVE_DEPTH - 1, -1, -1):
        level = native.poseidon_hash_pairs_native(level[0::2], level[1::2])
        hashes += len(level)
        if level != [int(v) for v in FR.decode(small._levels[lv])]:
            raise AssertionError(f"depth-{NATIVE_DEPTH} device tree level {lv} differs from "
                                 f"the native rebuild")
    log(f"  depth-{NATIVE_DEPTH} device tree equals the native rebuild level by level "
        f"({hashes} hashes)")


def run_facade(tree, secrets, paths) -> dict:
    """The RLN facade on RLN.stateless() (the embedded depth-20 circuit, on
    the card): a batch of 16 RLNWitnessInput.new_single from the tree's own
    paths, then a second batch of the same members with other signals in
    the same epoch; each proof verifies singly, each batch by verify_batch,
    each proof by verify_with_roots against the tree's root; member 0's two
    proofs give its secret back. Then the README quick start on
    RLN.stateful(). Returns the batches' host seconds."""
    from zerokit_tpu_torch import (RLN, RLNWitnessInput, hash_to_field_le, keygen,
                                   poseidon_hash_pair)
    from zerokit_tpu_torch.ff.field import decode_canonical_fast

    t0 = time.perf_counter()
    rln = RLN.stateless()
    setup_s = time.perf_counter() - t0
    elems, bits = tree.proofs_batch(paths)
    sec = decode_canonical_fast(secrets[:, torch.as_tensor(paths).cuda()].cpu())
    ext = poseidon_hash_pair(hash_to_field_le(b"epoch"), hash_to_field_le(b"rln-app"))
    root = tree.root()
    batches, seconds = [], []
    for round_ in range(2):
        ws = [RLNWitnessInput.new_single(s, USER_LIMIT, 1, e, b,
                                         hash_to_field_le(b"signal %d %d" % (round_, k)), ext)
              for k, (s, e, b) in enumerate(zip(sec, elems, bits))]
        t0 = time.perf_counter()
        out = rln.generate_proofs(ws)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        for (proof, values), w in zip(out, ws):
            if values.root != root:
                raise AssertionError("a witness's root differs from the device tree's")
            if not rln.verify(proof, values):
                raise AssertionError("a facade proof failed verify")
            rln.verify_with_roots(proof, values, w.x, [root])
        if not rln.verify_batch([p for p, _ in out], [v for _, v in out]):
            raise AssertionError("a facade batch failed verify_batch")
        batches.append(out)
    if RLN.recover_id_secret(batches[0][0][1], batches[1][0][1]) != sec[0]:
        raise AssertionError("recover_id_secret did not give member 0's secret")
    log(f"  RLN.stateless() ready in {setup_s:.1f} s; {BATCH} facade proofs from the tree's "
        f"paths, first batch {seconds[0]:.3f} s ({BATCH / seconds[0]:.3f} proofs/s), second "
        f"(warm) batch {seconds[1]:.3f} s ({BATCH / seconds[1]:.3f} proofs/s): each verifies, "
        f"each batch by verify_batch, each against the tree's root by verify_with_roots; "
        f"member 0's two signals in one epoch give its secret back (recover_id_secret)")
    stateful = RLN.stateful()
    secret, commitment = keygen()
    stateful.set_leaf(7, poseidon_hash_pair(commitment, USER_LIMIT))
    mp = stateful.get_merkle_proof(7)
    signal = hash_to_field_le(b"hello")
    w = RLNWitnessInput.new_single(secret, USER_LIMIT, 1, mp.get_path_elements(),
                                   mp.get_path_index(), signal, ext)
    proof, values = stateful.generate_proof(w)
    stateful.verify_rln_proof(proof, values, signal)
    log("  README quick start on RLN.stateful(): keygen, set_leaf, get_merkle_proof, "
        "generate_proof, verify_rln_proof")
    return {"first_s": seconds[0], "warm_s": seconds[1]}


def phase_tree(rng, checks: KernelChecks, chip, smi: str) -> dict:
    """Phase 10. The main path (launch counters at 0 before, read after):
    the member tree and the facade on 16 of its members. Then the tree's
    warm rebuild timed over 3 runs by CUDA events with its bound, each
    level's own P1 call timed by device_ms with its bound and launch shape
    (tools/profile_tree), the native parity checks (on 64 sampled members,
    the facade's 16 among them), and P1 against its dense plain version at
    every launch shape launch_shape picks: the tree's own leaf level in
    place (2^19 pairs, 8-warp blocks; the JSON entry, timed by device_ms
    with its bound), its levels of 2^15 and 2^14 pairs (4- and 2-warp
    blocks) and 2^13 pairs (4 threads a hash in 4-warp blocks), the main
    path's two commitment calls on their own inputs (2^20 lanes: t = 2,
    and t = 3 with the limit at lane stride 0), every t = 2..9 at P1_LANES
    (group_of(t) threads a hash in 1- and 2-warp blocks; a thread a hash in
    one-warp blocks at t = 9, 4096 lanes; timed with its bound at P1_TIMED)
    on seeded inputs with edge lanes (numpy seed 20), and the strided call
    form against copied lefts and rights."""
    from zerokit_tpu_torch.hash import poseidon_kernels as pk
    from zerokit_tpu_torch.runtime.profiling import (device_ms, host_call, kernel_bound,
                                                     launch_counts, reset_launches)
    from zerokit_tpu_torch.tools.profile_tree import level_times, print_levels, rebuild_ms

    idx = np.sort(rng.choice(1 << TREE_DEPTH, size=64, replace=False))
    paths = [int(i) for i in idx[:: 64 // BATCH]]
    reset_launches()
    tree, secrets, rate, commitments = build_member_tree(rng)
    torch.cuda.synchronize()
    build_counts = launch_counts()
    nodes = sum(lv.numel() for lv in tree._levels) // 16
    log(f"  depth-{TREE_DEPTH} tree of {1 << TREE_DEPTH} members built on the card; launches "
        f"{ {k: v for k, v in build_counts.items() if v} }; device memory of its levels "
        f"{nodes} nodes x 64 B = {nodes * 64 / 1e6:.1f} MB")
    facade = run_facade(tree, secrets, paths)
    counts = launch_counts()
    log(f"  launches in phase 10's main path (the tree, then the facade): {counts}")
    runs = rebuild_ms(tree, rate)
    hashes = (1 << TREE_DEPTH) - 1
    levels = level_times(tree, chip)
    rebuild_bound = sum(r["bound_ms"] for r in levels)
    log(f"  warm rebuild (set_leaves_mont, {TREE_DEPTH} P1 launches) by CUDA events: "
        + ", ".join(f"{ms:.4f}" for ms in runs) + f" ms; {hashes / (min(runs) * 1e-3) / 1e6:.3f} "
        f"M hashes/s over {hashes} hashes; bound {rebuild_bound:.4f} ms, share "
        f"{rebuild_bound / min(runs):.1%}; {smi}")
    log("  each level's own P1 call on the tree's levels in place (device_ms, 10 calls):")
    print_levels(levels, smi)
    sms = chip.sm_count
    log("  launch shape a level (blocks x threads a block / threads a hash): " + ", ".join(
        "{}: {} x {} / {}".format(r["level"], *pk.launch_shape(r["lanes"], sms, 3))
        for r in levels))
    check_tree_natively(idx, tree, secrets, rate)

    def check(what: str, ins: list, got=None, want=None) -> int:
        """P1 (or its output `got`) against the dense plain version (or its
        output `want`)."""
        got = pk.poseidon_perm(ins) if got is None else got
        want = pk.poseidon_perm_plain(ins) if want is None else want
        err = max_abs_err(got, want)
        checks.errors.setdefault("P1", []).append(err)
        blocks, threads, group = pk.launch_shape(got.shape[1], sms, len(ins) + 1)
        log(f"  P1 {what} ({blocks} x {threads} threads, {group} a hash): max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"P1 disagrees with its plain version: {what}")
        return err

    leaf = tree._levels[TREE_DEPTH]
    lefts, rights = leaf[:, 0::2], leaf[:, 1::2]
    n = lefts.shape[1]
    got, kernel_s = host_call(lambda: pk.poseidon_perm([lefts, rights]))
    want, plain_s = host_call(lambda: (pk.poseidon_perm_plain([lefts, rights]),
                                       torch.cuda.synchronize())[0])
    err = check(f"t=3 on the tree's leaf level in place ({n} pairs)", [lefts, rights], got,
                want)
    ms = device_ms(lambda: pk.poseidon_perm([lefts, rights]), 10, kernel_s)
    checks.record("P1", f"poseidon t=3, leaf level in place, {n} lanes", err, ms,
                  plain_s * 1e3, {"t": 3, "lanes": n}, "calls back to back; plain: one call")
    sec, res = kernel_bound("P1", chip, t=3, lanes=n)
    log(f"    bound {sec * 1e3:.4f} ms ({res}), share {sec * 1e3 / ms:.1%}; {smi}")
    for lv in (15, 14, 13):  # a thread a hash in 4- and 2-warp blocks; 4 threads a hash
        level = tree._levels[lv + 1]
        check(f"t=3 on the tree's level {lv} in place ({level.shape[1] // 2} pairs)",
              [level[:, 0::2], level[:, 1::2]])
    for what, (ins, out) in commitments.items():
        check(f"{what}, the main path's call on its own {out.shape[1]} lanes", ins, out)
    p20 = np.random.default_rng(20)
    for t in range(2, 10):
        for lanes in P1_LANES:
            ins = [poseidon_inputs(p20, lanes) for _ in range(t - 1)]
            if lanes != P1_TIMED:
                check(f"t={t}, {lanes} lanes", ins)
                continue
            checks.run("P1", f"poseidon t={t}, {lanes} lanes", lambda: pk.poseidon_perm(ins),
                       lambda: pk.poseidon_perm_plain(ins), {"t": t, "lanes": lanes}, reps=3)
            b_sec, _ = kernel_bound("P1", chip, t=t, lanes=lanes)
            log(f"    bound {b_sec * 1e3:.4f} ms, share {b_sec * 1e3 / checks.rows[-1][2]:.1%}")
    level = poseidon_inputs(p20, 8192)
    strided = pk.poseidon_perm([level[:, 0::2], level[:, 1::2]])
    copied = pk.poseidon_perm([level[:, 0::2].contiguous(), level[:, 1::2].contiguous()])
    err = max_abs_err(strided, copied)
    checks.errors["P1"].append(err)
    log(f"  P1 strided tree-level form against copied lefts and rights "
        f"({level.shape[1] // 2} pairs): max_abs_err {err}")
    if err != 0:
        raise AssertionError("P1's strided form differs from the copied form")
    return {"counts": counts, "bound_ms": sec * 1e3, "bound_by": res,
            "rebuild_ms": runs, "rebuild_bound_ms": rebuild_bound,
            "levels_ms": [r["ms"] for r in levels], **facade}


# ---------------------------------------------------------------------------
# Phase 11: the serving surface (HTTP service, checkpointed batches, PmTree,
# the C ABI, the CLIs)
# ---------------------------------------------------------------------------

SERVE_MEMBERS = 4096  # rate commitments of the tree phase 11 serves from
SERVE_REQUESTS = 48  # concurrent POST /prove requests
SERVE_MAX_BATCH, SERVE_WAIT_MS = 16, 50
CHECKPOINT_WITNESSES, CHECKPOINT_CHUNK = 40, 16
# tests/test_cli.py's relay script
RELAY_SCRIPT = "\n".join([
    "register", "register", "send 0 hello", "send 1 hi there", "send 0 again", "epoch two",
    "send 0 fresh epoch", "send 9 nobody", "root", "log", "quit", "",
])


class ServingMembers:
    """SERVE_MEMBERS members from seeded secrets, their rate commitments
    H(H(secret), limit) by the host hash, held in a depth-20
    OptimalMerkleTree (hasher on the card; the native library rehashes)."""

    def __init__(self, rng):
        from zerokit_tpu_torch import hash_to_field_le, poseidon_hash, poseidon_hash_pair
        from zerokit_tpu_torch.constants import R
        from zerokit_tpu_torch.tree.merkle import OptimalMerkleTree

        self.secrets = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(SERVE_MEMBERS)]
        self.rates = [poseidon_hash_pair(poseidon_hash([s]), USER_LIMIT) for s in self.secrets]
        self.tree = OptimalMerkleTree(TREE_DEPTH, device="cuda")
        self.tree.set_range(0, self.rates)
        self.root = self.tree.root()
        self.ext = poseidon_hash_pair(hash_to_field_le(b"serving epoch"),
                                      hash_to_field_le(b"serving app"))

    def witness(self, k: int, signal: bytes, tree=None):
        from zerokit_tpu_torch import RLNWitnessInput, hash_to_field_le

        mp = (tree or self.tree).proof(k)
        return RLNWitnessInput.new_single(self.secrets[k], USER_LIMIT, 1, mp.get_path_elements(),
                                          mp.get_path_index(), hash_to_field_le(signal), self.ext)


def serve_http(rln, members, smi: str) -> dict:
    """(a) ProverService behind its ThreadingHTTPServer (ProverHTTPServer,
    a backlog for a burst) on 127.0.0.1:0: 48
    concurrent POST /prove from 48 client threads, each reply decoded and
    verified by POST /verify with its x and the tree's root, all by
    verify_batch, a tampered one read invalid; the batch sizes; /prove_partial
    then /finish; /keygen, /poseidon, /healthz."""
    import http.client
    import threading

    from zerokit_tpu_torch import hash_to_field_le, poseidon_hash, seeded_keygen
    from zerokit_tpu_torch.protocol import serialize as ser
    from zerokit_tpu_torch.protocol.proof import RLNProof
    from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput
    from zerokit_tpu_torch.server import ProverHTTPServer, ProverService, make_handler

    batches = []  # (batch size, prove_batch host seconds) of each service batch
    prove_batch = rln.prover.prove_batch

    def timed_prove_batch(named, rs, ss, metrics=None):
        t0 = time.perf_counter()
        out = prove_batch(named, rs, ss, metrics=metrics)
        torch.cuda.synchronize()
        batches.append((len(rs), time.perf_counter() - t0))
        return out

    t0 = time.perf_counter()
    svc = ProverService(rln, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS)
    warm_s = time.perf_counter() - t0
    rln.prover.prove_batch = timed_prove_batch  # after the warm-up's batch of one
    server = ProverHTTPServer(("127.0.0.1", 0), make_handler(svc))
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    port = server.server_address[1]

    def post(path: str, payload: dict) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read() or b"{}")
        finally:
            conn.close()
        if resp.status != 200:
            raise AssertionError(f"POST {path}: HTTP {resp.status} {data}")
        return data

    try:
        ws = [members.witness(k, b"http %d" % k) for k in range(SERVE_REQUESTS)]
        wires = [ser.rln_witness_to_bytes(w).hex() for w in ws]
        replies = [None] * SERVE_REQUESTS
        failures = []
        gate = threading.Barrier(SERVE_REQUESTS + 1)

        def client(k: int) -> None:
            gate.wait()
            try:
                replies[k] = post("/prove", {"witness_hex": wires[k]})["proof_hex"]
            except BaseException as e:  # re-raised in the main thread below
                failures.append(f"request {k}: {type(e).__name__}: {e}")

        clients = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_REQUESTS)]
        for c in clients:
            c.start()
        gate.wait()
        t0 = time.perf_counter()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        if failures:
            raise AssertionError(f"/prove failed: {failures[:3]}")
        sizes = [b for b, _ in batches]
        proved_s = sum(s for _, s in batches)
        if sum(sizes) != SERVE_REQUESTS or max(sizes) > SERVE_MAX_BATCH or max(sizes) < 2:
            raise AssertionError(f"service batches {sizes}: not {SERVE_REQUESTS} requests in "
                                 f"batches of at most {SERVE_MAX_BATCH}, one above 1")
        proofs = []
        for k, hexed in enumerate(replies):
            rp, read = ser.bytes_to_rln_proof(bytes.fromhex(hexed))
            if read != len(hexed) // 2 or rp.proof_values.x != ws[k].x:
                raise AssertionError(f"reply {k} does not decode to its request's proof")
            ok = post("/verify", {"proof_hex": hexed, "x": format(ws[k].x, "x"),
                                  "roots": [format(members.root, "x")]})
            if ok.get("valid") is not True:
                raise AssertionError(f"reply {k} failed POST /verify: {ok}")
            proofs.append(rp)
        if not rln.verify_batch([p.proof for p in proofs], [p.proof_values for p in proofs]):
            raise AssertionError("the service's proofs failed verify_batch")
        tampered = ser.rln_proof_to_bytes(RLNProof(proof=proofs[1].proof,
                                                   proof_values=proofs[0].proof_values))
        bad = post("/verify", {"proof_hex": tampered.hex(), "x": format(ws[0].x, "x"),
                               "roots": [format(members.root, "x")]})
        if bad.get("valid") is not False:
            raise AssertionError(f"a tampered proof read {bad}")
        log(f"  (a) {SERVE_REQUESTS} concurrent POST /prove from {SERVE_REQUESTS} client threads "
            f"(ProverService max_batch={SERVE_MAX_BATCH}, max_wait_ms={SERVE_WAIT_MS}; its "
            f"warm-up, the tables and a throwaway batch of one, {warm_s:.3f} s before serving): "
            f"wall {wall:.3f} s, {SERVE_REQUESTS / wall:.3f} proofs/s; batches {sizes}; their "
            f"prove_batch {[round(s, 4) for _, s in batches]} s, sum {proved_s:.3f} s "
            f"({SERVE_REQUESTS / proved_s:.3f} proofs/s), the service's overhead "
            f"{wall - proved_s:.3f} s; {smi}")
        log(f"      every reply decodes and passes POST /verify with its x and the tree's root; "
            f"all {SERVE_REQUESTS} pass verify_batch; a tampered proof reads valid: false")

        pw = RLNPartialWitnessInput.from_witness(ws[0])
        t0 = time.perf_counter()
        partial = post("/prove_partial", {
            "partial_witness_hex": ser.rln_partial_witness_to_bytes(pw).hex()})
        partial_s = time.perf_counter() - t0
        finish_w = members.witness(0, b"http finish")
        t0 = time.perf_counter()
        done = post("/finish", {"partial_proof_hex": partial["partial_proof_hex"],
                                "witness_hex": ser.rln_witness_to_bytes(finish_w).hex()})
        finish_s = time.perf_counter() - t0
        ok = post("/verify", {"proof_hex": done["proof_hex"], "x": format(finish_w.x, "x"),
                              "roots": [format(members.root, "x")]})
        fp, _ = ser.bytes_to_rln_proof(bytes.fromhex(done["proof_hex"]))
        if ok.get("valid") is not True or not rln.verify(fp.proof, fp.proof_values):
            raise AssertionError("/prove_partial then /finish gave a proof that fails")
        log(f"      /prove_partial {partial_s:.3f} s, then /finish {finish_s:.3f} s: the proof "
            f"verifies; {smi}")
        key = post("/keygen", {"seed_hex": b"serving seed".hex()})
        sk, pk = seeded_keygen(b"serving seed")
        if int(key["secret"], 16) != int(sk) or int(key["commitment"], 16) != pk:
            raise AssertionError("/keygen with a seed differs from seeded_keygen")
        inputs = [members.rates[3], hash_to_field_le(b"poseidon input")]
        got = int(post("/poseidon", {"inputs": [format(v, "x") for v in inputs]})["hash"], 16)
        if got != poseidon_hash(inputs):
            raise AssertionError("/poseidon differs from the host hash")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        if health.get("tree_depth") != TREE_DEPTH or health.get("total_proofs") != SERVE_REQUESTS:
            raise AssertionError(f"/healthz: {health}")
        log(f"      /keygen equals seeded_keygen, /poseidon the host hash; /healthz {health}")
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        rln.prover.prove_batch = prove_batch
    return {"wall_s": wall, "sizes": sizes, "prove_batch_s": [s for _, s in batches]}


def serve_checkpointed(rln, members, smi: str) -> None:
    """(b) CheckpointedBatchProver over the service's RLN: 40 witnesses in
    chunks of 16 in a temporary directory, then a second run on it proves
    nothing and returns the same bytes; every proof verifies."""
    import tempfile

    from zerokit_tpu_torch.protocol import serialize as ser
    from zerokit_tpu_torch.runtime.batch_job import CheckpointedBatchProver

    calls = []
    generate = rln.generate_proofs

    def counted(ws, *args, **kwargs):
        calls.append(len(ws))
        return generate(ws, *args, **kwargs)

    rln.generate_proofs = counted
    try:
        ws = [members.witness(100 + k, b"checkpointed %d" % k)
              for k in range(CHECKPOINT_WITNESSES)]
        os.makedirs(SCRATCH_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=SCRATCH_DIR) as d:
            t0 = time.perf_counter()
            first = CheckpointedBatchProver(rln, d, chunk_size=CHECKPOINT_CHUNK).run(ws)
            first_s = time.perf_counter() - t0
            chunks = list(calls)
            t0 = time.perf_counter()
            again = CheckpointedBatchProver(rln, d, chunk_size=CHECKPOINT_CHUNK).run(ws)
            again_s = time.perf_counter() - t0
    finally:
        rln.generate_proofs = generate
    if calls != chunks or chunks != [16, 16, 8]:
        raise AssertionError(f"checkpointed runs proved chunks {chunks}, then "
                             f"{calls[len(chunks):]}")
    if [ser.proof_v3_to_bytes(p, v) for p, v in again] != [
            ser.proof_v3_to_bytes(p, v) for p, v in first]:
        raise AssertionError("the resumed run's proofs differ from the first run's")
    if not rln.verify_batch([p for p, _ in first], [v for _, v in first]):
        raise AssertionError("a checkpointed proof failed verify_batch")
    log(f"  (b) CheckpointedBatchProver: {CHECKPOINT_WITNESSES} witnesses in chunks {chunks}, "
        f"{first_s:.3f} s; the second run on the same directory proved nothing in "
        f"{again_s:.3f} s and returned the same bytes; all verify (verify_batch); {smi}")


def serve_pmtree(members, smi: str) -> None:
    """(c) RLN.stateful over a persistent PmTree on the card:
    init_tree_with_leaves of the 4096 rate commitments, one proof from its
    path verified against its root; the same leaves in a persistent PmTree
    closed and reopened from its path have the same root, and it equals the
    OptimalMerkleTree's."""
    import tempfile

    from zerokit_tpu_torch import RLN, hash_to_field_le
    from zerokit_tpu_torch.tree.pmtree import PmTree, PmTreeConfig

    os.makedirs(SCRATCH_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH_DIR) as d:
        path = os.path.join(d, "members.pmtree")

        def persistent():
            return PmTree(TREE_DEPTH, PmTreeConfig.create(temporary=False, path=path),
                          device="cuda")

        rln = RLN.stateful(tree=persistent(), device="cuda")
        t0 = time.perf_counter()
        rln.init_tree_with_leaves(members.rates)
        init_s = time.perf_counter() - t0
        if not isinstance(rln.tree, PmTree) or rln.tree.device != torch.device("cuda"):
            raise AssertionError(f"init_tree_with_leaves left a {type(rln.tree).__name__} on "
                                 f"{getattr(rln.tree, 'device', None)}")
        root = rln.get_root()
        k = 777
        w = members.witness(k, b"pmtree member", tree=rln.tree)
        t0 = time.perf_counter()
        proof, values = rln.generate_proof(w)
        prove_s = time.perf_counter() - t0
        rln.verify_rln_proof(proof, values, hash_to_field_le(b"pmtree member"))
        rln.tree.close_db_connection()
        # init_tree_with_leaves rebuilds as type(tree)(depth, device=...), so the
        # tree it leaves is temporary (the config is dropped, as the JAX facade
        # drops it): persistence is shown on the path's own tree
        t0 = time.perf_counter()
        tree = persistent()
        tree.set_range(0, members.rates)
        tree.close_db_connection()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reopened = persistent()
        reopen_s = time.perf_counter() - t0
        if not (reopened.root() == root == members.root):
            raise AssertionError("the reopened PmTree's root differs")
        reopened.close_db_connection()
    log(f"  (c) RLN.stateful(tree=PmTree({TREE_DEPTH}, persistent), device='cuda'): "
        f"init_tree_with_leaves of {SERVE_MEMBERS} rate commitments {init_s:.3f} s; member "
        f"{k}'s proof from its path ({prove_s:.3f} s) passes verify_rln_proof against its root; "
        f"the leaves written to a persistent PmTree, closed ({write_s:.3f} s) and reopened from "
        f"its path ({reopen_s:.3f} s) give the same root, equal to the OptimalMerkleTree's; "
        f"{smi}")


class RlnBuffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.POINTER(ctypes.c_uint8)), ("len", ctypes.c_size_t)]


def serve_ffi(rln, members, smi: str) -> dict:
    """(d) The C ABI: build_ffi(), then build/zerokit_tpu_torch/librln_ffi.so
    through ctypes with ZEROKIT_TORCH_DEVICE=cuda; a stateful depth-20
    engine (optimal tree) by rln_new; set_leaf, get_merkle_proof,
    rln_generate_proof, rln_verify, rln_verify_with_roots and
    rln_recover_id_secret over two signals in one epoch;
    rln_generate_proof_with_rs against the facade's generate_proof(w, r=,
    s=) byte for byte; rln_generate_proofs on 16 witnesses, each verified."""
    from zerokit_tpu_torch.ff.field import DEVICE_ENV
    from zerokit_tpu_torch.protocol import serialize as ser
    from zerokit_tpu_torch.runtime.build import build_ffi

    os.environ[DEVICE_ENV] = "cuda"
    t0 = time.perf_counter()
    path = build_ffi()
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.rln_last_error.restype = ctypes.c_char_p
    lib.rln_new.restype = ctypes.c_uint64
    lib.rln_new.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    if lib.rln_init() != 0:
        raise AssertionError(f"rln_init: {lib.rln_last_error()}")

    def call(name: str, *args) -> bytes:
        buf = RlnBuffer()
        if getattr(lib, name)(*args, ctypes.byref(buf)) != 0:
            raise AssertionError(f"{name}: {lib.rln_last_error()}")
        out = ctypes.string_at(buf.ptr, buf.len)
        lib.rln_buffer_free(ctypes.byref(buf))
        return out

    def flag(name: str, *args) -> int:
        ok = ctypes.c_int(-1)
        if getattr(lib, name)(*args, ctypes.byref(ok)) != 0:
            raise AssertionError(f"{name}: {lib.rln_last_error()}")
        return ok.value

    def fr(v: int) -> bytes:
        return ser.fr_to_bytes(v, False)

    t0 = time.perf_counter()
    h = lib.rln_new(1, b"single", b"optimal", None, 0, None, 0, None)
    new_s = time.perf_counter() - t0
    if h == 0:
        raise AssertionError(f"rln_new: {lib.rln_last_error()}")
    try:
        k = 5
        if lib.rln_set_leaf(h, k, fr(members.rates[k])) != 0:
            raise AssertionError(f"rln_set_leaf: {lib.rln_last_error()}")
        data = call("rln_get_merkle_proof", h, k)
        elems, used = ser.bytes_to_vec_fr(data, False)
        bits, _ = ser.bytes_to_vec_u8(data[used:], False)
        from zerokit_tpu_torch import RLNWitnessInput, hash_to_field_le

        def wire(signal: bytes) -> bytes:
            return ser.rln_witness_to_bytes(RLNWitnessInput.new_single(
                members.secrets[k], USER_LIMIT, 1, elems, bits, hash_to_field_le(signal),
                members.ext))

        proofs, latency = [], []
        for signal in (b"ffi one", b"ffi two"):
            wb = wire(signal)
            t0 = time.perf_counter()
            proofs.append(call("rln_generate_proof", h, wb, len(wb), 0))
            latency.append(time.perf_counter() - t0)
        root = call("rln_get_root", h)
        roots = ser.vec_fr_to_bytes([ser.bytes_to_fr(root, False)[0]], False)
        for p, signal in zip(proofs, (b"ffi one", b"ffi two")):
            x = fr(hash_to_field_le(signal))
            if (flag("rln_verify", h, p, len(p)) != 1
                    or flag("rln_verify_with_roots", h, p, len(p), x, roots, len(roots)) != 1):
                raise AssertionError("an FFI proof failed rln_verify / rln_verify_with_roots")
        got = call("rln_recover_id_secret", proofs[0], len(proofs[0]), proofs[1], len(proofs[1]))
        if ser.bytes_to_fr(got, False)[0] != members.secrets[k]:
            raise AssertionError("rln_recover_id_secret did not give the member's secret")
        wb = wire(b"ffi with rs")
        r, s = hash_to_field_le(b"ffi r"), hash_to_field_le(b"ffi s")
        with_rs = call("rln_generate_proof_with_rs", h, wb, len(wb), 0, fr(r), fr(s))
        w, _ = ser.bytes_to_rln_witness(wb)
        facade = ser.proof_v3_to_bytes(*rln.generate_proof(w, r=r, s=s))
        if with_rs != facade:
            raise AssertionError("rln_generate_proof_with_rs differs from the facade's proof")
        ws = [members.witness(200 + j, b"ffi batch %d" % j) for j in range(BATCH)]
        blob = b"".join(ser.rln_witness_to_bytes(w) for w in ws)
        t0 = time.perf_counter()
        out = call("rln_generate_proofs", h, ctypes.c_size_t(BATCH), blob, len(blob), 0)
        batch_s = time.perf_counter() - t0
        size = len(proofs[0])
        if len(out) != BATCH * size:
            raise AssertionError(f"rln_generate_proofs gave {len(out)} bytes for {BATCH} proofs")
        for j in range(BATCH):
            p = out[j * size:(j + 1) * size]
            if flag("rln_verify", h, p, len(p)) != 1:
                raise AssertionError(f"batch proof {j} failed rln_verify")
    finally:
        lib.rln_free(h)
    log(f"  (d) C ABI: build_ffi {build_s:.1f} s ({os.path.relpath(path)}); rln_new (stateful, "
        f"depth {TREE_DEPTH}, optimal tree, on {os.environ[DEVICE_ENV]}) {new_s:.3f} s; "
        f"rln_generate_proof {latency[0]:.3f} s first, {latency[1]:.3f} s second; both pass "
        f"rln_verify and rln_verify_with_roots, and rln_recover_id_secret gives the member's "
        f"secret; rln_generate_proof_with_rs equals the facade's generate_proof(w, r=, s=) byte "
        f"for byte ({len(with_rs)} B); rln_generate_proofs of {BATCH}: {batch_s:.3f} s "
        f"({BATCH / batch_s:.3f} proofs/s), each passes rln_verify; {smi}")
    return {"latency_s": latency, "batch_s": batch_s}


def serve_clis(smi: str) -> None:
    """(e) The CLIs as subprocesses from the repository root, on the card:
    stateless and multi-message-id (--demo --prove), partial (--demo; it
    always proves), and the relay REPL at depth 20 with --prove over stdin
    (tests/test_cli.py's script); each exits 0 and prints its outcome lines."""
    runs = [
        ("stateless", ["--demo", "--prove"], None,
         ["proof verified against accepted roots: True"]),
        ("partial", ["--demo"], None,
         ["message 0: finished in", "message 1: finished in", "verified: True"]),
        ("multi_message_id", ["--demo", "--prove"], None, ["multi proof verified: True"]),
        ("relay", ["--depth", str(TREE_DEPTH), "--prove"], RELAY_SCRIPT,
         ["SPAM: user 0 double-signaled", "(matches: True)", "no such user 9", "bye"]),
    ]
    for module, args, stdin, outcomes in runs:
        cmd = [sys.executable, "-m", f"zerokit_tpu_torch.cli.{module}", *args,
               "--device", "cuda"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=300,
                           cwd=REPO_ROOT)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[1:])} exited {r.returncode}: {r.stderr[-3000:]}")
        missing = [o for o in outcomes if o not in r.stdout]
        if module == "relay" and r.stdout.count("sent; nullifier") != 3:
            missing.append("three 'sent; nullifier' lines")
        if module == "relay" and r.stdout.count("proof verified: True") != 4:
            missing.append("four 'proof verified: True' lines")
        if module == "partial" and r.stdout.count("verified: True") != 2:
            missing.append("two verified messages")
        if missing:
            raise AssertionError(f"{module} did not print {missing}:\n{r.stdout[-3000:]}")
        lines = [ln for ln in r.stdout.splitlines() if any(o in ln for o in outcomes)
                 or "sent; nullifier" in ln]
        log(f"  (e) python -m zerokit_tpu_torch.cli.{module} {' '.join(args)} --device cuda: "
            f"exit 0 in {wall:.1f} s (wall, process start included); {smi}")
        for ln in lines:
            log(f"      | {ln[:140]}")


def phase_serving(rng, smi: str) -> dict:
    """Phase 11: (a) to (d) in this process with the launch counters at 0
    before (a) and read after (d); (e) in subprocesses."""
    from zerokit_tpu_torch import RLN
    from zerokit_tpu_torch.runtime.profiling import launch_counts, reset_launches

    t0 = time.perf_counter()
    members = ServingMembers(rng)
    log(f"  {SERVE_MEMBERS} seeded members in a depth-{TREE_DEPTH} OptimalMerkleTree "
        f"({time.perf_counter() - t0:.1f} s, host hash)")
    reset_launches()
    rln = RLN.stateless(device="cuda")
    http = serve_http(rln, members, smi)
    serve_checkpointed(rln, members, smi)
    serve_pmtree(members, smi)
    ffi = serve_ffi(rln, members, smi)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  (f) launches in phase 11's (a)-(d): {counts}")
    serve_clis(smi)
    return {"counts": counts, **http, "ffi": ffi}


# ---------------------------------------------------------------------------
# Phase 12: the mesh prover (parallel/) at depth 20
# ---------------------------------------------------------------------------

MESH_RUNS = (("a", 1, "nccl"), ("b", 2, "gloo"), ("c", 4, "gloo"))  # label, ranks, backend
MESH_TIMEOUT = 300  # seconds a run's ranks may take before they are killed


def mesh_shape(world: int) -> tuple:
    """(dp, tp) of a run's ranks: parallel/dryrun.dryrun_mesh's rule."""
    tp = 2 if world % 2 == 0 else 1
    return world // tp, tp


def small_dft_plain(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """Plain version of ntt_sharded._local_small_dft: y[k1] = sum_i1
    W[k1][i1] x[i1], one FrPlain product and add at a time."""
    from zerokit_tpu_torch.ff.field import FrPlain

    w = on_card(mat)  # (16, n1, n1)
    l, b, n1, m = x.shape
    rows = []
    for k1 in range(n1):
        acc = None
        for i1 in range(n1):
            wk = w[:, k1, i1][:, None, None].expand(l, b, m).contiguous()
            term = FrPlain.mul(x[:, :, i1].contiguous(), wk)
            acc = term if acc is None else FrPlain.add(acc, term)
        rows.append(acc)
    return torch.stack(rows, dim=2)


def tree_plain(comps: int, gathered: torch.Tensor) -> torch.Tensor:
    """Plain version of sharded._tree_reduce_points on (D, 16, C, 3, B): the
    same halving rounds (partial i meets partial half + i, the odd one
    carried), each add by ec_op_plain."""
    from zerokit_tpu_torch.ff import field_kernels as fk

    parts = list(gathered.unbind(0))
    while len(parts) > 1:
        half = len(parts) // 2
        parts = ([fk.ec_op_plain("add", comps, parts[i].contiguous(),
                                 parts[half + i].contiguous()) for i in range(half)]
                 + parts[2 * half:])
    return parts[0]


def phase_mesh_kernels(rng, checks: KernelChecks, prover) -> None:
    """Phase 12's kernels at the shapes the mesh path gives them in each run
    with tp > 1, against their plain versions on the same card tensors:
    the Bailey NTT of the sharded QAP lift (parallel/ntt_sharded.py) on the
    run's a/b/c rows (3 x the dp rank's lanes): the small DFT's and the
    twiddle's K1 products, the row powers' K1 product, the local
    length-n2 NTT's K4 stages and K5 tail (the inverse with its 1/N
    table), and natural_ntt whole against natural_ntt_plain; then the
    ShardedMSM pass of the last tp rank's shard (K3 fine and coarse, K2's
    bucket add) and the tp combine's K2 tree (_tree_reduce_points at D = 2
    and 4, the a/b1/l, b2 and h accumulators' widths) against tree_plain."""
    from types import SimpleNamespace

    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.ff.field import FrField, FrPlain
    from zerokit_tpu_torch.ff.fq2 import Fq2Adapter, FqAdapter
    from zerokit_tpu_torch.groth16 import ntt as ntt_host
    from zerokit_tpu_torch.groth16.curve import CurveOps
    from zerokit_tpu_torch.parallel import ntt_sharded as ns
    from zerokit_tpu_torch.parallel.sharded import _tree_reduce_points

    n = prover.mapper.domain_size
    root = ntt_host.coset_root_2n(n)
    for label, world, _ in MESH_RUNS:
        dp, tp = mesh_shape(world)
        if tp == 1:  # the one-device shapes: phase 3
            continue
        lanes = BATCH // dp
        rows, n2 = 3 * lanes, n // tp
        m = n2 // tp
        log(f"  ({label}) (dp, tp) = ({dp}, {tp}): the Bailey NTT on (16, {rows}, {n}), "
            f"n1 = {tp}, n2 = {n2}; the MSM shards of {lanes} lanes")
        for inverse in (True, False):
            way = "inverse" if inverse else "forward"
            x = on_card(random_elems(rng, R, rows * n2).reshape(16, rows, tp, m))
            mat = ns._small_dft_matrix(tp, inverse)
            checks.run("K1", f"Bailey small DFT {way}, (16, {rows}, {tp}, {m})",
                       lambda: ns._local_small_dft(x, mat), lambda: small_dft_plain(x, mat),
                       {"lanes": rows * tp * tp * m, "field": "fr"})
            for t in range(tp):
                tw = ns._table(ns._twiddle_block(n, tp, inverse), x)[
                    :, None, :, t * m:(t + 1) * m].expand(x.shape).contiguous()
                checks.run("K1", f"Bailey twiddle {way}, tp rank {t}, (16, {rows}, {tp}, {m})",
                           lambda: FrField.mul(x, tw), lambda: FrPlain.mul(x, tw),
                           {"lanes": rows * tp * m, "field": "fr"})
            y = on_card(random_elems(rng, R, rows * n2).reshape(16, rows, n2))
            scale = pow(n, -1, R) if inverse else 1
            table = None if scale == 1 else ntt_host._constant_table_on(n2, scale, y.device)
            s = n2 // 2
            while s >= nk.tail_size(n2):
                stw = nk._stage_tw(n2, s, inverse, "cuda")
                checks.run("K4", f"ntt_stage dif {way} m={s}, (16, {rows}, {n2})",
                           lambda: nk.ntt_stage(y, stw, s, "dif"),
                           lambda: nk.ntt_stage_plain(y, stw, s, "dif"),
                           {"rows": rows, "n": n2, "m": s, "dif": True})
                s //= 2
            ttw = nk._tail_tw(n2, inverse, "cuda")
            fused = "with the 1/N" if table is not None else "without"
            checks.run("K5", f"ntt_tail dif {way} {fused} table, P={nk.TAIL}, (16, {rows}, {n2})",
                       lambda: nk.ntt_tail(y, ttw, table, "dif"),
                       lambda: nk.ntt_tail_plain(y, ttw, table, "dif"),
                       {"rows": rows, "n": n2, "p": nk.TAIL, "table": table is not None,
                        "dif": True})
            checks.run("K4+K5", f"natural_ntt {way} (scale {'1/N' if inverse else '1'}), "
                       f"(16, {rows}, {n2}), against natural_ntt_plain",
                       lambda: ntt_host.natural_ntt(y, inverse, scale),
                       lambda: ntt_host.natural_ntt_plain(y, inverse, scale),
                       {"rows": rows, "n": n2, "p": nk.TAIL}, reps=3)
        for t in range(tp):
            y = on_card(random_elems(rng, R, rows * n2).reshape(16, rows, n2))
            pw = ns.row_powers(n, root, SimpleNamespace(tp=tp, tp_index=t), y).expand(
                y.shape).contiguous()
            checks.run("K1", f"row powers, tp rank {t}, (16, {rows}, {n2})",
                       lambda: FrField.mul(y, pw), lambda: FrPlain.mul(y, pw),
                       {"lanes": rows * n2, "field": "fr"})
        shapes = main_path_shapes(prover, tp, lanes)
        log(f"  ({label}) the last tp rank's MSM shard: {shapes}")
        passes = phase_scans(rng, checks, shapes, sweep=False)
        phase_bucket_adds(checks, shapes, passes, sweep=False)
        del passes
        for name, adapter, width in (("ab1l", FqAdapter, 3 * lanes), ("b2", Fq2Adapter, lanes),
                                     ("h", FqAdapter, lanes)):
            comps = adapter.components
            for d in (2, 4):
                parts = []
                for _ in range(d // 2):
                    p_np, q_np = ec_inputs(rng, comps, max(width, 11))
                    parts += [p_np[..., :width], q_np[..., :width]]
                g = on_card(np.stack(parts))  # (D, 16, C, 3, width)
                cv = CurveOps(adapter)
                checks.run("K2", f"_tree_reduce_points g{comps} ({name}) D={d}, {width} lanes",
                           lambda: _tree_reduce_points(cv, g), lambda: tree_plain(comps, g),
                           {"op": "add", "comps": comps, "lanes": (d - 1) * width,
                            "skipped": 0})


def phase_mesh(rng, prover, smi: str) -> dict:
    """Phase 12: the single-device proofs of a seeded batch, then each mesh
    run's ranks (parallel/dryrun.prove_file) against them."""
    from zerokit_tpu_torch.ff.field import decode_canonical_fast
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs
    from zerokit_tpu_torch.parallel.launch import launch

    named, rs, ss = random_batch_inputs(rng, BATCH, DEPTH)
    proofs = prover.prove_batch(named, rs, ss)
    verify_batch(prover, proofs)
    zc = prover.last_batch["z_canon"].cpu()
    public = [decode_canonical_fast(zc[:, 1:prover.num_inputs, b]) for b in range(BATCH)]
    os.makedirs(SCRATCH_DIR, exist_ok=True)
    path = os.path.join(SCRATCH_DIR, "mesh_batch.pkl")
    with open(path, "wb") as f:
        pickle.dump({"named": named, "rs": rs, "ss": ss, "proofs": proofs,
                     "public_inputs": public}, f)
    runs = {}
    for label, world, backend in MESH_RUNS:
        t0 = time.perf_counter()
        reports = launch(world, "zerokit_tpu_torch.parallel.dryrun:prove_file", (path, "cuda"),
                         backend=backend, timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        shape = (max(r["dp_index"] for r in reports) + 1, max(r["tp_index"] for r in reports) + 1)
        log(f"  ({label}) {world} {backend} rank(s), mesh (dp, tp) = {shape}, on "
            f"{reports[0]['device']}: {wall:.1f} s wall, process start included; every rank's "
            f"{BATCH} proofs (both batches) equal the single-device proofs and verify; {smi}")
        for rep in reports:
            coll = {k: (v["calls"], v["bytes_in"], v["bytes_out"], round(v["seconds"], 6))
                    for k, v in rep["collectives"].items()}
            stages = {k: round(v, 6) for k, v in rep["stages"].items()}
            log(f"    rank {rep['rank']} ({rep['dp_index']}, {rep['tp_index']}): ready "
                f"{rep['ready_s']:.3f} s, first batch {rep['cold_wall_s']:.4f} s, second "
                f"{rep['wall_s']:.4f} s; lift sharded {rep['sharded_lift']}, a/b1/l fused "
                f"{rep['fused']}; stages {stages}")
            log(f"      collectives (calls, bytes in, bytes out, s): {coll}")
            log(f"      launches: {rep['counts']}")
            for key in DEPTH20_PATH:
                if rep["counts"][KERNELS[key][3]] <= 0:
                    raise AssertionError(f"({label}) rank {rep['rank']}: {key} "
                                         f"{KERNELS[key][0]} was not launched")
        runs[label] = {"wall_s": wall, "reports": reports}
    return runs


# ---------------------------------------------------------------------------
# Phase 13: the component suites, ntt_micro, the JS fixture export
# ---------------------------------------------------------------------------

COMPONENTS_MAX_LOG2 = 20  # BC_MAX_LOG2 of (a): 2^22 runs through the tool alone
COMPONENTS_CONFIGS = ["pairs_1024", "pairs_65536", "pairs_1048576", "bulk_insert_2e20",
                      "g1_2e16_b4", "g1_2e18_b4", "g1_2e20_b4", "fft_2e20", "ifft_2e20"]


def phase_components(smi: str) -> dict:
    """Phase 13, the counters at 0 before (a) and read after (c): (a)
    tools/bench_components at BC_MAX_LOG2 = 20, every suite's config
    checked exactly against its native host oracle; (b) tools/ntt_micro at
    n = 8192, B = 64, every variant's kernel call (K1, the K4 stages at
    m = 1, 8, 64, 512 and n/2, the K5 tail) bit for bit against its plain
    version on the same tensors, timed L2-cold beside its bound, then K4
    at m = 2^16 and 2^19 of n = 2^20 likewise; (c)
    tools/export_js_fixture: the depth-10 fixture proved on the card
    (W1 evaluates its witness), byte for byte equal to the tracked file."""
    from zerokit_tpu_torch.ff import ntt_kernels as nk
    from zerokit_tpu_torch.runtime.profiling import launch_counts, reset_launches
    from zerokit_tpu_torch.tools import bench_components, export_js_fixture, ntt_micro

    t0 = time.perf_counter()
    reset_launches()
    log(f"  (a) bench_components, every suite at BC_MAX_LOG2 = {COMPONENTS_MAX_LOG2}")
    bench, failed = bench_components.run(list(bench_components.SUITES), "cuda",
                                         limit=COMPONENTS_MAX_LOG2)
    configs = [line["config"] for line in bench.lines]
    if failed or configs != COMPONENTS_CONFIGS:
        raise AssertionError(f"bench_components: suites {failed} failed; configs {configs}")
    for line in bench.lines:
        log(f"    {line['suite']} {line['config']}: {line['value']:.1f} {line['unit']}, "
            f"device {line['device_ms']:.4f} ms, bound {line['bound_ms']:.4f} ms "
            f"({line['bound_ms'] / line['device_ms']:.1%}), cold {line['cold_sec']:.1f} s, "
            f"checked {line['checked']}; {smi}")
    t_a = time.perf_counter()
    log("  (b) ntt_micro, n = 8192, B = 64: each kernel call against its plain version")
    micro = ntt_micro.run(log=lambda msg: log(f"    {msg}"))
    names = [row["name"] for row in micro]
    missing = [f"stage m={m}" for m in ntt_micro.STAGE_MS if f"stage m={m}" not in names]
    bad = [row["name"] for row in micro if row["max_abs_err"] != 0]
    if missing or bad:
        raise AssertionError(f"ntt_micro: variants {missing} missing, {bad} disagree with "
                             f"their plain versions")
    # K4 at stages of the 2^20 fft beyond ntt_micro's n/2 = 4096, on an
    # input that repeats nowhere
    n_big = 1 << COMPONENTS_MAX_LOG2
    x = ntt_micro.make_input(n_big, 1, "cuda", seed=1)
    for m in (1 << 16, n_big // 2):
        tw = nk._stage_tw(n_big, m, False, str(x.device))
        err = max_abs_err(nk.ntt_stage(x, tw, m, "dif"), nk.ntt_stage_plain(x, tw, m, "dif"))
        log(f"    K4 ntt_stage dif m={m}, (16, 1, {n_big}): max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"K4 at m={m}, n={n_big} disagrees with its plain version")
    del x
    t_b = time.perf_counter()
    log("  (c) export_js_fixture --compare, the depth-10 proof on the card")
    if export_js_fixture.main(["--device", "cuda", "--compare"]) != 0:
        raise AssertionError("the exported fixture differs from the tracked file")
    counts = launch_counts()
    t_c = time.perf_counter()
    log(f"  phase 13: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) {t_c - t_b:.1f} s; "
        f"launches {counts}")
    return {"counts": counts, "lines": bench.lines, "micro": micro}


def kernel_template(key: str, shape: dict):
    """The kernel's name as the profiler shows it (csrc template and its
    arguments), for the check's variant; None for the composite K4+K5."""
    elem = "zk::Elem<zk::FqTag>, 1" if shape.get("comps") == 1 else "zk::Fq2E, 2"
    if key == "K1":
        return f"mont_mul_kernel<zk::{'FrTag' if shape['field'] == 'fr' else 'FqTag'}>("
    if key == "K2 gather":
        return f"ec_add_gather_kernel<{elem}>("
    if key == "K2":
        op = ("add", "add_mixed", "double").index(shape["op"])
        return f"ec_op_kernel<{elem.rsplit(',', 1)[0]}, {op}>("
    if key == "K3 fine":
        return f"ec_scan_gather_kernel<{elem}>("
    if key == "K3 coarse":
        return f"ec_scan_excl_kernel<{elem}>("
    if key == "K4":
        return f"ntt_stage_kernel<{int(shape['dif'])}>("
    if key == "K5":
        return f"ntt_tail_kernel<{int(shape['dif'])}, {int(shape['table'])}>("
    if key == "K6":
        return "mont_tc_kernel("
    if key == "W1":
        return f"witness_steps_kernel<{str(shape['rich']).lower()}>("
    if key == "W2":
        return "witness_div_kernel("
    return None  # P1 is not on the proving path


def bounds(checks: KernelChecks, chip, warm: dict, profile: dict, latency: dict) -> dict:
    """Prints each check's work, bound and share of the bound, then ranks
    the kernel variants by launches x (time - bound) in the profiled warm
    batch: the variant's device time there times (1 - its share of the
    bound at the checked width), since the warm batch runs some variants at
    other widths. W1's checks also print the chain model
    (profiling.w1_chain_model, from phase 8's latencies) and the share of
    it the kernel reaches. Returns the bound of the check each key's JSON
    entry times, and W1's chain model."""
    from zerokit_tpu_torch.runtime.profiling import (kernel_bound, kernel_work, tensor_ops,
                                                     w1_chain_model)

    first, ranking, seen = {}, [], set()
    warm_kernels = profile["top_all"]
    for key, what, ms, shape in checks.rows:
        kind = key.split()[0]  # "K3 fine" and "K3 coarse" are kernel_work's K3
        imads, nbytes = kernel_work(kind, **shape)
        sec, res = kernel_bound(kind, chip, **shape)
        first.setdefault(key, (sec * 1e3, res))
        tops = tensor_ops(kind, **shape)
        log(f"  {key} {what}: {imads} IMAD, {nbytes} B"
            + (f", {tops} tensor ops" if tops else "")
            + f"; bound {sec * 1e3:.4f} ms ({res}); kernel {ms:.4f} ms, "
            f"share {sec * 1e3 / ms:.1%}; launches per warm batch {warm.get(key, 0)}"
            + (f"; {ms / shape['steps'] * 1e3:.3f} us, "
               f"{ms * 1e-3 * chip.sm_clock_hz / shape['steps']:.0f} cycles a step"
               if key == "W1" else "")
            + (f"; {ms * 1e-3 * chip.sm_clock_hz:.0f} cycles an inversion (one thread's "
               f"chain)" if key == "W2" else ""))
        if key == "W1":
            model_ms = w1_chain_model(chip, latency, **shape) * 1e3
            first.setdefault("W1 chain", (model_ms, "chain"))
            log(f"    W1 chain model: {shape['steps']} steps x "
                f"{latency['roundtrip_shared_4warps']:.1f} + ({shape['var_steps']} var x var + "
                f"{shape['const_steps']} by a constant) x {latency['mul']:.1f} cycles = "
                f"{model_ms:.4f} ms; kernel {ms:.4f} ms, share {model_ms / ms:.1%}; "
                f"{chip.label()}")
        tmpl = kernel_template(key, shape)
        if tmpl is not None and tmpl not in seen:
            seen.add(tmpl)
            n = sum(c for name, _, c in warm_kernels if tmpl in name)
            us = sum(t for name, t, _ in warm_kernels if tmpl in name)
            share = sec * 1e3 / ms
            ranking.append((us / 1e3 * (1 - share), n, us / 1e3, share, key, what, tmpl))
    log("  ranking by launches x (time - bound) in the profiled warm batch:")
    for loss, n, warm_ms, share, key, what, tmpl in sorted(ranking, reverse=True):
        log(f"    {loss:8.3f} ms = {warm_ms:.3f} ms in {n} launches x (1 - {share:.3f})  "
            f"[{tmpl[:-1]}; share at {key} {what}]")
    return first


KERNELS = {  # key -> (name, source, TPU kernel it replaces, launch counter)
    "K1": ("mont_mul", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:571", "mont_mul"),
    "K2": ("ec_op", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:571", "ec_op"),
    "K2 gather": ("ec_add_gather", "field_kernels.cu", "zerokit_tpu/ff/pallas_field.py:571",
                  "ec_add_gather"),
    "K3 fine": ("ec_scan_gather", "ec_scan.cu", "zerokit_tpu/ff/pallas_field.py:789",
                "ec_scan_gather"),
    "K3 coarse": ("ec_scan_excl", "ec_scan.cu", "zerokit_tpu/ff/pallas_field.py:789",
                  "ec_scan_excl"),
    "K4": ("ntt_stage", "ntt_kernels.cu", "zerokit_tpu/ff/pallas_ntt.py:201", "ntt_stage"),
    "K5": ("ntt_tail", "ntt_kernels.cu", "zerokit_tpu/ff/pallas_ntt.py:245", "ntt_tail"),
    "K6": ("mont_mul_tc", "mont_tc.cu", "tools/mxu_mont_prototype.py:131", "mont_mul_tc"),
    # new kernels: the JAX package's evaluator is a lax.scan, not Pallas
    "W1": ("witness_steps", "witness_kernels.cu", "zerokit_tpu/circuit/witness_eval.py:396",
           "witness_steps"),
    "W2": ("witness_div", "witness_kernels.cu", "zerokit_tpu/circuit/witness_eval.py:419",
           "witness_div"),
    # the JAX package's batched Poseidon is a lax.scan, not Pallas
    "P1": ("poseidon_perm", "poseidon.cu", "zerokit_tpu/hash/poseidon.py:132", "poseidon"),
}
# the kernels each proving run launches: the depth-20 graph has no Div
DEPTH20_PATH = ("K1", "K2", "K2 gather", "K3 fine", "K3 coarse", "K4", "K5", "W1")
MULTI_PATH = DEPTH20_PATH + ("W2",)
# phase 10's main path: the member tree (K1, P1) and the facade's batches
TREE_PATH = DEPTH20_PATH + ("P1",)
# phase 11's serving surface proves through prove_batch; its host trees
# rehash natively, so P1 is counted but not required there
SERVING_PATH = DEPTH20_PATH
# phase 13: the suites (K1-K5, P1), ntt_micro (K1, K4, K5) and the
# fixture's depth-10 proof (W1 among the proving path's kernels)
COMPONENTS_PATH = DEPTH20_PATH + ("P1",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()

    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from zerokit_tpu_torch.ff import _cuda
    from zerokit_tpu_torch.groth16.prover import Groth16Prover
    from zerokit_tpu_torch.resources import load_circuit
    from zerokit_tpu_torch.runtime import native
    from zerokit_tpu_torch.runtime.profiling import (ChipSpec, PipelineMetrics, launch_counts,
                                                     reset_launches)

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
    for kname, regs, stack, spill_st, spill_ld in _cuda.ptxas_report(info.get("log", "")):
        log(f"  ptxas: {kname[:100]}: {regs} registers, {stack} B stack, "
            f"{spill_st} B spill stores, {spill_ld} B spill loads")
    for curve, elem in (("G1", "FqTag"), ("G2", "Fq2E")):
        log(f"  SASS of ec_op_kernel {curve} add (cuobjdump -sass): "
            f"{sass_summary(_cuda.sass_opcodes('ec_op_kernel', elem, 'Li0E'))}")
    t0 = time.perf_counter()
    zkey, graph = load_circuit(DEPTH)
    prover = Groth16Prover(zkey, graph, device="cuda")
    log(f"  depth-{DEPTH} circuit and prover ready in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions -------------------------------
    log("[3] kernels against their plain versions, on the card")
    checks = phase_kernels(rng, prover)
    chip = ChipSpec.from_device(torch.cuda.current_device())
    log("[3b] the witness evaluator's kernels W1, W2 against their plain versions, on the card")
    phase_witness(rng, checks, graph, chip)
    multi_prover = Groth16Prover(*load_multi(), device="cuda")
    if prover.evaluator is None or multi_prover.evaluator is None:
        raise AssertionError("a depth-20 graph is not on the device witness evaluator")

    # 4. the slice --------------------------------------------------------
    log(f"[4] depth-{DEPTH} batch of {BATCH} through Groth16Prover.prove_batch, then one of the "
        f"multi-message-id circuit ({MULTI_GRAPH})")
    native.ensure_loaded(log)
    reset_launches()
    m1 = PipelineMetrics()
    wall1 = prove_and_check(prover, rng, m1)
    counts = launch_counts()
    log(f"  first batch (window tables built inside): {wall1:.3f} s; stages {m1.dumps()}")
    check_lane0(prover)
    reset_launches()
    mm = PipelineMetrics()
    wall_m = prove_and_check(multi_prover, rng, mm, multi=True)
    multi_counts = launch_counts()
    log(f"  multi-message-id first batch: {wall_m:.3f} s; stages {mm.dumps()}")

    # 5. warm batch -------------------------------------------------------
    log("[5] second (warm) batch")
    reset_launches()
    m2 = PipelineMetrics()
    wall2 = prove_and_check(prover, rng, m2)
    warm_counts = launch_counts()
    log(f"  warm batch: {wall2:.3f} s, {BATCH / wall2:.3f} proofs/s on {smi}; "
        f"stages {m2.dumps()}")

    # 6. launch counts ----------------------------------------------------
    log(f"[6] launches in phase 4's depth-20 batch: {counts}")
    log(f"    launches in phase 4's multi-message-id batch: {multi_counts}")
    log(f"    launches in the warm batch of phase 5: {warm_counts}")
    for which, path, batch_counts in (("depth-20", DEPTH20_PATH, counts),
                                      ("multi-message-id", MULTI_PATH, multi_counts),
                                      ("warm depth-20", DEPTH20_PATH, warm_counts)):
        for key in path:
            if batch_counts[KERNELS[key][3]] <= 0:
                raise AssertionError(f"{key} {KERNELS[key][0]} was not launched by the "
                                     f"{which} batch")

    # 6b. partial / finish ------------------------------------------------
    log("[6b] partial + finish proving, depth 20")
    phase_partial(prover, rng)

    # 7. the tools path's kernels against their plain versions --------------
    log("[7] the K6 tool: K6 against its plain version and K1 fq, on the card")
    phase_tool_kernels(checks)

    # 8. the tools path ---------------------------------------------------
    log("[8] the tools path: microbenchmark, profile of a warm batch")
    tools = phase_tools_path(rng, prover, smi)

    # 9. bounds -----------------------------------------------------------
    chip = tools["chip"]
    log(f"[9] work, bound and share of the bound ({chip.label()}; IMAD peak "
        f"{chip.imad_per_sec / 1e12:.3f} Top/s, HBM {chip.hbm_bytes_per_sec / 1e12:.2f} TB/s, "
        f"int8 tensor {chip.int8_tensor_ops_per_sec / 1e15:.3f} Pop/s)")
    prof_rep = tools["profile"]
    log(f"  device busy share of a warm batch: {prof_rep['busy_share']} traced; untraced "
        f"{prof_rep['device_us'] / 1e6 / wall2:.4f} (the traced batch's "
        f"{prof_rep['device_us'] / 1e3:.3f} ms of device events over phase 5's "
        f"{wall2:.3f} s); {smi}")
    ranges = prof_rep["ranges_us"]
    scans = ranges.get("msm.fine", 0.0) + ranges.get("msm.coarse", 0.0)
    log(f"  device time of the scans' ranges (msm.fine + msm.coarse) in the traced "
        f"warm batch: {scans / 1e3:.3f} ms of {prof_rep['device_us'] / 1e3:.3f} ms; {smi}")
    log(f"  device time of the witness range (witness.eval) in the traced warm batch: "
        f"{ranges.get('witness.eval', 0.0) / 1e3:.3f} ms; its witness_eval stage "
        f"{prof_rep['stages']['witness_eval']:.4f} s (profiler on); {smi}")
    ours = ("ec_scan_gather_kernel", "ec_add_gather_kernel")
    gathers = [(kname[:70], round(us / 1e3, 3), c) for kname, us, c in prof_rep["top_all"]
               if "gather" in kname and not any(o in kname for o in ours)]
    log(f"  torch gather kernels in the traced warm batch (name, ms, launches): "
        f"{gathers or 'none'}")
    warm_by_key = {key: warm_counts[KERNELS[key][3]] for key in KERNELS}
    bound = bounds(checks, chip, warm_by_key, tools["profile"], tools["latency"])

    # 10. the tree and the RLN API ------------------------------------------
    log(f"[10] batched Poseidon (P1), the depth-{TREE_DEPTH} device tree of 2^{TREE_DEPTH} "
        f"members, the RLN API over the torch prover")
    tree = phase_tree(rng, checks, chip, smi)
    for key in TREE_PATH:
        if tree["counts"][KERNELS[key][3]] <= 0:
            raise AssertionError(f"{key} {KERNELS[key][0]} was not launched by phase 10's "
                                 f"main path")
    bound["P1"] = (tree["bound_ms"], tree["bound_by"])

    # 11. the serving surface -----------------------------------------------
    log(f"[11] the serving surface at depth {TREE_DEPTH}: the HTTP prover service, "
        f"checkpointed batches, the PmTree, the C ABI, the CLIs")
    serving = phase_serving(rng, smi)
    for key in SERVING_PATH:
        if serving["counts"][KERNELS[key][3]] <= 0:
            raise AssertionError(f"{key} {KERNELS[key][0]} was not launched by phase 11's "
                                 f"serving path")

    # 12. the mesh prover ----------------------------------------------------
    log(f"[12] the mesh prover at depth {DEPTH}, batch {BATCH}: (a) NCCL (1, 1), (b) gloo "
        f"(1, 2), (c) gloo (2, 2), every rank on cuda:0")
    phase_mesh_kernels(rng, checks, prover)
    phase_mesh(rng, prover, smi)

    # 13. the component suites, ntt_micro, the JS fixture ---------------------
    log("[13] the component suites at BASELINE sizes (BC_MAX_LOG2 = 20), ntt_micro, the JS "
        "fixture export")
    components = phase_components(smi)
    for key in COMPONENTS_PATH:
        if components["counts"][KERNELS[key][3]] <= 0:
            raise AssertionError(f"{key} {KERNELS[key][0]} was not launched by phase 13")

    kernels = []
    for key, (kname, src, replaces, counter) in KERNELS.items():
        ms, plain_ms, what, shape = checks.times[key]
        bound_ms, res = bound[key]
        # launches: the depth-20 batch's count, W2's from the multi-message-id
        # batch (the depth-20 graph has no Div), P1's from phase 10's tree
        # and facade, K6's from the tools path
        main_counts = (counts if key in DEPTH20_PATH else
                       multi_counts if key in MULTI_PATH else
                       tree["counts"] if key in TREE_PATH else tools["counts"])
        kernels.append({
            "name": f"{kname} ({key}: {what})", "route": "cuda",
            "source": f"zerokit_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": main_counts[counter], "launches_multi": multi_counts[counter],
            "launches_warm": warm_by_key[key], "launches_serving": serving["counts"][counter],
            "launches_components": components["counts"][counter],
            "max_abs_err": max(checks.errors[key]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if res == "hbm" else "operations",
            "library_ms": None,
        })
        if key == "P1":
            kernels[-1]["rebuild_ms"] = min(tree["rebuild_ms"])
            kernels[-1]["rebuild_bound_ms"] = tree["rebuild_bound_ms"]
            kernels[-1]["levels_ms"] = tree["levels_ms"]
        if key == "W2":  # the inversion chain sets W2's time; ms is the kernel alone
            kernels[-1]["wrapper_ms"] = checks.wrapper_ms[key]
            kernels[-1]["cycles_per_inversion"] = ms * 1e-3 * chip.sm_clock_hz
        if key == "W1":  # the step chain, not the bound, sets W1's time
            kernels[-1]["ms_per_step"] = ms / shape["steps"]
            kernels[-1]["cycles_per_step"] = ms * 1e-3 * chip.sm_clock_hz / shape["steps"]
            kernels[-1]["chain_model_ms"] = bound["W1 chain"][0]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
