"""Profiling and the speed-of-light arithmetic of the proving pipeline.

Counterpart of zerokit_tpu/runtime/profiling.py for one NVIDIA GPU:

  * stage_timer / PipelineMetrics: wall-clock per pipeline stage. A stage
    that ran on the card ends with torch.cuda.synchronize(), so its time
    includes the device work it queued, not only the enqueue. Each stage is
    also the span "stage.<name>", its closing synchronize inside.
    PipelineMetrics.counts holds the program's counters beside the stages
    (public_from_assignment: lanes whose public values the prover read
    from their assignment).
  * device_ms(): the one kernel timer, device time per call of calls run
    back to back; launch_counts() / reset_launches(): every kernel
    wrapper's launch counter.
  * span(): the program's one named range, a torch.profiler range on the
    trace's clock (a call's host phases: rln.*, facade.*, prover.*, host.*;
    the stages, stage.*; inside them witness.*, qap.*, msm.*, parallel.*);
    a no-op when no profiler is running, and never a synchronisation.
  * trace() / device_busy_share() / kernel_times(): a torch.profiler capture
    with its chrome trace under build/zerokit_tpu_torch/traces/, the share of
    the traced window in which a device kernel ran, and device time by
    kernel name.
  * ChipSpec: the card's peak rates.
  * kernel_work() / kernel_bound(): the multiplies and bytes of one call of
    each kernel K1-K6, W1-W2, P1 and the least time the card could take for
    it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

# 32-bit multiply instructions of one CIOS product in csrc/bn254.cuh `mul`,
# lo and hi halves each counted: per outer step i (8 of them) the 8 a*b
# products (16), m = t0 * n0' (1) and the 8 m*p products (16).
MONT_MUL_IMADS = 8 * (2 * 8 + 1 + 2 * 8)
# A row of k products summed before one reduction (bn254.cuh `mul_sum`):
# the k products' a*b halves, then the reduction's m and m*p halves, once.
ROW_PRODUCT_IMADS = 8 * 2 * 8
ROW_REDC_IMADS = 8 * (1 + 2 * 8)
# A Montgomery squaring: the 8 * 9 / 2 distinct word products' halves (the
# doubled cross products cost adds), then one reduction.
SQR_IMADS = 8 * 9 + ROW_REDC_IMADS
# complete projective add (RCB15 Alg 7): 12M + cheap b3 muls
EC_ADD_MONT_MULS = 12
# Montgomery products per operation of the kernels (csrc/bn254.cuh): G1's
# b3 multiply is additions; an Fq2 product is 3 Fq products, an Fq2 square
# 2, and G2's b3 multiply one Fq2 product.
EC_OP_MONT_MULS = {
    (1, "add"): EC_ADD_MONT_MULS, (1, "add_mixed"): 11, (1, "double"): 8,
    (2, "add"): 12 * 3 + 2 * 3, (2, "add_mixed"): 11 * 3 + 2 * 3,
    (2, "double"): 2 + 3 + (2 + 3) + 5 * 3,
}
# Montgomery products of one witness node by op code (circuit/witness_eval
# F_*, csrc/witness_kernels.cu): Mul 1; the rich bit ops from_mont twice
# and to_mont once, the signed comparisons from_mont twice; the rest none.
WITNESS_OP_MONT_MULS = {1: 1, 10: 3, 11: 3, 12: 3, 13: 3, 14: 2, 15: 2, 16: 2, 17: 2}
# One Div (W2, csrc/witness_kernels.cu): the safegcd inverse, then a * b^-1
# as one CIOS product (MONT_MUL_IMADS). The inverse's 32-bit integer
# operations, as its C body writes them: an add, sub, and, xor, shift or
# 32-bit multiply-add one each; a 32x32->64 multiply(-add) two (its lo and
# hi words, as MONT_MUL_IMADS counts a product's halves) and a 64-bit shift
# two; the repacking between 8 words and 9 limbs of 30 bits none (layout,
# like a load). A divstep is 27; a batch of 30 is followed by update_de (174:
# 2 + 6 + 8 + 6 + 4 + 4 + 8 x 18) and update_fg (124: 4 + 4 + 2 + 2 + 8 x
# 14); 20 batches, then normalize (105). tests/test_torch_witness_div.py
# tallies them on its walk of the kernel's code.
SAFEGCD_BATCHES, SAFEGCD_BATCH_STEPS = 20, 30
SAFEGCD_DIVSTEP_OPS = 27
SAFEGCD_UPDATE_DE_OPS = 174
SAFEGCD_UPDATE_FG_OPS = 124
SAFEGCD_NORMALIZE_OPS = 105
SAFEGCD_OPS = (SAFEGCD_BATCHES * (SAFEGCD_BATCH_STEPS * SAFEGCD_DIVSTEP_OPS
                                  + SAFEGCD_UPDATE_DE_OPS + SAFEGCD_UPDATE_FG_OPS)
               + SAFEGCD_NORMALIZE_OPS)
WITNESS_DIV_OPS = SAFEGCD_OPS + MONT_MUL_IMADS
SLOT_BYTES = 32  # one value in the witness slot buffer: 8 words
WORD = 4  # bytes of one stored limb (int32 word holding 16 bits)
LIMBS = 16

REPO_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
TRACE_DIR = os.path.join(REPO_DIR, "build", "zerokit_tpu_torch", "traces")
WINDOW = "zk.trace_window"  # the host range trace() puts around the traced block


@dataclass
class PipelineMetrics:
    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    batch: int = 0

    def record(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def report(self) -> dict:
        return {"batch": self.batch, "stages": dict(sorted(self.stages.items())),
                "counts": dict(sorted(self.counts.items()))}

    def dumps(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def stage_timer(metrics: Optional[PipelineMetrics], name: str, device=None):
    """Times a stage, inside the span "stage." + name. With a CUDA
    `device`, the stage ends with a torch.cuda.synchronize() on it, inside
    the span, before the clock stops."""
    t0 = time.perf_counter()
    with span("stage." + name):
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            if metrics is not None:
                metrics.record(name, time.perf_counter() - t0)


SPIN_CYCLES_PER_SEC = 2.0e9  # at or above the SM clock, so a spin lasts at least as asked


def host_call(fn):
    """(fn()'s result, the host seconds of the call) on an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def device_ms(fn, reps: int = 10, enqueue_s: Optional[float] = None) -> float:
    """Time on the card of one fn() call in ms: CUDA events around reps
    calls run back to back, over reps. A spin kernel (torch.cuda._sleep)
    holds the stream while the host enqueues the calls, so the host's
    launch cost between them is not counted and a short kernel reads its
    own duration, not its wrapper's. The spin is sized from the host
    seconds of one call (enqueue_s, from host_call on a call the caller
    has just made; else one untimed warm-up call measures it) and lasts
    at most 1 s. A call of more launches than the card's launch queue
    holds (about a thousand, as in the plain versions) still counts the
    host's time."""
    if enqueue_s is None:
        enqueue_s = host_call(fn)[1]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.25 * reps * enqueue_s + 1e-4, 1.0) * SPIN_CYCLES_PER_SEC))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


L2_ROTATION_BYTES = 400 << 20  # 8x the H100's 50 MB L2


def l2_cold(call, *inputs):
    """A call of call(*inputs) on rotating copies of the inputs, as many as
    hold L2_ROTATION_BYTES together, with the last outputs kept alive so
    that they rotate too: each call reads and writes addresses that the
    calls just before it have pushed out of L2, so a byte-bound kernel
    reads its time against HBM, not against L2. The rotation is filled
    (one call a copy) before it is returned, so a timed call allocates
    nothing: the caching allocator reuses the output that it drops."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = max(2, -(-L2_ROTATION_BYTES // nbytes))
    copies = [[t.clone() for t in inputs] for _ in range(n)]
    held = collections.deque(maxlen=n)
    step = itertools.count()

    def cold():
        held.append(call(*copies[next(step) % n]))
        return held[-1]

    for _ in range(n):
        cold()
    return cold


def _counted_modules():
    """The modules whose kernel wrappers keep a launch counter: K1-K5 (ff),
    W1-W2 (circuit), P1 (hash), K6 and the microbenchmark's chain (tools)."""
    from ..circuit import witness_kernels
    from ..ff import field_kernels, ntt_kernels
    from ..hash import poseidon_kernels
    from ..tools import microbench, tc_mont_prototype

    return (field_kernels, ntt_kernels, witness_kernels, poseidon_kernels, tc_mont_prototype,
            microbench)


def launch_counts() -> Dict[str, int]:
    """A snapshot of every kernel wrapper's launch counter."""
    counts: Dict[str, int] = {}
    for mod in _counted_modules():
        counts.update(mod.launches)
    return counts


def reset_launches() -> None:
    """Sets every kernel wrapper's launch counter to 0."""
    for mod in _counted_modules():
        mod.reset_launches()


def span(name: str):
    """A named range for torch.profiler; a null context when no profiler is
    running. It never synchronises."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR, device="cuda"):
    """Profiles the block with torch.profiler (CPU and, on the card, CUDA
    activity) and writes a chrome trace into log_dir. Yields the profiler;
    read it after the block. Raises without CUDA unless device="cpu"."""
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device; pass device=\"cpu\" for a CPU trace")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    os.makedirs(log_dir, exist_ok=True)
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def busy_share(intervals: Iterable[Tuple[float, float]], window: Tuple[float, float]) -> float:
    """Length of the union of the intervals, clipped to the window, over
    the window's length."""
    lo, hi = window
    if hi <= lo:
        raise ValueError(f"empty window {window}")
    covered = 0.0
    end = lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            covered += e - s
            end = e
    return covered / (hi - lo)


def device_events(prof, device="cuda") -> list:
    """The profiled events that ran on `device`: kernels, copies and fills
    on the card (user-annotation ranges left out); ops for device="cpu"."""
    dtype = (torch.autograd.DeviceType.CUDA if torch.device(device).type == "cuda"
             else torch.autograd.DeviceType.CPU)
    return [ev for ev in prof.events()
            if ev.device_type == dtype and not getattr(ev, "is_user_annotation", False)
            and ev.time_range.end > ev.time_range.start]


def device_busy_share(prof, device="cuda") -> Optional[float]:
    """The share of the traced window in which at least one event of
    `device` ran; None if there was none. The window is trace()'s host range
    around the block (pure-Python work in it leaves no other event), else
    the first to the last event."""
    busy = [(ev.time_range.start, ev.time_range.end) for ev in device_events(prof, device)]
    if not busy:
        return None
    events = prof.events()
    marks = [ev for ev in events
             if ev.name == WINDOW and ev.device_type == torch.autograd.DeviceType.CPU]
    if marks:
        window = (marks[0].time_range.start, marks[0].time_range.end)
    else:
        window = (min(ev.time_range.start for ev in events),
                  max(ev.time_range.end for ev in events))
    return busy_share(busy, window)


def kernel_times(prof, device="cuda") -> List[Tuple[str, float, int]]:
    """(name, microseconds, count) of the device events by name, largest
    first; empty if the profiler saw no device event."""
    acc: Dict[str, List[float]] = {}
    for ev in device_events(prof, device):
        row = acc.setdefault(ev.name, [0.0, 0])
        row[0] += ev.time_range.end - ev.time_range.start
        row[1] += 1
    return sorted(((k, v[0], int(v[1])) for k, v in acc.items()), key=lambda r: -r[1])


RANGE_PREFIXES = ("witness.", "msm.", "qap.")  # the span() names of the proving stages


def range_times(prof, device="cuda") -> Dict[str, float]:
    """Microseconds in which a device event ran inside each span() range
    (witness.*, msm.*, qap.*), summed over its calls. The
    ranges are the profiler's annotations on the device's own timeline (on
    the card, the range as the GPU ran it); empty if it recorded none."""
    dtype = (torch.autograd.DeviceType.CUDA if torch.device(device).type == "cuda"
             else torch.autograd.DeviceType.CPU)
    busy = [(ev.time_range.start, ev.time_range.end) for ev in device_events(prof, device)]
    out: Dict[str, float] = {}
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if (ev.device_type == dtype and getattr(ev, "is_user_annotation", False)
                and ev.name.startswith(RANGE_PREFIXES) and e > s):
            out[ev.name] = out.get(ev.name, 0.0) + busy_share(busy, (s, e)) * (e - s)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# The card, and the speed of light
# ---------------------------------------------------------------------------


@dataclass
class ChipSpec:
    """Peak rates of one NVIDIA H100 SXM. The SM count and clock come from
    the card (from_device); the rates per clock and the memory and tensor
    rates from NVIDIA's documents: 64 32-bit integer multiply(-add)s per
    clock per SM (CUDA C++ Programming Guide, arithmetic instruction
    throughput, compute capability 9.0), 3.35e12 B/s of HBM3 and 1.979e15
    dense int8 tensor operations per second (H100 SXM data sheet)."""

    name: str = "NVIDIA H100 80GB HBM3"
    power_limit: str = "not read"
    sm_count: int = 132
    sm_clock_hz: float = 1.98e9
    imad_per_clk_per_sm: int = 64
    hbm_bytes_per_sec: float = 3.35e12
    int8_tensor_ops_per_sec: float = 1.979e15
    # a measured multiply rate above the derived one replaces it as the peak
    measured_imad_per_sec: Optional[float] = None

    @property
    def derived_imad_per_sec(self) -> float:
        return self.sm_count * self.sm_clock_hz * self.imad_per_clk_per_sm

    @property
    def imad_per_sec(self) -> float:
        return max(self.derived_imad_per_sec, self.measured_imad_per_sec or 0.0)

    def label(self) -> str:
        return f"{self.name}, {self.power_limit}"

    @classmethod
    def from_device(cls, index: int = 0) -> "ChipSpec":
        """Reads the card's name, power limit and maximum SM clock from
        nvidia-smi and its SM count from torch. Raises without CUDA."""
        if not torch.cuda.is_available():
            raise RuntimeError("ChipSpec.from_device: no CUDA device")
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, power, clock = (s.strip() for s in out.split(","))
        props = torch.cuda.get_device_properties(index)
        return cls(name=name, power_limit=power, sm_count=props.multi_processor_count,
                   sm_clock_hz=float(clock.split()[0]) * 1e6)


N_MSM_WINDOWS, MSM_C_BITS = 32, 8  # groth16/msm.py's N_WINDOWS and C_BITS


def msm_bucket_mont_muls(n_points: int) -> int:
    """Montgomery products of one lane of a G1 MSM over n affine points by
    the bucket method over the fixed-base window tables: a window's n
    mixed adds into its buckets, its bucket reduction (2 * 255 adds: the
    running sum and the total) and its c doublings, then the W - 1 adds
    that join the windows."""
    ops = EC_OP_MONT_MULS
    buckets = (1 << MSM_C_BITS) - 1
    per_window = (n_points * ops[(1, "add_mixed")] + 2 * buckets * ops[(1, "add")]
                  + MSM_C_BITS * ops[(1, "double")])
    return N_MSM_WINDOWS * per_window + (N_MSM_WINDOWS - 1) * ops[(1, "add")]


# ---------------------------------------------------------------------------
# Work and bound of one kernel call
# ---------------------------------------------------------------------------


def poseidon_mont_muls(t: int) -> int:
    """Montgomery products of one Poseidon hash of width t in its cheapest
    known form, the least work of the function and the form P1 runs
    (hash/poseidon_kernels.sparse_form; the plain version runs the dense
    form, t^2 products for every mix). x^5 is 3 products, on t lanes in each of
    the RF full rounds and on lane 0 in each of the RP partial rounds. A
    full round's mix is t^2 products; a partial round's is 2t - 1, the
    sparse factor of the MDS matrix (Grassi et al., "Poseidon", Appendix B:
    the dense factors fold into the last first-half full round's matrix).
    The first round's lane 0 is a constant (0 plus its round constant), so
    its x^5 and its column of the mix cost nothing; the output is state[0],
    so the last mix is its row 0, t products."""
    from ..hash.poseidon import params_for_t

    rf, rp, _, _ = params_for_t(t)
    return rf * (3 * t + t * t) + rp * (3 + 2 * t - 1) - (3 + t) - (t * t - t)


def poseidon_imads(t: int) -> int:
    """32-bit multiplies of one Poseidon hash of width t in its cheapest
    known form: poseidon_mont_muls(t)'s products, with each mix row of k
    products summed before one Montgomery reduction (bn254.cuh `mul_sum`,
    ROW_PRODUCT_IMADS k + ROW_REDC_IMADS; P1 runs it at t <= 4), and each
    x^5's two squarings at SQR_IMADS (P1 runs them as products). The rows:
    round 0's t rows of t - 1 products (lane 0 folded), t rows of t in each
    of the RF - 2 full rounds between, the last round's row 0, and each
    partial round's row 0. The x^5's: t a full round but round 0's lane 0,
    one a partial round. Every other product (x^5's last, a partial round's
    column-0 products) is reduced alone, MONT_MUL_IMADS."""
    from ..hash.poseidon import params_for_t

    rf, rp, _, _ = params_for_t(t)
    rows = [t - 1] * t + [t] * ((rf - 2) * t + 1 + rp)
    squares = 2 * (rf * t - 1 + rp)
    alone = poseidon_mont_muls(t) - sum(rows) - squares
    return (alone * MONT_MUL_IMADS + squares * SQR_IMADS
            + sum(ROW_PRODUCT_IMADS * k + ROW_REDC_IMADS for k in rows))


def _point_words(comps: int, coords: int) -> int:
    return LIMBS * comps * coords


def tail_skipped(p: int) -> int:
    """Butterflies of one P-point chunk that K5 runs without a product
    (csrc/ntt_kernels.cu first_stages): with E = 2^LR elements a thread
    (ff/ntt_kernels.TAIL_LR), its first register group holds stages
    m = 1 .. 2^(r0-1), r0 = log2(P) - LR * (ceil(log2(P) / LR) - 1), and the
    j = 0 butterflies of stage m, P / (2m) of them, multiply by 1."""
    from ..ff.ntt_kernels import TAIL_LR

    logp = p.bit_length() - 1
    r0 = logp - TAIL_LR * (-(-logp // TAIL_LR) - 1)
    return sum(p >> (q + 1) for q in range(r0))


def kernel_work(key: str, **shape) -> Tuple[int, int]:
    """(32-bit multiply instructions (W2: integer operations), bytes of
    device memory) of one call:
    each input byte read once and each output byte written once, as stored.
    Shapes, as chip_smoke.py's kernel checks give them:

      K1 lanes[, square]             mont_mul on (16, lanes); square: a * a
      K2 op, comps, lanes[, skipped] ec_op; skipped: add_mixed lanes whose q
                                     is the (0, 0) sentinel (no products)
      K2 op="add_gather", comps, lanes, skipped, rows_read  ec_add_gather:
                                     skipped = empty lanes (no products);
                                     the two int32 indices and the empty
                                     flag of every lane, the rows_read
                                     distinct fine and coarse rows its
                                     other lanes reach, once each, and the
                                     SoA points written
      K3 kind, comps, k, lanes[, skipped, table_rows]  a scan of k steps over
                                     lanes: "mixed" (ec_scan_gather; with
                                     table_rows, the distinct table rows its
                                     index reaches, it also reads the int32
                                     index and those rows once each) or
                                     "excl" (ec_scan_excl); skipped: sentinel
                                     lane-steps of "mixed". The multiplies are
                                     the sequential scan's k*lanes adds for
                                     both kinds (the chunked coarse scan's
                                     extra adds are its design's cost).
      K4 rows, n, m[, r]             ntt_cross on (16, rows, n): a run of r
                                     stages (1: ntt_stage), the top one of
                                     half-size m; a product a butterfly
                                     (none is skipped: K4's j = 0
                                     butterflies have no compile-time
                                     index); x read and written once, the
                                     top stage's (16, m) twiddles read once
      K5 rows, n, p[, table]         ntt_tail with chunk P = min(n, p): the
                                     butterflies of its log2(P) stages less
                                     those the kernel skips (tail_skipped:
                                     the multiplies by 1 of its first
                                     register group), plus the table's
      K4+K5 rows, n, p               coset_lift_bn on (16, rows, n): every
                                     stage each way and the table, less the
                                     two tails' skipped products
      K6 lanes                       mont_mul_tc: the 512-bit product on the
                                     CUDA cores (the reduction's products
                                     are tensor_ops)
      W1 ops, steps, lanes, reads    witness_steps over one segment: ops
                                     {op code: nodes}, each node's products
                                     (WITNESS_OP_MONT_MULS) in every lane;
                                     the schedule (16 B a node of each step),
                                     the `reads` slots the segment reads but
                                     did not write and each node's value
                                     (with `stores`, those W1 stores to the
                                     slot buffer), once per lane
      W2 divs, lanes                 witness_div: WITNESS_DIV_OPS a Div and
                                     lane, integer operations of every kind
                                     at the IMAD rate (the card runs 32-bit
                                     adds, logic ops and shifts at the same
                                     64 a clock an SM); three int32 indices
                                     a Div, two operands read and one value
                                     written a Div and lane
      P1 t, lanes                    poseidon_perm: poseidon_imads(t) a
                                     lane; t - 1 inputs read and one output
                                     written, 64 B each, a lane

    and two whole functions of tools/bench_components.py:

      MSM n, lanes                   a G1 MSM over n points per lane:
                                     msm_bucket_mont_muls(n) products a
                                     lane; the scalars and the affine
                                     window tables (32 windows of n
                                     points) read once, the projective
                                     results written
      NTT rows, n[, scale]           groth16/ntt.fft on (16, rows, n): the
                                     n/2 log2(n) butterflies less the n - 1
                                     whose twiddle is 1, one product each;
                                     with scale (ifft), n more products; x
                                     read, the result written, the n - 1
                                     stage twiddles (and the scale's table)
                                     read once
    """
    w = WORD
    if key == "K1":
        n = shape["lanes"]
        arrays = 2 if shape.get("square") else 3  # a squaring reads one input
        return n * MONT_MUL_IMADS, arrays * LIMBS * w * n
    if key == "K2":
        op, comps, n = shape["op"], shape["comps"], shape["lanes"]
        live = n - shape.get("skipped", 0)
        if op == "add_gather":
            words = _point_words(comps, 3) * (shape["rows_read"] + n)
            return (live * EC_OP_MONT_MULS[(comps, "add")] * MONT_MUL_IMADS,
                    words * w + n * (2 * w + 1))
        q_coords = {"add": 3, "add_mixed": 2, "double": 0}[op]
        words = _point_words(comps, 3) * 2 + _point_words(comps, q_coords)
        return live * EC_OP_MONT_MULS[(comps, op)] * MONT_MUL_IMADS, words * w * n
    if key == "K3":
        kind, comps, k, n = shape["kind"], shape["comps"], shape["k"], shape["lanes"]
        op = "add_mixed" if kind == "mixed" else "add"
        live = k * n - shape.get("skipped", 0)
        imads = live * EC_OP_MONT_MULS[(comps, op)] * MONT_MUL_IMADS
        if "table_rows" in shape:  # index, each reached table row, the prefixes
            words = (k * n * (1 + _point_words(comps, 3))
                     + shape["table_rows"] * _point_words(comps, 2))
            return imads, words * w
        words = _point_words(comps, 2 if kind == "mixed" else 3) + _point_words(comps, 3)
        return imads, words * w * k * n
    if key == "K4":
        rows, n, m = shape["rows"], shape["n"], shape["m"]
        r = shape.get("r", 1)
        return rows * n // 2 * r * MONT_MUL_IMADS, (2 * rows * n + m) * LIMBS * w
    if key == "K5":
        rows, n = shape["rows"], shape["n"]
        table = bool(shape.get("table", False))
        p = min(n, shape["p"])
        per_chunk = (p.bit_length() - 1) * p // 2 - tail_skipped(p) + (p if table else 0)
        words = (2 * rows * n + p + (n if table else 0)) * LIMBS
        return rows * (n // p) * per_chunk * MONT_MUL_IMADS, words * w
    if key == "K4+K5":  # coset_lift_bn: every DIF stage, the table, every DIT stage
        rows, n = shape["rows"], shape["n"]
        p = min(n, shape["p"])
        muls = rows * (n * (n.bit_length() - 1) + n - 2 * (n // p) * tail_skipped(p))
        # x in, h out; the table and each direction's twiddles (n words each)
        return muls * MONT_MUL_IMADS, (2 * rows * n + 3 * n) * LIMBS * w
    if key == "K6":
        n = shape["lanes"]
        # a*b: 64 32x32->64 products; the tables are read once
        return n * 2 * 64, 3 * LIMBS * w * n + 32 * (32 + 64)
    if key == "W1":
        ops, lanes = shape["ops"], shape["lanes"]
        muls = sum(WITNESS_OP_MONT_MULS.get(op, 0) * n for op, n in ops.items())
        nodes = sum(n for op, n in ops.items() if op != 0)
        sched = shape["steps"] * 4 * 4 * w
        written = shape.get("stores", nodes)
        return (muls * lanes * MONT_MUL_IMADS,
                sched + (shape["reads"] + written) * lanes * SLOT_BYTES)
    if key == "W2":
        divs, lanes = shape["divs"], shape["lanes"]
        return (divs * lanes * WITNESS_DIV_OPS,
                3 * w * divs + 3 * SLOT_BYTES * divs * lanes)
    if key == "P1":
        t, lanes = shape["t"], shape["lanes"]
        return lanes * poseidon_imads(t), lanes * t * LIMBS * w
    if key == "MSM":
        n, lanes = shape["n"], shape["lanes"]
        words = LIMBS * (n * lanes + N_MSM_WINDOWS * n * 2 + 3 * lanes)
        return lanes * msm_bucket_mont_muls(n) * MONT_MUL_IMADS, words * w
    if key == "NTT":
        rows, n = shape["rows"], shape["n"]
        scale = bool(shape.get("scale", False))
        muls = rows * ((n.bit_length() - 1) * n // 2 - (n - 1) + (n if scale else 0))
        words = (2 * rows * n + n - 1 + (n if scale else 0)) * LIMBS
        return muls * MONT_MUL_IMADS, words * w
    raise ValueError(f"unknown kernel {key!r}")


def segment_work(seg, lanes: int, records: Optional[np.ndarray] = None,
                 n_consts: int = 0) -> dict:
    """kernel_work's W1 shape of one segment's steps at
    `lanes` lanes: nodes by op code, steps, and the distinct slots its nodes
    read (a; b unless Neg; c of TernCond) that the segment did not write.
    seg: a circuit/witness_eval.Segment. With the segment's slot-file
    records (circuit/witness_plan) and the constant table's size, also
    w1_chain_model's step counts: var_steps (a variable x variable Mul, or
    a rich op, whose products are variable x variable too), const_steps
    (products by a constant only: a Mul with an operand in the table), and
    the values W1 stores to the slot buffer."""
    from ..circuit.witness_eval import F_MUL, F_NEG, F_NOP, F_TERN, N_LEAN

    live = seg.ops != F_NOP
    binary = live & (seg.ops != F_NEG)
    read = np.concatenate([seg.ia[live], seg.ib[binary], seg.ic[seg.ops == F_TERN]])
    outside = (read < seg.write_start) | (read >= seg.write_start + seg.ops.size)
    codes, counts = np.unique(seg.ops[live], return_counts=True)
    shape = {"ops": dict(zip(codes.tolist(), counts.tolist())), "steps": len(seg.ops),
             "lanes": lanes, "reads": len(np.unique(read[outside]))}
    if records is not None:
        r = records.astype(np.int64) & 0xFFFFFFFF
        op = r[..., 0] & 0xFFFF
        by_const = (op == F_MUL) & (((r[..., 1] & 0xFFFF) < n_consts) | ((r[..., 1] >> 16) < n_consts))
        var = (((op == F_MUL) & ~by_const) | (op >= N_LEAN)).any(axis=1)
        const = by_const.any(axis=1) & ~var
        shape |= {"var_steps": int(var.sum()), "const_steps": int(const.sum()),
                  "stores": int((records[..., 3] >= 0).sum())}
    return shape


def w1_chain_model(chip: ChipSpec, latency: Dict[str, float], **shape) -> float:
    """Seconds of W1's step chain over one segment (segment_work's shape
    with records): every step one shared-memory round trip across W1's
    four warps and their block barrier, plus one latency of bn254.cuh's
    `mul` (W1's product, by a constant too) for each step with a product,
    variable x variable or by a constant, from the cycle latencies that
    tools/microbench.measure_latencies reads on the card."""
    cycles = (shape["steps"] * latency["roundtrip_shared_4warps"]
              + (shape["var_steps"] + shape["const_steps"]) * latency["mul"])
    return cycles / chip.sm_clock_hz


def tensor_ops(key: str, **shape) -> int:
    """Tensor-core operations (a multiply and an add each count) of one
    call: K6's two byte-Toeplitz products, 32 bytes against 32 and 64
    columns per lane; none for K1-K5."""
    if key == "K6":
        return 2 * 32 * (32 + 64) * shape["lanes"]
    return 0


def kernel_bound(key: str, chip: ChipSpec, **shape) -> Tuple[float, str]:
    """(seconds, resource): the least time the card could take for one call,
    the largest of multiplies over the IMAD peak ("imad"), bytes over the
    HBM rate ("hbm") and tensor operations over the int8 tensor peak
    ("tensor")."""
    imads, nbytes = kernel_work(key, **shape)
    times = {
        "imad": imads / chip.imad_per_sec,
        "hbm": nbytes / chip.hbm_bytes_per_sec,
        "tensor": tensor_ops(key, **shape) / chip.int8_tensor_ops_per_sec,
    }
    resource = max(times, key=times.get)
    return times[resource], resource
