"""The benchmark's own arithmetic, frozen here so that no change to the
program under test can move it: the Montgomery products of the MSMs'
least work, the card's 32-bit multiply peak, the busy share of a profiler
trace and its breakdown.

The constants are the ones the program's runtime/profiling module states
today (rlnbench/tests/test_rlnbench_yardstick.py holds them equal); the
benchmark never imports them from the program.
"""

from __future__ import annotations

import heapq
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# 32-bit multiply instructions of one CIOS Montgomery product over 8 words,
# lo and hi halves each counted: per outer step (8) the 8 a*b products
# (16), m = t0 * n0' (1) and the 8 m*p products (16).
MONT_MUL_IMADS = 8 * (2 * 8 + 1 + 2 * 8)
# Montgomery products of one curve operation: an Fq2 product is 3 Fq
# products and an Fq2 square 2; G1's b3 multiply is additions, G2's one Fq2
# product.
EC_OP_MONT_MULS = {
    (1, "add"): 12, (1, "add_mixed"): 11, (1, "double"): 8,
    (2, "add"): 12 * 3 + 2 * 3, (2, "add_mixed"): 11 * 3 + 2 * 3,
    (2, "double"): 2 + 3 + (2 + 3) + 5 * 3,
}
# the bucket method of the fixed-base MSMs: 32 windows of 8 bits
N_WINDOWS, C_BITS = 32, 8
# 32-bit integer multiply(-add)s a clock an SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
IMAD_PER_CLK_PER_SM = 64


def msm_bucket_mont_muls(n_points: int, comps: int = 1) -> int:
    """Montgomery products of one lane of an MSM over n affine points of G1
    (comps 1) or G2 (comps 2) by the bucket method: per window the n mixed
    adds into the buckets, the bucket reduction (2 * 255 adds: the running
    sum and the total) and c doublings; then the W - 1 adds that join the
    windows."""
    ops = EC_OP_MONT_MULS
    buckets = (1 << C_BITS) - 1
    per_window = (n_points * ops[(comps, "add_mixed")] + 2 * buckets * ops[(comps, "add")]
                  + C_BITS * ops[(comps, "double")])
    return N_WINDOWS * per_window + (N_WINDOWS - 1) * ops[(comps, "add")]


def proof_msm_imads(msm_points: Dict[str, int]) -> int:
    """32-bit multiplies of one proof's five MSMs: msm_points maps a/b1/l/h
    (G1) and b2 (G2) to their finite points."""
    total = 0
    for key, n in msm_points.items():
        total += msm_bucket_mont_muls(n, 2 if key == "b2" else 1)
    return total * MONT_MUL_IMADS


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def nvidia_smi(index: int = 0) -> Dict[str, str]:
    """The card's name, power limit, maximum and present SM clock as
    nvidia-smi reads them."""
    keys = ("name", "power.limit", "clocks.max.sm", "clocks.sm")
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", f"--query-gpu={','.join(keys)}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return dict(zip(keys, (s.strip() for s in out.split(","))))


def mhz(reading: str) -> float:
    return float(reading.split()[0])


def imad_peak_per_s(sm_count: int, clock_max_mhz: float) -> float:
    """The card's 32-bit multiply peak: SMs x maximum SM clock x 64. The
    maximum clock bounds the clock the card runs at, so no share of this
    peak can pass 100 % through a slower clock."""
    return sm_count * clock_max_mhz * 1e6 * IMAD_PER_CLK_PER_SM


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


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


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(busy: Sequence[Tuple[float, float]], spans: Sequence[Tuple[float, float]]) -> float:
    """Length of busy (a union) inside spans (a union)."""
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total += max(0.0, min(e, busy[k][1]) - max(s, busy[k][0]))
            k += 1
    return total


def summarize(prof, window_name: str, range_prefixes: Sequence[str] = ("msm.",),
              top: int = 10) -> Optional[dict]:
    """What the benchmark reads from a torch.profiler trace of the card:
    the traced window (the host range named window_name), the seconds in
    which a device event ran in it, the device seconds inside each range
    prefix (the ranges as the profiler places them on the device's
    timeline), the device operations that took most time, and the idle gaps
    by the host range (the innermost) open at their middle. None if the
    trace holds no device event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    dev = [ev for ev in events if ev.device_type == cuda
           and not getattr(ev, "is_user_annotation", False)
           and ev.time_range.end > ev.time_range.start]
    if not dev:
        return None
    marks = [ev for ev in events if ev.name == window_name and ev.device_type == cpu]
    if marks:
        window = (marks[0].time_range.start, marks[0].time_range.end)
    else:
        window = (min(ev.time_range.start for ev in events),
                  max(ev.time_range.end for ev in events))
    busy = union((max(ev.time_range.start, window[0]), min(ev.time_range.end, window[1]))
                 for ev in dev)
    busy_us = sum(e - s for s, e in busy)
    ranges = {}
    for prefix in range_prefixes:
        spans = union((ev.time_range.start, ev.time_range.end) for ev in events
                      if ev.device_type == cuda and getattr(ev, "is_user_annotation", False)
                      and ev.name.startswith(prefix))
        if spans:
            ranges[prefix] = covered(busy, spans) * 1e-6
    by_name: Dict[str, float] = {}
    for ev in dev:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.time_range.end - ev.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in events
                  if ev.device_type == cpu and ev.name != window_name
                  and ev.time_range.end > ev.time_range.start)
    gaps: Dict[str, float] = {}
    open_ranges: List[Tuple[float, float, str]] = []  # heap by start, latest first
    nxt = 0
    edge = window[0]
    for s, e in busy + [(window[1], window[1])]:
        if s > edge:
            mid = (s + edge) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                heapq.heappush(open_ranges, (-host[nxt][0], host[nxt][1], host[nxt][2]))
                nxt += 1
            while open_ranges and open_ranges[0][1] < mid:
                heapq.heappop(open_ranges)  # the latest opened has closed
            name = open_ranges[0][2] if open_ranges else "host: untraced python"
            gaps[name] = gaps.get(name, 0.0) + (s - edge)
        edge = max(edge, e)
    return {
        "window_s": (window[1] - window[0]) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "ranges_s": ranges,
        "device_ops": [[name, us * 1e-6] for name, us in ops],
        "idle_gaps": [[name, us * 1e-6] for name, us in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
