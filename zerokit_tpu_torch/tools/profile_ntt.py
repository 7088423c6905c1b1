"""Where the device time of the NTT goes, launch by launch.

Two calls, each on rotating copies of its input (runtime/profiling.l2_cold,
so every launch reads its data from HBM): the witness map's coset lift,
ff/ntt_kernels.coset_lift_bn on (16, 48, 8192), and the component fft,
groth16/ntt.fft on (16, 1, 2^20) (the input that repeats nowhere,
tools/ntt_micro.make_input(seed=1)). Each call runs `reps` times under
torch.profiler; the report lists every device event of one call in launch
order with its mean duration over the reps, sums them by part (K4: the
cross stages; K5: the tail; the bit-reversal gather: torch's index_select;
the rest), and gives the call's CUDA-event time beside (device_ms, L2-cold).

Run on the card: python -m zerokit_tpu_torch.tools.profile_ntt [log2 n] [reps]
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from ..constants import R
from ..ff import ntt_kernels as nk
from ..groth16 import ntt
from ..runtime.profiling import ChipSpec, device_events, device_ms, l2_cold, trace
from .ntt_micro import make_input

# kernel-name keys of each part; ntt_stage_kernel is the one-stage K4 of
# earlier trees, which the tool also measures
PARTS = (("K4", ("ntt_cross_kernel", "ntt_stage_kernel")), ("K5", ("ntt_tail_kernel",)),
         ("gather", ("index", "scatter_gather")))


def part_of(kernel_name: str) -> str:
    for part, keys in PARTS:
        if any(k in kernel_name for k in keys):
            return part
    return "other"


def launches(call: Callable, reps: int) -> List[tuple]:
    """(kernel name, mean microseconds) of each launch of one call(), in
    launch order, over reps traced calls."""
    call()
    torch.cuda.synchronize()
    with trace() as prof:
        for _ in range(reps):
            call()
    events = sorted(device_events(prof), key=lambda ev: ev.time_range.start)
    if not events or len(events) % reps:
        raise RuntimeError(f"the profiler saw {len(events)} device events in {reps} calls")
    per = len(events) // reps
    rows = []
    for i in range(per):
        evs = events[i::per]
        if len({ev.name for ev in evs}) != 1:
            raise RuntimeError(f"launch {i} differs between the traced calls")
        us = sum(ev.time_range.end - ev.time_range.start for ev in evs) / reps
        rows.append((evs[0].name, us))
    return rows


def profile(what: str, call: Callable, inputs: tuple, reps: int, label: str,
            log=print) -> Dict[str, float]:
    """Traces call(*inputs) L2-cold and prints its launches; returns the
    microseconds by part and the call's device_ms (key "call_ms")."""
    cold = l2_cold(call, *inputs)
    rows = launches(cold, reps)
    log(f"{what}: {len(rows)} launches, mean of {reps} traced L2-cold calls; {label}")
    parts: Dict[str, float] = {}
    for name, us in rows:
        part = part_of(name)
        parts[part] = parts.get(part, 0.0) + us
        log(f"  {us:9.2f} us  {part:6s} {name[:100]}")
    parts["call_ms"] = device_ms(cold, reps)
    log(f"  by part (us): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items() if k != "call_ms")
        + f"; the call by CUDA events {parts['call_ms']:.4f} ms (L2-cold, untraced)")
    return parts


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    log_n = int(argv[0]) if argv else 20
    reps = int(argv[1]) if len(argv) > 1 else 5
    label = ChipSpec.from_device(torch.cuda.current_device()).label()
    rng = np.random.default_rng(14)
    n_lift, rows = 8192, 48
    limbs = rng.integers(0, 1 << 16, size=(16, rows, n_lift), dtype=np.uint32)
    limbs[15] %= (R >> 240) & 0xFFFF
    x = torch.from_numpy(limbs.astype(np.int32)).cuda()
    root = ntt.coset_root_2n(n_lift)
    out = {"lift": profile(f"coset_lift_bn (16, {rows}, {n_lift}), P = {nk.TAIL}",
                           lambda a: nk.coset_lift_bn(a, root), (x,), reps, label)}
    y = make_input(1 << log_n, 1, "cuda", seed=1)
    out["fft"] = profile(f"fft (16, 1, 2^{log_n})", ntt.fft, (y,), reps, label)
    return out


if __name__ == "__main__":
    main()
