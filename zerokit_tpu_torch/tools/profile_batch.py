"""Where the device time of a warm proving batch goes.

Counterpart of tools/msm_profile.py (the fused MSM's stage cut points),
tools/qap_profile.py (matvec / coset lift) and profiling.trace: instead of
timing truncated programs, one warm depth-20 Groth16Prover.prove_batch runs
under torch.profiler, and the report gives

  * the host-clock seconds of the prover's stages (each ends in a CUDA
    synchronize);
  * the device time of the kernels launched inside each range: the witness
    evaluator (witness.eval), the MSM pass (msm.digits, msm.sort, msm.fine,
    msm.coarse, msm.qgather, msm.sumq) and the witness map (qap.matvec,
    qap.coset_lift);
  * the ten kernels with the most device time;
  * the device busy share: the union of device-event intervals over the
    traced window;
  * each kernel wrapper's launches in that batch.

Run on the card: python -m zerokit_tpu_torch.tools.profile_batch [--batch 16]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..ff.field import resolve_device
from ..runtime.profiling import (PipelineMetrics, device_busy_share, kernel_times,
                                 launch_counts, range_times, trace)

DEPTH = 20
NO_DEVICE_TIME = "device busy share: not measured (profiler saw no device time)"


def profile_batch(prover, inputs) -> dict:
    """Proves one batch under trace() and returns the report (see the
    module docstring). The prover should be warm (window tables built)."""
    named, rs, ss = inputs
    before = launch_counts()
    metrics = PipelineMetrics()
    with trace() as prof:
        t0 = time.perf_counter()
        proofs = prover.prove_batch(named, rs, ss, metrics=metrics)
        wall = time.perf_counter() - t0
    after = launch_counts()
    kernels = kernel_times(prof)
    return {
        "proofs": proofs,
        "wall_s": wall,
        "stages": metrics.report()["stages"],
        "ranges_us": range_times(prof),
        "top_kernels": kernels[:10],
        "top_all": kernels,
        "device_us": sum(k[1] for k in kernels),
        "busy_share": device_busy_share(prof) if kernels else None,
        "launches": {k: after[k] - before[k] for k in after},
        "trace": prof.trace_path,
    }


def print_report(rep: dict, label: str, log=print) -> None:
    log(f"traced warm batch: {rep['wall_s']:.3f} s wall (profiler on); {label}")
    log("  stages (host clock, s): " + ", ".join(f"{k} {v:.4f}" for k, v in rep["stages"].items()))
    log("  device busy time inside the ranges (ms): "
        + (", ".join(f"{k} {v / 1e3:.3f}" for k, v in rep["ranges_us"].items())
           or "not measured (no device-side ranges in the trace)"))
    for name, us, count in rep["top_kernels"]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {name[:110]}")
    if rep["busy_share"] is None:
        log(NO_DEVICE_TIME)
    else:
        log(f"device busy share: {rep['busy_share']:.4f} "
            f"({rep['device_us'] / 1e3:.3f} ms of device events); {label}")
    log(f"  launches in this batch: {rep['launches']}")
    log(f"  chrome trace: {os.path.relpath(rep['trace'])}")


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    from ..groth16.prover import Groth16Prover, random_batch_inputs
    from ..resources import load_circuit
    from ..runtime import native
    from ..runtime.profiling import ChipSpec

    device = resolve_device("cuda")
    label = ChipSpec.from_device(torch.cuda.current_device()).label()
    native.ensure_loaded()
    rng = np.random.default_rng(20)
    zkey, graph = load_circuit(DEPTH)
    prover = Groth16Prover(zkey, graph, device=device)
    prover.prove_batch(*random_batch_inputs(rng, args.batch, DEPTH))  # builds the tables
    rep = profile_batch(prover, random_batch_inputs(rng, args.batch, DEPTH))
    print_report(rep, label)
    return rep


if __name__ == "__main__":
    main()
