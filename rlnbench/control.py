"""The control of the check: the plain reference in the program's place,
with one guarantee broken, has to come out as not correct.

    python3 -m rlnbench.control --workload <name> --seeds <n> <n> <n> [--calls N]

The configurations state exact proofs over BN254; the control breaks that
exactness the way a tempting shortcut would, by cutting every MSM scalar
to its low 248 bits (the top byte dropped: reference.prover.CONTROL_MASK).
For each seed it answers, at the cell's own sizes, the positions the
check samples from a window of --calls calls (closed loop) or of
rate x --seconds requests (open loop), runs the cell's check on them and
prints its numbers; the benchmark's own runs never run it. The control
needs no card: the reference runs on the host's cores.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import check
from . import traffic as gen
from .manifest import Manifest
from .reference import jobs
from .reference.prover import CONTROL_MASK
from .reference.wire import proof_to_wire, values_from_public


def control_closed(config: dict, traffic: dict, seed: int, calls: int) -> dict:
    batch = int(traffic["batch"])
    positions = check.sample(seed, [batch] * calls, check.BATCH_SAMPLE)
    work = []
    for call, lane in positions:
        w = gen.witnesses(config, traffic, seed, "window", call, batch)[lane]
        work.append({"named": gen.named_inputs(w), "r": w["r"], "s": w["s"],
                     "scalar_mask": CONTROL_MASK})
    answers = {}
    for pos, res in zip(positions, check.pool_map(config, jobs.prove_job, work)):
        answers[pos] = (res["proof"], values_from_public(res["public"], config["public_inputs"],
                                                         config["max_out"]))
    return check.closed_loop(config, traffic, seed, [[]] * calls, 0,
                             answer_fn=lambda call, lane, w: answers[(call, lane)])


def control_open(config: dict, traffic: dict, seed: int, seconds: float) -> dict:
    due = gen.arrivals(traffic, seed, seconds)
    requests = [gen.witnesses(config, traffic, seed, "window", i, 1)[0] for i in range(len(due))]
    positions = check.sample(seed, [len(requests)], check.SERVE_SAMPLE)
    work = [{"named": gen.named_inputs(requests[i]), "r": requests[i]["r"],
             "s": requests[i]["s"], "scalar_mask": CONTROL_MASK} for _, i in positions]
    # the positions the check does not sample are never read: any bytes do
    replies = [b""] * len(requests)
    for (_, i), res in zip(positions, check.pool_map(config, jobs.prove_job, work)):
        values = values_from_public(res["public"], config["public_inputs"], config["max_out"])
        replies[i] = proof_to_wire(res["proof"], values)
    return check.open_loop(config, traffic, seed, requests, replies)


def main(argv=None, manifest=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rlnbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=12, help="window calls (closed loop)")
    ap.add_argument("--seconds", type=float, default=20.0, help="window (open loop)")
    args = ap.parse_args(argv)
    manifest = manifest or Manifest.load()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell.config)
    traffic = manifest.traffic(cell.traffic)
    failed_all = True
    for seed in args.seeds:
        if traffic["loop"] == "closed":
            nums = control_closed(config, traffic, seed, args.calls)
        else:
            nums = control_open(config, traffic, seed, args.seconds)
        ok = check.report(nums)
        failed_all &= not ok
        print(json.dumps({"workload": cell.name, "seed": seed, "control_correct": ok,
                          "check": nums}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
