"""Finds the highest rate the prover service sustains, once, on the card.

    python3 -m rlnbench.sweep --workload v2d20-serve --seed <n> --seconds 15 \
        --rates 40 60 80 100 120 140

Starts the service as an open-loop run does (serve_child.py, its warm-up
and the traffic's warm bursts), then offers each rate in turn for
--seconds (Poisson arrivals, traffic.arrivals) and prints one line a rate:
offered and completed requests a second, the latency median, 95th
percentile and maximum, and the median latency of the last third of the
requests over that of the first third. A rate is sustained when every
request was answered and that ratio stays under GROWTH (no growing
backlog). The cell's rate is then set, by hand, in its
traffic file at about four fifths of the highest sustained rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import loops
from . import traffic as gen
from .manifest import Manifest
from .run import set_cache_dirs

GROWTH = 1.1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rlnbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs()
    manifest = Manifest.load()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell.config)
    traffic = manifest.traffic(cell.traffic)
    child = loops.Child(manifest.config_path(cell.config), loops.child_env())
    best = None
    try:
        port = child.read()["port"]
        for width in traffic["warm_bursts"]:
            ws = gen.witnesses(config, traffic, args.seed, "warm", width, width)
            loops.offer(port, [loops.body(w) for w in ws], [0.0] * width, width)
        for k, rate in enumerate(args.rates):
            t = dict(traffic, rate_per_s=rate)
            due = gen.arrivals(t, args.seed + k, args.seconds)
            ws = [gen.witnesses(config, t, args.seed + k, "window", i, 1)[0]
                  for i in range(len(due))]
            before = child.ask("stats")
            res = loops.offer(port, [loops.body(w) for w in ws], due,
                              int(traffic["client_threads"]))
            after = child.ask("stats")
            lat = res["latency_s"]
            n = len(lat)
            answered = sum(r is not None for r in res["replies"])
            third = max(1, n // 3)
            growth = statistics.median(lat[-third:]) / statistics.median(lat[:third])
            sustained = answered == n and growth < GROWTH
            batches = after["total_batches"] - before["total_batches"]
            line = {
                "rate_offered": n / res["window_s"], "answered": answered, "requests": n,
                "median_ms": statistics.median(lat) * 1e3,
                "p95_ms": loops.percentile(lat, 0.95) * 1e3, "max_ms": max(lat) * 1e3,
                "growth": growth, "lanes_per_batch": (after["total_proofs"]
                                                      - before["total_proofs"]) / max(1, batches),
                "sustained": sustained,
            }
            print(json.dumps(line), flush=True)
            if sustained:
                best = rate
    finally:
        child.close()
    chip = loops.chip_line(loops.device_info(True, after))
    print(f"highest sustained rate: {best} requests/s; {chip}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
