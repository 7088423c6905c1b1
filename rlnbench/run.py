"""Runs one cell of the benchmark once.

    python3 -m rlnbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the cell's configuration and traffic
(named in BENCHMARK.json, found by name under rlnbench/), sets up, measures
for --seconds, checks what the window produced against the plain
reference, and prints one JSON object as the last line of standard
output: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with --trace 1
breakdown, and last check, each number compared beside its limit (also
the last lines of standard error).

Exits with 2 and prints no result without a card (or fewer than the cell
asks for), with 3 if a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STARTED = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "zerokit_tpu")


def process_start() -> float:
    """The perf_counter reading at which this process started (from
    /proc), or this module's import where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        now = time.perf_counter()
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return STARTED


def forbidden_modules(modules) -> list:
    """The loaded modules' top-level names (before the first dot, whole)
    that belong to JAX or to the JAX package."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    from .manifest import ROOT

    cache = os.path.join(ROOT, "build", "rlnbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m rlnbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(manifest, cell, out: dict, trace: bool) -> dict:
    """The last line: the cell's metrics of this kind, each read by its own
    file (per-layer) or taken from the loop (end-to-end)."""
    metrics = {}
    for m in manifest.metrics_for(cell.name, trace):
        value = manifest.reader(m["name"])(out["ctx"]) if trace else out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dict(out["device"])}
    summary = out.get("summary")
    if trace and summary:
        line["device"]["busy_s"] = summary["busy_s"]
        line["device"]["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    line["check"] = out["checked"]
    return line


def main(argv=None, make_program=None, on_card: bool = True, manifest=None) -> int:
    """make_program, on_card and manifest let a test drive a run on the CPU
    with a stand-in for the program; a run on the card passes none, and a
    closed loop drives the program its configuration names (Manifest.program)
    or, without one, program.py's Program."""
    from . import check, loops
    from .manifest import Manifest

    started = process_start()
    args = parse(argv)
    set_cache_dirs()
    manifest = manifest or Manifest.load()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell.config)
    traffic = manifest.traffic(cell.traffic)
    if on_card:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    try:
        if traffic["loop"] == "closed":
            if make_program is None and "program" in config:
                make_program = manifest.program(config["program"])
            elif make_program is None:
                from .program import Program as make_program
            out = loops.closed(config, traffic, args.seed, args.seconds, bool(args.trace),
                               started, make_program, on_card)
        else:
            out = loops.opened(manifest.config_path(cell.config), config, traffic, args.seed,
                               args.seconds, bool(args.trace), started)
    except loops.ForbiddenModules as e:
        print(f"forbidden modules loaded: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded once the window closed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    out["correct"] = check.report(out["checked"])
    print(json.dumps(result_line(manifest, cell, out, bool(args.trace))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
