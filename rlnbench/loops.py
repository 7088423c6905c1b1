"""The two loops a traffic file can ask for, and what each reports.

closed: one caller, the program in this process (program.py says what the
loop calls on it). Set-up builds the program, hands it the traffic's pool
of members where the traffic has one and the program takes it, runs its
warm-up and one call at the cell's batch width; the window then calls it
back to back until --seconds have passed, and closes when the last call
returns. proofs_per_s is every proof of a call that returned, over the
whole window. With --trace 1 the window runs as without, and a traced
segment of trace_calls more calls follows it under torch.profiler.

open: the prover service in a process of its own (serve_child.py),
single-witness POST /prove requests from this process at the traffic's
fixed rate, each due at a time drawn before the window (traffic.arrivals)
and timed from that time to its reply. proof_p95_ms is the 95th
percentile over every request due in the window; one with no reply counts
with the time waited for it. With --trace 1 a traced segment of
trace_seconds at the same rate follows the window, the profiler running
in the service's process.
"""

from __future__ import annotations

import concurrent.futures
import gc
import http.client
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from . import check
from . import traffic as gen
from . import yardstick
from .manifest import ROOT
from .reference.wire import witness_to_bytes

WINDOW = "rlnbench.window"  # the host range around a traced segment
REPLY_WAIT_S = 60.0  # how long past the window's close a reply is awaited


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------


def closed(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
           started: float, make_program: Callable, on_card: bool = True) -> Dict:
    batch = int(traffic["batch"])
    prog = make_program(config)
    if traffic.get("members") and hasattr(prog, "members"):
        prog.members(gen.members(config, traffic, seed))
    prog.warm_up()
    prog.call(prog.prepare(gen.witnesses(config, traffic, seed, "warm", 0, batch)),
              prog.metrics_type())
    if on_card:
        import torch

        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    calls: List[Optional[list]] = []
    records = []
    failed = 0
    t0 = time.perf_counter()
    while True:
        prepared = prog.prepare(gen.witnesses(config, traffic, seed, "window", len(calls), batch))
        metrics = prog.metrics_type()
        c0 = time.perf_counter()
        try:
            out = prog.call(prepared, metrics)
        except Exception as e:  # a failed call's proofs count as failed
            print(f"call {len(calls)} failed: {type(e).__name__}: {e}", file=sys.stderr)
            out = None
        c1 = time.perf_counter()
        if out is None:
            failed += batch
            calls.append(None)
        else:
            calls.append(prog.answers(out))
            records.append({"wall_s": c1 - c0, "stages": dict(metrics.stages)})
        if c1 - t0 >= seconds:
            break
    window_s = c1 - t0
    done = batch * len(calls) - failed
    info = device_info(on_card)
    print(f"window: {len(calls)} calls of {batch}, {done} proofs in {window_s:.4f} s; "
          f"{chip_line(info)}", file=sys.stderr)
    print_calls(records)

    summary = None
    if trace:
        summary = traced_calls(prog, config, traffic, seed, on_card)
    del prog
    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()
    checked = check.closed_loop(config, traffic, seed, calls, failed)
    ctx = {"calls": records, "trace": summary, "config": config, "chip": info.get("chip")}
    return {
        "attempted": batch * len(calls), "failed": failed, "checked": checked,
        "e2e": {"proofs_per_s": done / window_s, "setup_s": setup_s},
        "ctx": ctx, "device": info["device"], "summary": summary,
    }


def print_calls(records: List[dict]) -> None:
    """The spread of the calls' wall clocks, on one line."""
    walls = sorted(rec["wall_s"] * 1e3 for rec in records)
    if walls:
        print(f"calls: wall ms min {walls[0]:.2f}, median {statistics.median(walls):.2f}, "
              f"max {walls[-1]:.2f}", file=sys.stderr)


def traced_calls(prog, config, traffic, seed, on_card: bool) -> Optional[dict]:
    import torch

    batch = int(traffic["batch"])
    n = int(traffic["trace_calls"])
    prepared = [prog.prepare(gen.witnesses(config, traffic, seed, "trace", i, batch))
                for i in range(n)]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for p in prepared:
                prog.call(p)
            if on_card:
                torch.cuda.synchronize()
    t = time.perf_counter()
    summary = yardstick.summarize(prof, WINDOW) if on_card else None
    print(f"trace: {n} calls of {batch}, read in {time.perf_counter() - t:.2f} s", file=sys.stderr)
    if summary is not None:
        summary["lanes"] = n * batch
    return summary


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def device_info(on_card: bool, child: Optional[dict] = None) -> Dict:
    """The result's device entry and the chip's spec, read now."""
    if not on_card:
        return {"device": {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}}
    if child is None:
        import torch

        child = {
            "kind": torch.cuda.get_device_name(0),
            "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(0),
        }
    smi = yardstick.nvidia_smi(0)
    return {
        "device": {"platform": "gpu", "kind": child["kind"], "count": 1,
                   "memory_peak_bytes": int(child["memory_peak_bytes"])},
        "chip": {"sm_count": child["sm_count"], "clock_max_mhz": yardstick.mhz(smi["clocks.max.sm"]),
                 "clock_mhz": yardstick.mhz(smi["clocks.sm"]), "power_limit": smi["power.limit"],
                 "name": smi["name"]},
    }


def chip_line(info: Dict) -> str:
    chip = info.get("chip")
    if chip is None:
        return "no card"
    return (f"{chip['name']}, power limit {chip['power_limit']}, SM clock "
            f"{chip['clock_mhz']:g} MHz of {chip['clock_max_mhz']:g} MHz")


# ---------------------------------------------------------------------------
# open loop
# ---------------------------------------------------------------------------


class Child:
    """The prover service's process: one JSON line a command on stdin, one
    JSON line a reply (marked) on stdout; its other output goes to our
    standard error."""

    MARK = "RLNBENCH "

    def __init__(self, config_path: str, env: Dict[str, str]):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "rlnbench.serve_child", config_path],
            cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)

    def read(self) -> dict:
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"service exited ({self.proc.wait()})")
            if line.startswith(self.MARK):
                return json.loads(line[len(self.MARK):])
            sys.stderr.write(line)

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.ask("quit")
            self.proc.wait(timeout=60)
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()


def post_prove(port: int, body: bytes, timeout: float) -> Optional[bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/prove", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        return bytes.fromhex(json.loads(data)["proof_hex"])
    except (OSError, ValueError, KeyError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def body(w: Dict) -> bytes:
    return json.dumps({"witness_hex": witness_to_bytes(w).hex()}).encode()


def offer(port: int, bodies: List[bytes], due: List[float], workers: int) -> Dict:
    """Sends bodies[i] at due[i] seconds from now (open loop); returns each
    reply, each latency from its due time and how late each was sent.
    Waits for replies up to REPLY_WAIT_S past the last due time."""
    n = len(bodies)
    replies: List[Optional[bytes]] = [None] * n
    done_at = [math.inf] * n
    sent_at = [0.0] * n
    t0 = time.perf_counter()
    close = t0 + (due[-1] if due else 0.0)

    def one(i: int) -> None:
        sent_at[i] = time.perf_counter()
        wait = max(1.0, close + REPLY_WAIT_S - sent_at[i])
        replies[i] = post_prove(port, bodies[i], wait)
        done_at[i] = time.perf_counter()

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        for i in range(n):
            delay = t0 + due[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    lat = []
    for i in range(n):
        end = done_at[i] if replies[i] is not None else close + REPLY_WAIT_S
        lat.append(end - (t0 + due[i]))
    return {"replies": replies, "latency_s": lat,
            "late_s": [sent_at[i] - (t0 + due[i]) for i in range(n)],
            "window_s": (due[-1] if due else 0.0)}


def percentile(values: List[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of them at or below."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def child_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["USE_FLAX"] = "0"
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def opened(config_path: str, config: dict, traffic: dict, seed: int, seconds: float,
           trace: bool, started: float) -> Dict:
    workers = int(traffic["client_threads"])
    child = Child(config_path, child_env())
    try:
        ready = child.read()
        port = ready["port"]
        for width in traffic["warm_bursts"]:
            ws = gen.witnesses(config, traffic, seed, "warm", width, width)
            offer(port, [body(w) for w in ws], [0.0] * width, width)
        due = gen.arrivals(traffic, seed, seconds)
        requests = [gen.witnesses(config, traffic, seed, "window", i, 1)[0]
                    for i in range(len(due))]
        bodies = [body(w) for w in requests]
        before = child.ask("stats")
        setup_s = time.perf_counter() - started
        res = offer(port, bodies, due, workers)
        after = child.ask("stats")
        info = device_info(True, after)
        print(chip_line(info), file=sys.stderr)
        summary = None
        if trace:
            tdue = gen.arrivals(traffic, seed, float(traffic["trace_seconds"]))
            tws = [gen.witnesses(config, traffic, seed, "trace", i, 1)[0]
                   for i in range(len(tdue))]
            child.ask("trace_start")
            offer(port, [body(w) for w in tws], tdue, workers)
            summary = child.ask("trace_stop") or None
            after_trace = child.ask("stats")
            if after_trace["forbidden"]:
                after = after_trace
    finally:
        child.close()
    if after["forbidden"]:
        raise ForbiddenModules(after["forbidden"], "the service's process")
    replies, lat = res["replies"], res["latency_s"]
    n = len(replies)
    good = [x for x, r in zip(lat, replies) if r is not None]
    window_s = res["window_s"]
    print(f"window: {n} requests offered at {n / window_s:.4f}/s over {window_s:.4f} s, "
          f"{len(good)} replied ({len(good) / window_s:.4f}/s); latency median "
          f"{statistics.median(lat) * 1e3:.4f} ms, p95 {percentile(lat, 0.95) * 1e3:.4f} ms, "
          f"p99 {percentile(lat, 0.99) * 1e3:.4f} ms, max {max(lat) * 1e3:.4f} ms; "
          f"generator late by median {statistics.median(res['late_s']) * 1e3:.4f} ms, "
          f"max {max(res['late_s']) * 1e3:.4f} ms", file=sys.stderr)
    checked = check.open_loop(config, traffic, seed, requests, replies)
    counters = {k: after[k] - before[k] for k in ("total_proofs", "total_batches")}
    ctx = {"calls": [], "trace": summary, "config": config, "chip": info.get("chip"),
           "counters": counters}
    return {
        "attempted": n, "failed": n - len(good), "checked": checked,
        "e2e": {"proof_p95_ms": percentile(lat, 0.95) * 1e3, "setup_s": setup_s},
        "ctx": ctx, "device": info["device"], "summary": summary,
    }


class ForbiddenModules(RuntimeError):
    def __init__(self, names, where: str):
        super().__init__(f"{where} holds {', '.join(names)}")
        self.names = names
