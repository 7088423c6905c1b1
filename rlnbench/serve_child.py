"""The prover service under test, in a process of its own.

    python -m rlnbench.serve_child <config file>

Builds the port's RLN over the configuration's circuit on the card, wraps
it in the port's ProverService (its own defaults: micro-batches of up to
16, a 50 ms window; its warm-up runs before it accepts requests) behind
ProverHTTPServer on 127.0.0.1 and a free port, then answers one command a
line on stdin with one marked JSON line on stdout:

    stats        the service's counters, the card's peak memory, its name
                 and SM count, and any forbidden module this process holds
    trace_start  starts torch.profiler over CPU and CUDA
    trace_stop   stops it and answers the trace's summary
    quit         stops the server and the service, and exits
"""

from __future__ import annotations

import json
import os
import sys
import threading

from .manifest import ROOT
from .run import forbidden_modules, set_cache_dirs
from .yardstick import summarize

MARK = "RLNBENCH "
WINDOW = "rlnbench.window"


def reply(obj) -> None:
    sys.stdout.write(MARK + json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(config_path: str) -> int:
    set_cache_dirs()
    with open(config_path) as f:
        config = json.load(f)
    import torch
    from zerokit_tpu_torch import RLN
    from zerokit_tpu_torch.circuit.graph import graph_from_bytes
    from zerokit_tpu_torch.circuit.zkey import zkey_from_bytes
    from zerokit_tpu_torch.server import ProverHTTPServer, ProverService, make_handler

    with open(os.path.join(ROOT, config["zkey"]), "rb") as f:
        zkey = zkey_from_bytes(f.read())
    with open(os.path.join(ROOT, config["graph"]), "rb") as f:
        graph = graph_from_bytes(f.read(), config["tree_depth"], config["max_out"])
    service = ProverService(rln=RLN(zkey, graph, device="cuda"))
    server = ProverHTTPServer(("127.0.0.1", 0), make_handler(service))
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    reply({"port": server.server_address[1]})
    prof = window = None
    try:
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "stats":
                reply({
                    "total_proofs": service.total_proofs,
                    "total_batches": service.total_batches,
                    "memory_peak_bytes": torch.cuda.max_memory_allocated(0),
                    "kind": torch.cuda.get_device_name(0),
                    "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
                    "forbidden": forbidden_modules(sys.modules),
                })
            elif cmd == "trace_start":
                torch.cuda.synchronize()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                window = torch.profiler.record_function(WINDOW)
                window.__enter__()
                reply({})
            elif cmd == "trace_stop":
                torch.cuda.synchronize()
                window.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                reply(summarize(prof, WINDOW) or {})
                prof = window = None
            elif cmd == "quit":
                break
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        serving.join(timeout=10)
    reply({})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
