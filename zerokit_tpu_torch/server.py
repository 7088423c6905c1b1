"""Batched RLN proving service (HTTP/JSON), the production-serving frontend.

The reference exposes C-FFI/WASM bindings for embedding (rln/src/ffi,
rln-wasm); an accelerator's deployment shape is a service in front of the
card instead. This server micro-batches concurrent prove requests
into single device batches (the pipeline's throughput comes from batching)
and serves:

    POST /prove   {"witness_hex": "<v2 LE witness bytes>"}
                  -> {"proof_hex": "<v2 LE proof bytes>"}
    POST /verify  {"proof_hex": ..., "x": "<hex>", "roots": ["<hex>", ...]}
                  -> {"valid": true}
    GET  /healthz -> {"status": "ok", "mode": "single", ...}

Wire payloads are the byte-exact v2 formats (protocol/serialize.py), so any
zerokit-compatible client can drive it.

Counterpart of zerokit_tpu/server.py. The service proves on `device`
("cuda" by default; it raises without a card unless given "cpu"), and
`python -m zerokit_tpu_torch.server` takes the device from the environment
variable ZEROKIT_TORCH_DEVICE (ff/field.device_from_env), as the C ABI's
engines do. Before the service accepts requests it warms its engine
(Groth16Prover.warm_up: the kernel library's nvcc build at first use and
the five MSMs' window tables), so the first request does not pay for them,
and serve() listens with a backlog that holds a burst of clients
(ProverHTTPServer).

SECURITY: the service is plaintext HTTP with no authentication, and /prove
witnesses plus /keygen responses carry identity secrets. Deploy it ONLY on a
trusted transport (loopback, or behind TLS termination on a private
network); anyone on the network path learns every secret that transits.
Clients that can do local crypto (clients/js when Node/browser bigint is
available) should keep keygen/identity local and use the service only for
proving (the reference's rln-wasm keeps keygen client-side for this reason).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from . import errors
from .api import RLN
from .ff.field import device_from_env
from .protocol.proof import RLNProof
from .protocol.serialize import (
    bytes_to_rln_proof,
    bytes_to_rln_witness,
    rln_proof_to_bytes,
)


class _PendingRequest:
    def __init__(self, witness):
        self.witness = witness
        self.event = threading.Event()
        self.result: Optional[bytes] = None
        self.error: Optional[str] = None


class ProverService:
    """Micro-batching proving loop: collects requests for up to max_wait_ms
    (or max_batch), proves them as one device batch."""

    def __init__(self, rln: Optional[RLN] = None, max_batch: int = 16, max_wait_ms: int = 50,
                 device="cuda"):
        """device: where a service without `rln` builds its engine. The
        engine is warmed before the worker starts."""
        self.rln = rln or RLN.stateless(device=device)
        self.rln.prover.warm_up()
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue: "queue.Queue[_PendingRequest]" = queue.Queue()
        self.total_proofs = 0
        self.total_batches = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch: List[_PendingRequest] = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1000.0
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._prove_batch(batch)

    def _prove_batch(self, batch: List[_PendingRequest]):
        try:
            results = self.rln.generate_proofs([p.witness for p in batch])
            for pending, (proof, values) in zip(batch, results):
                pending.result = rln_proof_to_bytes(
                    RLNProof(proof=proof, proof_values=values)
                )
            self.total_proofs += len(batch)
            self.total_batches += 1
        except Exception as e:  # propagate per-request
            for pending in batch:
                pending.error = f"{type(e).__name__}: {e}"
        finally:
            for pending in batch:
                pending.event.set()

    def prove(self, witness_bytes: bytes, timeout: Optional[float] = None) -> bytes:
        if timeout is None:
            # default must cover a first batch on a fresh checkout, which
            # waits for the kernels' nvcc build when the service was started
            # without its warm-up (52.7 s on an NVIDIA H100 80GB HBM3 at
            # 700.00 W, chip_smoke.py phase 2); a warm batch of 16 at depth
            # 20 returns in well under a second there
            timeout = float(os.environ.get("ZK_PROVE_TIMEOUT_S", "1800"))
        witness, _ = bytes_to_rln_witness(witness_bytes)
        pending = _PendingRequest(witness)
        self.queue.put(pending)
        if not pending.event.wait(timeout):
            raise TimeoutError("prove timed out")
        if pending.error:
            raise errors.GenerateProofError(pending.error)
        return pending.result

    def prove_partial(self, partial_witness_bytes: bytes) -> bytes:
        """Two-phase prove, phase 1 (reference proof.rs:783
        generate_partial_zk_proof): partial-witness wire in, serialized
        PartialProof out. Runs inline — the precompute is per-identity, not
        per-message, so it is not micro-batched."""
        from .protocol.serialize import (
            bytes_to_rln_partial_witness,
            rln_partial_proof_to_bytes,
        )

        pw, _ = bytes_to_rln_partial_witness(partial_witness_bytes)
        return rln_partial_proof_to_bytes(self.rln.generate_partial_proof(pw))

    def finish(self, partial_proof_bytes: bytes, witness_bytes: bytes) -> bytes:
        """Two-phase prove, phase 2 (proof.rs:806 finish_zk_proof)."""
        from .protocol.serialize import bytes_to_rln_partial_proof

        partial, _ = bytes_to_rln_partial_proof(partial_proof_bytes)
        witness, _ = bytes_to_rln_witness(witness_bytes)
        proof, values = self.rln.finish_proof(partial, witness)
        return rln_proof_to_bytes(RLNProof(proof=proof, proof_values=values))

    def verify(self, proof_bytes: bytes, x: Optional[int], roots: List[int]) -> bool:
        rln_proof, _ = bytes_to_rln_proof(proof_bytes)
        if x is not None:
            return self.rln.verify_with_roots(
                rln_proof.proof, rln_proof.proof_values, x, roots
            )
        return self.rln.verify(rln_proof.proof, rln_proof.proof_values)

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=2)


class ProverHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for a burst of clients.
    socketserver's default backlog is 5: a burst of concurrent /prove
    requests, which the micro-batcher exists to coalesce, had connections
    reset beyond it (zerokit_tpu/server.py serves with that default)."""

    request_queue_size = 128


def make_handler(service: ProverService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "max_out": service.rln.max_out(),
                        "tree_depth": service.rln.tree_depth(),
                        "total_proofs": service.total_proofs,
                        "total_batches": service.total_batches,
                    },
                )
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/prove":
                    proof = service.prove(bytes.fromhex(payload["witness_hex"]))
                    self._reply(200, {"proof_hex": proof.hex()})
                elif self.path == "/prove_partial":
                    out = service.prove_partial(
                        bytes.fromhex(payload["partial_witness_hex"])
                    )
                    self._reply(200, {"partial_proof_hex": out.hex()})
                elif self.path == "/finish":
                    out = service.finish(
                        bytes.fromhex(payload["partial_proof_hex"]),
                        bytes.fromhex(payload["witness_hex"]),
                    )
                    self._reply(200, {"proof_hex": out.hex()})
                elif self.path == "/keygen":
                    from .protocol.keygen import (
                        extended_keygen,
                        extended_seeded_keygen,
                        keygen,
                        seeded_keygen,
                    )

                    seed = payload.get("seed_hex")
                    seed_b = bytes.fromhex(seed) if seed else None
                    if payload.get("extended"):
                        parts = (
                            extended_seeded_keygen(seed_b)
                            if seed_b
                            else extended_keygen()
                        )
                        names = ("trapdoor", "nullifier", "secret", "commitment")
                        self._reply(
                            200,
                            {k: format(int(v), "x") for k, v in zip(names, parts)},
                        )
                    else:
                        sk, pk = seeded_keygen(seed_b) if seed_b else keygen()
                        self._reply(
                            200,
                            {"secret": format(int(sk), "x"), "commitment": format(pk, "x")},
                        )
                elif self.path == "/poseidon":
                    from .hash.poseidon import poseidon_hash

                    vals = [int(v, 16) for v in payload["inputs"]]
                    self._reply(200, {"hash": format(poseidon_hash(vals), "x")})
                elif self.path == "/verify":
                    x = payload.get("x")
                    valid = service.verify(
                        bytes.fromhex(payload["proof_hex"]),
                        int(x, 16) if isinstance(x, str) else x,
                        [int(r, 16) for r in payload.get("roots", [])],
                    )
                    self._reply(200, {"valid": bool(valid)})
                else:
                    self._reply(404, {"error": "not found"})
            except errors.VerifyProofError as e:
                self._reply(200, {"valid": False, "reason": str(e)})
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8077, device="cuda", **kwargs):
    # ZK_SERVER_DEPTH selects the circuit (10 = the small artifacts)
    depth = int(os.environ.get("ZK_SERVER_DEPTH", "20"))
    if depth != 20 and "rln" not in kwargs:
        from .resources import load_resource

        kwargs["rln"] = RLN.stateless(
            zkey_bytes=load_resource(f"tree_depth_{depth}/rln_final.arkzkey"),
            graph_bytes=load_resource(f"tree_depth_{depth}/graph.bin"),
            device=device,
        )
    service = ProverService(device=device, **kwargs)
    server = ProverHTTPServer((host, port), make_handler(service))
    print(f"zerokit-tpu-torch prover serving on {host}:{port} ({service.rln.device})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        service.stop()


if __name__ == "__main__":
    serve(device=device_from_env())
