"""The port's prover service (zerokit_tpu_torch/server.py) on tests/test_server.py's
cases, its warm-up and device rule, and the locks behind its threads.

tests/test_server.py's cases run on the port's service with its stub
engine (micro-batching, wire formats, verify paths, the HTTP surface);
/keygen and /poseidon are held against the JAX package's functions. Then:
the service warms its engine before it serves; without a card the service
and `python -m zerokit_tpu_torch.server` raise unless told "cpu"; and the
engine state that the worker thread and the handler threads share is
built or used by one thread at a time (the kernel library's first load,
the MSM window tables, the witness evaluator's slot buffers), checked with
two threads that reach it together.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from zerokit_tpu_torch import RLNWitnessInput, hash_to_field_le
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.protocol.serialize import bytes_to_rln_proof, rln_witness_to_bytes
from zerokit_tpu_torch.server import ProverService

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubProver:
    def __init__(self, rln):
        self.rln = rln
        self.warm_ups = 0

    def warm_up(self):
        assert not self.rln.batches, "warmed after a batch"
        self.warm_ups += 1


class StubRLN:
    """Duck-typed RLN: returns fixed curve points instead of proving."""

    def __init__(self):
        self.batches = []
        self.prover = StubProver(self)
        self.proof = (
            bn254.G1.mul(bn254.G1_GENERATOR, 7),
            bn254.G2.mul(bn254.G2_GENERATOR, 9),
            bn254.G1.mul(bn254.G1_GENERATOR, 11),
        )

    def max_out(self):
        return 1

    def tree_depth(self):
        return 20

    def generate_proofs(self, witnesses):
        self.batches.append(len(witnesses))
        return [(self.proof, proof_values_from_witness(w)) for w in witnesses]

    def verify(self, proof, values):
        return proof == self.proof

    def verify_with_roots(self, proof, values, x, roots):
        from zerokit_tpu_torch import errors

        if roots and values.root not in roots:
            raise errors.InvalidRoot("root")
        if x % R != values.x:
            raise errors.InvalidSignal("x")
        return proof == self.proof


def _witness(i: int) -> RLNWitnessInput:
    return RLNWitnessInput.new_single(
        hash_to_field_le(b"s%d" % i), 100, 1,
        [0] * 20, [0] * 20, hash_to_field_le(b"x%d" % i), 12345,
    )


def test_prove_roundtrip_and_batching():
    stub = StubRLN()
    svc = ProverService(rln=stub, max_batch=8, max_wait_ms=80)
    try:
        results = {}

        def call(i):
            results[i] = svc.prove(rln_witness_to_bytes(_witness(i)))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 4
        # concurrent requests coalesced into fewer device batches
        assert len(stub.batches) < 4
        proof, _ = bytes_to_rln_proof(results[0])
        assert proof.proof == stub.proof
        assert svc.total_proofs == 4
    finally:
        svc.stop()


def test_verify_paths():
    stub = StubRLN()
    svc = ProverService(rln=stub, max_wait_ms=1)
    try:
        blob = svc.prove(rln_witness_to_bytes(_witness(0)))
        values = proof_values_from_witness(_witness(0))
        assert svc.verify(blob, None, [])
        assert svc.verify(blob, values.x, [values.root])
        from zerokit_tpu_torch import errors

        with pytest.raises(errors.InvalidRoot):
            svc.verify(blob, values.x, [123456789])
        with pytest.raises(errors.InvalidSignal):
            svc.verify(blob, values.x + 1, [values.root])
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# HTTP-level coverage: real socket, routing, content handling, error mapping
# (server.py make_handler / ThreadingHTTPServer surface).
# ---------------------------------------------------------------------------

import http.client
import json

from http.server import ThreadingHTTPServer

from zerokit_tpu_torch.server import make_handler


@pytest.fixture()
def http_service():
    stub = StubRLN()
    svc = ProverService(rln=stub, max_batch=8, max_wait_ms=20)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield stub, svc, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


def _request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    body = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"} if body else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, data


def test_http_healthz_and_routing(http_service):
    _, _, port = http_service
    status, data = _request(port, "GET", "/healthz")
    assert status == 200
    assert data["status"] == "ok" and data["tree_depth"] == 20
    status, _ = _request(port, "GET", "/nope")
    assert status == 404
    status, _ = _request(port, "POST", "/nope", {})
    assert status == 404


def test_http_prove_verify_roundtrip(http_service):
    stub, svc, port = http_service
    wbytes = rln_witness_to_bytes(_witness(1))
    status, data = _request(port, "POST", "/prove", {"witness_hex": wbytes.hex()})
    assert status == 200, data
    proof_hex = data["proof_hex"]
    proof, _ = bytes_to_rln_proof(bytes.fromhex(proof_hex))
    assert proof.proof == stub.proof

    # stateless verify
    status, data = _request(port, "POST", "/verify", {"proof_hex": proof_hex})
    assert status == 200 and data["valid"] is True

    # verify_with_roots path: wrong root set -> valid: false via error mapping
    vals = proof.proof_values
    status, data = _request(
        port, "POST", "/verify",
        {"proof_hex": proof_hex, "x": "%x" % vals.x, "roots": ["%x" % vals.root]},
    )
    assert status == 200 and data["valid"] is True
    status, data = _request(
        port, "POST", "/verify",
        {"proof_hex": proof_hex, "x": "%x" % vals.x, "roots": ["1"]},
    )
    assert status == 200 and data["valid"] is False


def test_http_malformed_requests(http_service):
    _, _, port = http_service
    status, data = _request(port, "POST", "/prove", {"witness_hex": "zz"})
    assert status == 400 and "error" in data
    status, data = _request(port, "POST", "/prove", {})
    assert status == 400 and "error" in data
    status, data = _request(port, "POST", "/verify", {"proof_hex": "00"})
    assert status == 400 and "error" in data


def test_http_keygen_and_poseidon(http_service):
    """Round-3 endpoints backing the JS client's Identity/Merkle helpers."""
    _, _, port = http_service
    status, data = _request(port, "POST", "/keygen", {"seed_hex": b"js-seed".hex()})
    assert status == 200
    from zerokit_tpu.protocol.keygen import seeded_keygen  # the JAX package's

    sk, pk = seeded_keygen(b"js-seed")
    assert int(data["secret"], 16) == int(sk)
    assert int(data["commitment"], 16) == pk

    status, data = _request(port, "POST", "/keygen", {"extended": True})
    assert status == 200
    assert set(data) == {"trapdoor", "nullifier", "secret", "commitment"}

    from zerokit_tpu.hash.poseidon import poseidon_hash  # the JAX package's

    status, data = _request(port, "POST", "/poseidon", {"inputs": ["ab", "3"]})
    assert status == 200
    assert int(data["hash"], 16) == poseidon_hash([0xAB, 3])


def test_http_partial_finish_routing(http_service):
    """/prove_partial and /finish route to the engine (stub: no partial
    support -> clean 400 error, no crash)."""
    _, _, port = http_service
    status, data = _request(
        port, "POST", "/prove_partial", {"partial_witness_hex": "00"}
    )
    assert status == 400 and "error" in data
    status, data = _request(
        port, "POST", "/finish", {"partial_proof_hex": "00", "witness_hex": "00"}
    )
    assert status == 400 and "error" in data


def test_finish_decodes_partial_proof_wire():
    """Regression: bytes_to_rln_partial_proof returns (obj, read); both the
    server and the FFI glue must unpack it (a tuple leaked through to
    finish_proof and failed only when the two-phase flow was driven)."""
    from zerokit_tpu_torch.groth16.prover import PartialProof
    from zerokit_tpu_torch.protocol.serialize import (
        bytes_to_rln_partial_proof,
        rln_partial_proof_to_bytes,
    )

    p = PartialProof(
        mask=[True, False, True],
        partial_pi_a=bn254.G1.mul(bn254.G1_GENERATOR, 3),
        partial_rho=bn254.G1.mul(bn254.G1_GENERATOR, 5),
        partial_pi_b=bn254.G2.mul(bn254.G2_GENERATOR, 7),
        partial_pi_c=bn254.G1.mul(bn254.G1_GENERATOR, 9),
    )
    wire = rln_partial_proof_to_bytes(p)

    class FinishCapture:
        def finish_proof(self, partial, witness):
            assert isinstance(partial, PartialProof)  # not a (obj, read) tuple
            assert partial.mask == p.mask
            raise RuntimeError("stop-after-decode")

    svc = ProverService.__new__(ProverService)
    svc.rln = FinishCapture()
    with pytest.raises(RuntimeError, match="stop-after-decode"):
        svc.finish(wire, rln_witness_to_bytes(_witness(1)))

    import zerokit_tpu_torch.ffi_glue as glue  # noqa: F401 (imports without jax)

    obj, read = bytes_to_rln_partial_proof(wire)
    assert read == len(wire) and isinstance(obj, PartialProof)



# -- warm-up and the device rule ----------------------------------------------


def test_service_warms_its_engine_before_serving():
    stub = StubRLN()
    svc = ProverService(rln=stub, max_wait_ms=1)
    try:
        assert stub.prover.warm_ups == 1
        svc.prove(rln_witness_to_bytes(_witness(2)))
        assert stub.batches == [1] and stub.prover.warm_ups == 1
    finally:
        svc.stop()


def test_same_proof_bytes_as_the_jax_service():
    from zerokit_tpu.server import ProverService as JaxProverService

    wire = rln_witness_to_bytes(_witness(3))
    port = ProverService(rln=StubRLN(), max_wait_ms=1)
    ref = JaxProverService(rln=StubRLN(), max_wait_ms=1)
    try:
        assert port.prove(wire) == ref.prove(wire)
    finally:
        port.stop()
        ref.stop()


def test_without_a_card_the_service_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProverService()
    env = {k: v for k, v in os.environ.items() if k != "ZEROKIT_TORCH_DEVICE"}
    env["ZK_SERVER_DEPTH"] = "10"
    r = subprocess.run([sys.executable, "-m", "zerokit_tpu_torch.server"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_device_from_env(monkeypatch):
    from zerokit_tpu_torch.ff.field import device_from_env

    monkeypatch.delenv("ZEROKIT_TORCH_DEVICE", raising=False)
    assert device_from_env() == "cuda"
    monkeypatch.setenv("ZEROKIT_TORCH_DEVICE", "cpu")
    assert device_from_env() == "cpu"


# -- state that two threads reach together ------------------------------------


def _together(fn, n=2):
    """Runs fn(i) in n threads released at once; returns their results."""
    gate = threading.Barrier(n)
    out = [None] * n
    errors_seen = []

    def run(i):
        gate.wait()
        try:
            out[i] = fn(i)
        except BaseException as e:  # re-raised below, in the test's thread
            errors_seen.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors_seen:
        raise errors_seen[0]
    return out


def test_kernel_library_builds_once_for_two_threads(monkeypatch):
    from zerokit_tpu_torch.ff import _cuda

    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a build takes long enough for the other thread to arrive
        return "libzk_kernels_test.so"

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "build", slow_build)
    monkeypatch.setattr(_cuda, "_load", lambda path: object())
    first, second = _together(lambda i: _cuda.lib())
    assert len(builds) == 1 and first is second


def test_msm_tables_build_once_for_two_threads(monkeypatch):
    from zerokit_tpu_torch.ff.fq2 import FqAdapter
    from zerokit_tpu_torch.groth16 import msm as msm_mod

    real = msm_mod.build_window_tables
    builds = []

    def slow_tables(*args, **kwargs):
        builds.append(1)
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(msm_mod, "build_window_tables", slow_tables)
    points = [bn254.G1.mul(bn254.G1_GENERATOR, k) for k in (3, 5, 7)]
    msm = msm_mod.MSM(points, FqAdapter, "cpu")
    first, second = _together(lambda i: msm.tables())
    assert len(builds) == 1 and first is second


def test_witness_evaluations_from_two_threads_keep_their_inputs(monkeypatch):
    """The evaluator reuses one slot buffer a lane count: a second thread's
    inputs loaded while the first thread's steps wait must not reach them."""
    from zerokit_tpu_torch.circuit import witness_eval as we
    from zerokit_tpu_torch.tools.witness_graphs import chain_graph

    ev = we.WitnessEvaluator(we.compile_graph(chain_graph("mix", 24)), "cpu")
    rng = np.random.default_rng(11)
    inputs = [ev.build_input_buffer({"x": [[int(v) for v in rng.integers(1, 1 << 62, 4)]]}, 4)
              for _ in range(2)]
    serial = [ev.evaluate_mont(x.copy()) for x in inputs]
    assert not torch.equal(serial[0], serial[1])
    load = ev.load

    def slow_load(x):
        buf = load(x)
        time.sleep(0.2)  # the other thread reaches its own load meanwhile
        return buf

    monkeypatch.setattr(ev, "load", slow_load)
    together = _together(lambda i: ev.evaluate_mont(inputs[i].copy()))
    assert all(torch.equal(t, s) for t, s in zip(together, serial))


def test_prover_warm_up_builds_every_table_then_proves_a_batch_of_one():
    """warm_up builds the five MSMs' tables, then sends a throwaway batch of
    one, every input of the graph filled, through prove_batch (recorded
    here: the proving path itself is held against the JAX prover in
    tests/test_torch_prover.py)."""
    from zerokit_tpu_torch.circuit import graph as gm
    from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
    from zerokit_tpu_torch.groth16.prover import Groth16Prover
    from zerokit_tpu_torch.groth16.setup import groth16_setup
    import random

    # tests/test_torch_prover.py's 2-constraint circuit (wires 1, x, w1, w2;
    # w1 * w1 = w2, w2 * w1 = x), with its witness graph from input w1
    matrices = ConstraintMatrices(
        num_instance_variables=2, num_witness_variables=2, num_constraints=2,
        a_num_non_zero=2, b_num_non_zero=2, c_num_non_zero=2,
        a=[[(1, 2)], [(1, 3)]], b=[[(1, 2)], [(1, 2)]], c=[[(1, 3)], [(1, 1)]],
    )
    nodes = [gm.Node(kind=gm.K_INPUT, a=0), gm.Node(kind=gm.K_INPUT, a=1),
             gm.Node(kind=gm.K_DUO, op=gm.OP_MUL, a=1, b=1),
             gm.Node(kind=gm.K_DUO, op=gm.OP_MUL, a=2, b=1)]
    graph = gm.Graph(nodes=nodes, signals=[0, 3, 1, 2], input_mapping={"w": (1, 1)},
                     tree_depth=0, max_out=1)
    prover = Groth16Prover(groth16_setup(matrices, random.Random(5)), graph, "cpu")
    msms = (prover.msm_a, prover.msm_b1, prover.msm_b2, prover.msm_h, prover.msm_l)
    assert all(m._tables is None for m in msms)
    batches = []
    prover.prove_batch = lambda named, rs, ss, metrics=None: batches.append((named, rs, ss))
    prover.warm_up()
    assert all(m._tables is not None for m in msms)
    (named, rs, ss), = batches
    assert list(named) == ["w"] and len(named["w"]) == 1 and len(named["w"][0]) == 1
    assert len(rs) == len(ss) == 1
    assert prover.evaluator.build_input_buffer(named, 1).shape[1:] == (2, 1)
