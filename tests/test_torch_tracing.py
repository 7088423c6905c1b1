"""The port's spans: a proving call's host phases on the profiler's clock.

One RLN.generate_proofs call on the depth-10 circuit runs on the CPU with
profiling.span() recording: torch.profiler.record_function, the range
span() opens while a profiler runs, is replaced by a recorder of each
range's name, parent and times. (A CPU profile of that call holds some
five million torch op events and takes minutes to read; the ranges reach
a real profile through profiling.trace in the tests below and in
tests/test_torch_profiling.py.) The call must open every span of a call,
each inside its parent, and its stage.* spans must name
exactly the stages that PipelineMetrics records. The five MSMs run over
their first window only (the low 8 bits of each scalar) so that the call
takes seconds: the proof is not checked here (tests/test_torch_prover.py
and tests/test_torch_api.py hold the proofs), only how its time is named.

The benchmark reads the spans through rlnbench.yardstick.summarize, which
names each idle gap of the card by the innermost host range open at its
middle; summarize and the facade_idle_pct.batch reader are rehearsed on
synthetic events.
"""

import contextlib
import functools
import glob
import os
import re
import time

import pytest
import torch

from rlnbench import yardstick
from rlnbench.manifest import Manifest
from test_torch_profiling import _Ev, _Prof
from zerokit_tpu_torch import RLN, RLNWitnessInput, hash_to_field_le
from zerokit_tpu_torch.groth16 import prover as prover_mod
from zerokit_tpu_torch.groth16.msm import MSM
from zerokit_tpu_torch.groth16.verifier import rln_public_inputs
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.resources import load_resource
from zerokit_tpu_torch.runtime import profiling as prof

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the stages of a depth-10 call, as tests/test_torch_prover.py holds them
STAGES = {"witness_eval", "qap_witness_map", "from_mont", "msm_ab1l", "msm_b2", "msm_h",
          "host_assembly"}
# span -> the span it opens directly inside, in one call
PARENT = {
    "facade.validate": "rln.generate_proofs",
    "facade.values": "rln.generate_proofs",
    "facade.inputs": "rln.generate_proofs",
    "prover.pad": "rln.generate_proofs",
    "host.public": "rln.generate_proofs",
    **{"stage." + s: "rln.generate_proofs" for s in STAGES},
    "host.witness_inputs": "stage.witness_eval",
    "witness.eval": "stage.witness_eval",
    "qap.matvec": "stage.qap_witness_map",
    "qap.coset_lift": "stage.qap_witness_map",
}
AFFINE_STAGES = {"stage.msm_ab1l", "stage.msm_b2", "stage.msm_h"}
FACADE = {"facade.validate", "facade.values", "facade.inputs"}
HOST = {"rln.generate_proofs", "prover.pad", "host.witness_inputs", "host.public",
        "host.affine"}
# the ranges msm_roofline_pct.batch sums device time inside, and the other
# ranges the tools sum (profiling.RANGE_PREFIXES)
MSM_RANGES = {"msm.digits", "msm.sort", "msm.fine", "msm.coarse", "msm.qgather", "msm.sumq"}
OTHER_RANGES = {"witness.eval", "qap.matvec", "qap.coset_lift"}


class Ranges:
    """Stands in for torch.profiler.record_function: (name, parent, start,
    end) of every range, in the order opened."""

    def __init__(self):
        self.spans, self.open = [], []

    @contextlib.contextmanager
    def record_function(self, name):
        rec = [name, self.open[-1][0] if self.open else None, time.perf_counter(), None]
        self.spans.append(rec)
        self.open.append(rec)
        try:
            yield
        finally:
            self.open.pop()
            rec[3] = time.perf_counter()


@pytest.fixture(scope="module")
def recorded_call():
    """(RLN, its two witnesses, Ranges, PipelineMetrics) of one call."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(prover_mod, "MSM", functools.partial(MSM, n_windows=1))
        rln = RLN.stateless(device="cpu",
                            zkey_bytes=load_resource("tree_depth_10/rln_final.arkzkey"),
                            graph_bytes=load_resource("tree_depth_10/graph.bin"))
        prover = rln.prover
        for msm in (prover.msm_a, prover.msm_b1, prover.msm_b2, prover.msm_h, prover.msm_l):
            msm.tables()
        prover._g1_group.tables_cat()
        secret = hash_to_field_le(b"traced member")
        depth = rln.tree_depth()
        path = [hash_to_field_le(bytes([i])) for i in range(depth)]
        ws = [RLNWitnessInput.new_single(secret, 5, i, path, [i & 1] * depth,
                                         hash_to_field_le(b"signal %d" % i),
                                         hash_to_field_le(b"epoch"))
              for i in range(2)]
        ranges, metrics = Ranges(), prof.PipelineMetrics()
        mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        mp.setattr(torch.profiler, "record_function", ranges.record_function)
        rln.generate_proofs(ws, metrics=metrics)
    finally:
        mp.undo()
    assert not ranges.open
    return rln, ws, ranges, metrics


def test_a_call_names_every_host_phase(recorded_call):
    _, _, ranges, metrics = recorded_call
    names = {name for name, *_ in ranges.spans}
    assert set(metrics.stages) == STAGES
    assert metrics.counts == {"public_from_assignment": 2}
    assert {n for n in names if n.startswith("stage.")} == {"stage." + k for k in metrics.stages}
    assert FACADE | HOST | OTHER_RANGES | MSM_RANGES <= names
    assert {n for n in names if n.startswith("msm.")} == MSM_RANGES
    assert names <= FACADE | HOST | OTHER_RANGES | MSM_RANGES | set(PARENT)


def test_spans_nest_as_a_call_runs(recorded_call):
    spans = recorded_call[2].spans
    assert spans[0][:2] == ["rln.generate_proofs", None]
    assert all(parent is not None for _, parent, _, _ in spans[1:])  # all inside the call
    call_start, call_end = spans[0][2], spans[0][3]
    for name, parent, start, end in spans:
        assert call_start <= start <= end <= call_end, name
        if name in PARENT:
            assert parent == PARENT[name], name
        elif name == "host.affine":
            assert parent in AFFINE_STAGES
        elif name.startswith("msm."):
            assert parent in AFFINE_STAGES or parent.startswith("msm."), name
    # five affine conversions: a, b1 and l in one stage, then b2 and h
    assert [p for n, p, _, _ in spans if n == "host.affine"] == (
        ["stage.msm_ab1l"] * 3 + ["stage.msm_b2", "stage.msm_h"])
    # the facade's checks and inputs, the padding, the witness, its public
    # wires read between two stages, the other stages, then the values
    # built from those wires
    order = [n for n, p, _, _ in spans if p == "rln.generate_proofs"]
    assert order == ["facade.validate", "facade.inputs", "prover.pad", "stage.witness_eval",
                     "host.public", "stage.qap_witness_map", "stage.from_mont",
                     "stage.msm_ab1l", "stage.msm_b2", "stage.msm_h", "stage.host_assembly",
                     "facade.values"]


def test_facade_spans_on_a_cpu_profile(recorded_call, monkeypatch, tmp_path):
    """The facade's ranges as profiling.trace records them, the prover's
    batch left out (its ranges are torch.profiler's record_function too)."""
    rln, ws = recorded_call[:2]
    values = [proof_values_from_witness(w) for w in ws]
    publics = [rln_public_inputs(v) for v in values]
    monkeypatch.setattr(rln.prover, "prove_batch_public",
                        lambda named, rs, ss, metrics: ([None] * len(rs), publics))
    with prof.trace(str(tmp_path), device="cpu") as p:
        out = rln.generate_proofs(ws)
    assert out == [(None, v) for v in values]
    ev = {}
    for e in p.events():
        if e.name in FACADE | {"rln.generate_proofs"}:
            assert e.name not in ev
            ev[e.name] = (e.time_range.start, e.time_range.end)
    assert set(ev) == FACADE | {"rln.generate_proofs"}
    call = ev["rln.generate_proofs"]
    assert all(call[0] <= ev[n][0] <= ev[n][1] <= call[1] for n in FACADE)
    assert ev["facade.validate"][1] <= ev["facade.inputs"][0]
    assert ev["facade.inputs"][1] <= ev["facade.values"][0]


def test_no_profiler_no_range_and_the_same_stages(monkeypatch, tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert type(prof.span("stage.x")).__name__ == "nullcontext"
    synced = []

    def sync(device=None):
        with prof.span("sync"):  # a range only while a profiler runs
            synced.append(device)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    metrics = prof.PipelineMetrics()
    for m in (metrics, None):
        with prof.stage_timer(m, "a", "cuda"):
            pass
        with prof.stage_timer(m, "b", "cpu"):
            pass
    assert synced == ["cuda", "cuda"] and set(metrics.stages) == {"a", "b"}
    assert metrics.report() == {"batch": 0, "stages": dict(sorted(metrics.stages.items())),
                                "counts": {}}
    with prof.trace(str(tmp_path), device="cpu") as p:
        with prof.stage_timer(metrics, "a", "cuda"):
            pass
    ev = {e.name: (e.time_range.start, e.time_range.end) for e in p.events()}
    # the closing synchronize runs inside the stage's range
    assert ev["stage.a"][0] <= ev["sync"][0] and ev["sync"][1] <= ev["stage.a"][1]
    assert len(synced) == 3 and set(metrics.stages) == {"a", "b"}


def test_only_the_roofline_ranges_start_with_msm():
    """Every span name in the package's source: msm.* are the six the
    roofline's denominator sums, witness.* and qap.* the ones the tools
    sum; every other name carries a prefix of its own."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "zerokit_tpu_torch", "**", "*.py"), recursive=True):
        with open(path) as f:
            names |= set(re.findall(r"span\(\s*f?\"([^\"]+)\"", f.read()))
    assert {n for n in names if n.startswith("msm.")} == MSM_RANGES
    assert {n for n in names if n.startswith(("witness.", "qap."))} == OTHER_RANGES
    assert FACADE | HOST <= names
    assert all(n.startswith(("rln.", "facade.", "prover.", "host.", "stage.", "parallel.",
                             "witness.", "qap.", "msm.", "partial.", "finish.")) for n in names), names


def _facade_idle_pct():
    return Manifest.load().reader("facade_idle_pct.batch")


def test_facade_idle_reader_on_a_synthetic_summary():
    read = _facade_idle_pct()
    trace = {"window_s": 2.0, "busy_s": 0.5, "ranges_s": {}, "device_ops": [],
             "idle_gaps": [["facade.values", 0.4], ["stage.host_assembly", 0.3],
                           ["facade.validate", 0.1], ["host: untraced python", 0.2],
                           ["rln.generate_proofs", 0.05]]}
    assert read({"trace": trace}) == pytest.approx(100.0 * 0.5 / 2.0)
    assert read({"trace": None}) is None and read({}) is None
    # a program without the facade's spans: nothing to read
    trace["idle_gaps"] = [["host: untraced python", 1.0]]
    assert read({"trace": trace}) is None


def test_summarize_names_a_gap_by_its_facade_range():
    window = "rlnbench.window"
    events = [
        _Ev(window, "CPU", 0, 100, annotation=True),
        _Ev("rln.generate_proofs", "CPU", 5, 95, annotation=True),
        _Ev("facade.values", "CPU", 10, 50, annotation=True),
        _Ev("aten::copy_", "CPU", 12, 14),
        _Ev("stage.witness_eval", "CPU", 55, 90, annotation=True),
        _Ev("kernel", "CUDA", 0, 5), _Ev("kernel", "CUDA", 60, 85),
        _Ev("kernel", "CUDA", 97, 98),
    ]
    summary = yardstick.summarize(_Prof(events), window)
    # each gap by the innermost range open at its middle: 5-60 (32.5) in
    # the public values, 85-97 (91) in the call after its last stage, 98-100
    # (99) after the call
    assert dict(summary["idle_gaps"]) == {"facade.values": pytest.approx(55e-6),
                                          "rln.generate_proofs": pytest.approx(12e-6),
                                          "host: untraced python": pytest.approx(2e-6)}
    assert _facade_idle_pct()({"trace": summary}) == pytest.approx(55.0)
