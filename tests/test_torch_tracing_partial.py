"""The port's spans and counters of two-phase proving.

RLN.generate_partial_proofs and RLN.finish_proofs of two members on the
depth-10 circuit, on the CPU, with profiling.span() recording through
tests/test_torch_tracing.py's stand-in for record_function, and the MSMs
over their first window only (the proofs are not checked here; tests/
test_torch_partial_batch.py holds them). Each call opens its own spans
inside it, its stage.* spans name exactly the stages PipelineMetrics
records, the MSM ranges inside the subset MSMs are the msm.* ranges the
roofline reads, and the counters say how many partials and finishes were
made and how many finite points the finish walked.
"""

import functools

import pytest
import torch

from test_torch_tracing import MSM_RANGES, Ranges
from zerokit_tpu_torch import RLN, RLNWitnessInput, hash_to_field_le
from zerokit_tpu_torch.groth16 import prover as prover_mod
from zerokit_tpu_torch.groth16.msm import MSM
from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput
from zerokit_tpu_torch.resources import load_resource
from zerokit_tpu_torch.runtime import profiling as prof

torch.set_num_threads(1)

PARTIAL = {"partial_witness", "partial_msm"}
FINISH = {"witness_eval", "qap_witness_map", "from_mont", "msm_finish", "msm_h", "host_assembly"}


@pytest.fixture(scope="module")
def recorded_calls():
    """(RLN, the partial call's Ranges and PipelineMetrics, the finish
    call's) of two members."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(prover_mod, "MSM", functools.partial(MSM, n_windows=1))
        rln = RLN.stateless(device="cpu",
                            zkey_bytes=load_resource("tree_depth_10/rln_final.arkzkey"),
                            graph_bytes=load_resource("tree_depth_10/graph.bin"))
        depth = rln.tree_depth()
        ws = [RLNWitnessInput.new_single(hash_to_field_le(b"member %d" % i), 5, i,
                                         [hash_to_field_le(bytes([i, j])) for j in range(depth)],
                                         [(i + j) & 1 for j in range(depth)],
                                         hash_to_field_le(b"signal %d" % i),
                                         hash_to_field_le(b"epoch"))
              for i in range(2)]
        mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        out = []
        for run in ("partial", "finish"):
            ranges, metrics = Ranges(), prof.PipelineMetrics()
            mp.setattr(torch.profiler, "record_function", ranges.record_function)
            if run == "partial":
                partials = rln.generate_partial_proofs(
                    [RLNPartialWitnessInput.from_witness(w) for w in ws], metrics=metrics)
            else:
                rln.finish_proofs(partials, ws, metrics=metrics)
            assert not ranges.open
            out.append((ranges, metrics))
    finally:
        mp.undo()
    return rln, out[0], out[1]


def _names(ranges):
    return {name for name, *_ in ranges.spans}


def test_a_partial_call_names_its_phases(recorded_calls):
    rln, (ranges, metrics), _ = recorded_calls
    names = _names(ranges)
    assert ranges.spans[0][:2] == ["rln.generate_partial_proofs", None]
    assert set(metrics.stages) == PARTIAL
    assert {n for n in names if n.startswith("stage.")} == {"stage." + s for s in PARTIAL}
    assert {"partial.witness", "partial.msm", "witness.eval"} <= names
    assert {n for n in names if n.startswith("msm.")} == MSM_RANGES
    assert metrics.counts == {"partials_made": 2}
    parents = {name: parent for name, parent, *_ in ranges.spans}
    assert parents["partial.witness"] == "stage.partial_witness"
    assert parents["partial.msm"] == "stage.partial_msm"


def test_a_finish_call_names_its_phases_and_counts_its_points(recorded_calls):
    rln, _, (ranges, metrics) = recorded_calls
    names = _names(ranges)
    assert ranges.spans[0][:2] == ["rln.finish_proofs", None]
    assert set(metrics.stages) == FINISH
    assert {n for n in names if n.startswith("stage.")} == {"stage." + s for s in FINISH}
    assert {n for n in names if n.startswith("msm.")} == MSM_RANGES
    assert "finish.sum" in names and "host.public" in names
    parents = {(name, parent) for name, parent, *_ in ranges.spans if name == "finish.sum"}
    assert parents == {("finish.sum", "stage.msm_finish")}
    prover = rln.prover
    assert metrics.counts == {"finish_lanes": 2, "finish_points_g1eq": 2 * prover.finish_points()}
    unknown = prover._split()[1]
    assert prover.finish_points() == unknown.points_g1eq + prover.h_points
