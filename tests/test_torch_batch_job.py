"""The port's checkpointed batch proving (zerokit_tpu_torch/runtime/batch_job.py)
on tests/test_batch_job.py's cases, and its checkpoints across packages.

The module is a verbatim copy (tests/test_torch_import.py); these cases run
it on the port's wire formats and witnesses with tests/test_batch_job.py's
stub engine: resume, failure retry, the digest guard. Then a checkpoint
directory written by either package resumes in the other, and the two
packages write the same manifest digest and chunk bytes.
"""

import json
import os

import pytest

import zerokit_tpu.protocol.witness as j_witness
import zerokit_tpu.runtime.batch_job as j_batch_job
from zerokit_tpu_torch import RLNWitnessInput, hash_to_field_le
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.runtime.batch_job import BatchJobError, CheckpointedBatchProver


class FlakyRLN:
    """Proves deterministically; fails the Nth chunk call `fail_times` times."""

    def __init__(self, fail_on_call=None, fail_times=1):
        self.calls = 0
        self.fail_on_call = fail_on_call
        self.fail_times = fail_times
        self._failed = 0

    def generate_proofs(self, witnesses):
        self.calls += 1
        if (
            self.fail_on_call is not None
            and self.calls >= self.fail_on_call
            and self._failed < self.fail_times
        ):
            self._failed += 1
            raise RuntimeError("simulated device failure")
        out = []
        for w in witnesses:
            k = (w.x % 97) + 1  # deterministic per witness
            proof = (
                bn254.G1.mul(bn254.G1_GENERATOR, k),
                bn254.G2.mul(bn254.G2_GENERATOR, k + 1),
                bn254.G1.mul(bn254.G1_GENERATOR, k + 2),
            )
            out.append((proof, proof_values_from_witness(w)))
        return out


def _witnesses(n):
    return [
        RLNWitnessInput.new_single(
            hash_to_field_le(b"cb-%d" % i), 10, 1, [0] * 20, [0] * 20,
            hash_to_field_le(b"x-%d" % i), 12345,
        )
        for i in range(n)
    ]


def test_full_run_and_resume(tmp_path):
    ws = _witnesses(10)
    rln = FlakyRLN()
    job = CheckpointedBatchProver(rln, str(tmp_path), chunk_size=4)
    results = job.run(ws)
    assert len(results) == 10 and all(r is not None for r in results)
    assert rln.calls == 3  # ceil(10/4) chunks

    # resume: nothing left to prove, identical results come off disk
    rln2 = FlakyRLN()
    job2 = CheckpointedBatchProver(rln2, str(tmp_path), chunk_size=4)
    results2 = job2.run(ws)
    assert rln2.calls == 0
    assert [pv.nullifier for _, pv in results2] == [pv.nullifier for _, pv in results]
    assert [p for p, _ in results2] == [p for p, _ in results]


def test_partial_failure_then_resume(tmp_path):
    ws = _witnesses(12)
    # chunk 3 (call 3) fails more times than retries allow
    rln = FlakyRLN(fail_on_call=3, fail_times=5)
    job = CheckpointedBatchProver(rln, str(tmp_path), chunk_size=4, max_retries=1, retry_backoff_s=0)
    with pytest.raises(BatchJobError):
        job.run(ws)

    # restart with a healthy engine: only the missing chunk is proved
    rln2 = FlakyRLN()
    job2 = CheckpointedBatchProver(rln2, str(tmp_path), chunk_size=4)
    results = job2.run(ws)
    assert all(r is not None for r in results)
    assert rln2.calls == 1  # chunks 0 and 1 came from the checkpoint


def test_transient_failure_retries(tmp_path):
    ws = _witnesses(8)
    rln = FlakyRLN(fail_on_call=1, fail_times=1)  # first call fails once
    job = CheckpointedBatchProver(rln, str(tmp_path), chunk_size=4, retry_backoff_s=0)
    results = job.run(ws)
    assert all(r is not None for r in results)
    import json, os

    manifest = json.load(open(os.path.join(str(tmp_path), "manifest.json")))
    assert manifest["failures"] and manifest["failures"][0]["chunk"] == 0


def test_digest_guard(tmp_path):
    ws = _witnesses(6)
    job = CheckpointedBatchProver(FlakyRLN(), str(tmp_path), chunk_size=4)
    job.run(ws)
    other = _witnesses(7)
    with pytest.raises(BatchJobError):
        CheckpointedBatchProver(FlakyRLN(), str(tmp_path), chunk_size=4).run(other)



def _jax_witnesses(n):
    return [
        j_witness.RLNWitnessInput.new_single(
            hash_to_field_le(b"cb-%d" % i), 10, 1, [0] * 20, [0] * 20,
            hash_to_field_le(b"x-%d" % i), 12345,
        )
        for i in range(n)
    ]


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """A run that stops after two of three chunks, in one package, is
    finished by the other from the same directory."""
    jobs = {
        "jax": (j_batch_job.CheckpointedBatchProver, j_batch_job.BatchJobError,
                _jax_witnesses(10)),
        "port": (CheckpointedBatchProver, BatchJobError, _witnesses(10)),
    }
    second = "port" if first == "jax" else "jax"
    cls, err, ws = jobs[first]
    with pytest.raises(err):
        cls(FlakyRLN(fail_on_call=3, fail_times=5), str(tmp_path), chunk_size=4,
            max_retries=0, retry_backoff_s=0).run(ws)
    cls2, _, ws2 = jobs[second]
    rln = FlakyRLN()
    results = cls2(rln, str(tmp_path), chunk_size=4).run(ws2)
    assert rln.calls == 1  # only the third chunk was proved
    want = FlakyRLN().generate_proofs(_witnesses(10))
    assert [p for p, _ in results] == [p for p, _ in want]
    assert [v.nullifier for _, v in results] == [v.nullifier for _, v in want]


def test_checkpoint_files_equal_across_packages(tmp_path):
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    j_batch_job.CheckpointedBatchProver(FlakyRLN(), str(j_dir), chunk_size=4).run(
        _jax_witnesses(9))
    CheckpointedBatchProver(FlakyRLN(), str(t_dir), chunk_size=4).run(_witnesses(9))
    j_files, t_files = _files(j_dir), _files(t_dir)
    j_manifest = json.loads(j_files.pop("manifest.json"))
    t_manifest = json.loads(t_files.pop("manifest.json"))
    assert t_files == j_files and len(t_files) == 3
    for key in ("witness_digest", "n_witnesses", "chunk_size", "done_chunks", "failures"):
        assert t_manifest[key] == j_manifest[key]
