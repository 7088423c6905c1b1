"""Checkpointed large-batch proving jobs (failure detection + resume).

The north-star deployment proves thousands of witnesses as one job
(BASELINE.md "4096 concurrent RLN proofs"). A job that large must survive
preemption and transient device failures, so this runner:

  * splits the witness list into device-batch chunks,
  * proves chunk-by-chunk, persisting each chunk's proofs (byte-exact
    proof_v3 wire format) plus a manifest keyed by a digest of the witness
    list,
  * on restart with the same checkpoint dir + witness list, verifies the
    digest and resumes from the first missing chunk,
  * retries a failed chunk (transient compile/tunnel/device errors) a
    bounded number of times before surfacing the failure with the manifest
    intact — completed work is never lost.

The reference has no equivalent (rayon jobs are all-or-nothing in-process);
this is the SURVEY §5 "failure detection / batch checkpoint" subsystem
designed TPU-first. Mirrors the role of orbax-style step checkpoints for
training jobs, specialized to proof batches.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

from ..protocol import serialize as ser

MANIFEST = "manifest.json"


def _witness_digest(witnesses) -> str:
    h = hashlib.sha256()
    for w in witnesses:
        h.update(ser.rln_witness_to_bytes(w, False))
    return h.hexdigest()


class BatchJobError(RuntimeError):
    pass


class CheckpointedBatchProver:
    """Chunked, checkpointed batch proving over any RLN-shaped engine."""

    def __init__(
        self,
        rln,
        checkpoint_dir: str,
        chunk_size: int = 64,
        max_retries: int = 2,
        retry_backoff_s: float = 2.0,
    ):
        self.rln = rln
        self.dir = checkpoint_dir
        self.chunk_size = chunk_size
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        os.makedirs(checkpoint_dir, exist_ok=True)

    # -- manifest -----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    def _load_manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _write_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path())

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"chunk_{idx:06d}.bin")

    # -- chunk serde (proof_v3 wire bytes, length-prefixed) ------------------

    def _write_chunk(self, idx: int, results) -> None:
        payload = b""
        for proof, values in results:
            blob = ser.proof_v3_to_bytes(proof, values)
            payload += len(blob).to_bytes(8, "little") + blob
        tmp = self._chunk_path(idx) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._chunk_path(idx))

    def _read_chunk(self, idx: int):
        with open(self._chunk_path(idx), "rb") as f:
            data = f.read()
        out, off = [], 0
        while off < len(data):
            n = int.from_bytes(data[off : off + 8], "little")
            off += 8
            out.append(ser.bytes_to_proof_v3(data[off : off + n]))  # (proof, values)
            off += n
        return out

    # -- driver --------------------------------------------------------------

    def run(self, witnesses: Sequence, progress=None) -> List[Tuple[tuple, object]]:
        """Proves all witnesses, resuming any prior partial run. Returns
        [(proof, proof_values), ...] in witness order. `progress(done, total,
        stage)` is called after every chunk."""
        digest = _witness_digest(witnesses)
        n_chunks = (len(witnesses) + self.chunk_size - 1) // self.chunk_size
        manifest = self._load_manifest()
        if manifest is None or manifest.get("witness_digest") != digest:
            if manifest is not None:
                # different job in this dir: refuse rather than clobber
                if manifest.get("done_chunks"):
                    raise BatchJobError(
                        "checkpoint dir holds a different job "
                        f"(digest {manifest.get('witness_digest', '?')[:12]}...); "
                        "use a fresh dir or clear it"
                    )
            manifest = {
                "witness_digest": digest,
                "n_witnesses": len(witnesses),
                "chunk_size": self.chunk_size,
                "done_chunks": [],
                "failures": [],
            }
            self._write_manifest(manifest)
        if manifest["chunk_size"] != self.chunk_size:
            raise BatchJobError("chunk_size differs from the checkpointed job")

        done = set(manifest["done_chunks"])
        results: List = [None] * len(witnesses)
        for idx in sorted(done):
            chunk = self._read_chunk(idx)
            start = idx * self.chunk_size
            for k, pv in enumerate(chunk):
                results[start + k] = pv

        for idx in range(n_chunks):
            if idx in done:
                continue
            start = idx * self.chunk_size
            batch = list(witnesses[start : start + self.chunk_size])
            attempt = 0
            while True:
                try:
                    chunk_results = self.rln.generate_proofs(batch)
                    break
                except Exception as e:  # device/compile/transport failure
                    attempt += 1
                    manifest["failures"].append(
                        {
                            "chunk": idx,
                            "attempt": attempt,
                            "error": f"{type(e).__name__}: {e}",
                            "ts": time.time(),
                        }
                    )
                    self._write_manifest(manifest)
                    if attempt > self.max_retries:
                        raise BatchJobError(
                            f"chunk {idx} failed after {attempt} attempts; "
                            f"completed chunks remain in {self.dir}"
                        ) from e
                    time.sleep(self.retry_backoff_s * attempt)
            self._write_chunk(idx, chunk_results)
            manifest["done_chunks"].append(idx)
            self._write_manifest(manifest)
            for k, pv in enumerate(chunk_results):
                results[start + k] = pv
            if progress is not None:
                progress(len(manifest["done_chunks"]), n_chunks, f"chunk {idx}")
        return results
