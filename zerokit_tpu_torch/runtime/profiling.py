"""Per-stage wall-clock timing of the proving pipeline.

stage_timer records the seconds a stage takes into a PipelineMetrics. A
stage that ran on the card ends with torch.cuda.synchronize(), so its time
includes the device work it queued, not only the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class PipelineMetrics:
    stages: Dict[str, float] = field(default_factory=dict)
    batch: int = 0

    def record(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def report(self) -> dict:
        total = sum(self.stages.values())
        return {
            "batch": self.batch,
            "total_s": total,
            "proofs_per_sec": self.batch / total if total else None,
            "stages": dict(sorted(self.stages.items())),
        }

    def dumps(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def stage_timer(metrics: Optional[PipelineMetrics], name: str, device=None):
    """Times a stage. With a CUDA `device`, the stage ends with a
    torch.cuda.synchronize() on it before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        if metrics is not None:
            metrics.record(name, time.perf_counter() - t0)
