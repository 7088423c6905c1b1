"""BENCHMARK.json and the files it names.

Every configuration, traffic mix, per-layer metric and program is a file of
its own, found by its name: configs/<name>.json, traffic/<name>.json,
metrics/<name>.py and programs/<name>.py under this folder (or under the
folder a test gives). A configuration names its program under "program";
without that key the closed loop drives program.py's Program. A new cell
needs new files (configurations, traffic, metrics, programs) and a new
entry in BENCHMARK.json, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Manifest:
    def __init__(self, data: dict, base: str = HERE):
        """data: the parsed BENCHMARK.json; base: the folder that holds
        configs/, traffic/, metrics/ and programs/."""
        self.data = data
        self.base = base

    @classmethod
    def load(cls, path: Optional[str] = None, base: str = HERE) -> "Manifest":
        with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
            return cls(json.load(f), base)

    def cell(self, name: str) -> Cell:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> str:
        for c in self.data["configs"]:
            if c["name"] == name:
                return os.path.join(ROOT, c["file"])
        return os.path.join(self.base, "configs", f"{name}.json")

    def config(self, name: str) -> dict:
        return _json(self.config_path(name))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.base, "traffic", f"{name}.json"))

    def metrics_for(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on), in the manifest's order."""
        out = []
        for m in self.data["per_layer" if trace else "end_to_end"]:
            if "workloads" not in m or cell in m["workloads"]:
                out.append(m)
        return out

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        """The read(ctx) function of metrics/<metric>.py."""
        return _load(self.base, "metrics", metric).read

    def program(self, name: str) -> Callable[[dict], object]:
        """The Program class of programs/<name>.py: a closed loop's system
        under test, built from the configuration (program.py says what the
        loop calls on it)."""
        return _load(self.base, "programs", name).Program


def _load(base: str, kind: str, name: str):
    """The module in <base>/<kind>/<name>.py, loaded from its file."""
    path = os.path.join(base, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"rlnbench_{kind}_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
