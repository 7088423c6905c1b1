"""The system under test, as the closed loop drives it: the port's RLN
facade over one configuration's circuit, on the card.

This is the only module of the benchmark's own process that imports the
port. It builds the engine through the port's public readers and facade,
turns the generator's raw witness fields into the port's witness type
before a call's clock starts, and hands back each proof with its public
values as a plain dict.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from .manifest import ROOT


class Program:
    def __init__(self, config: dict, device: str = "cuda"):
        from zerokit_tpu_torch import RLN
        from zerokit_tpu_torch.circuit.graph import graph_from_bytes
        from zerokit_tpu_torch.circuit.zkey import zkey_from_bytes
        from zerokit_tpu_torch.protocol.witness import RLNWitnessInput
        from zerokit_tpu_torch.runtime.profiling import PipelineMetrics

        with open(os.path.join(ROOT, config["zkey"]), "rb") as f:
            zkey = zkey_from_bytes(f.read())
        with open(os.path.join(ROOT, config["graph"]), "rb") as f:
            graph = graph_from_bytes(f.read(), config["tree_depth"], config["max_out"])
        self.rln = RLN(zkey, graph, device=device)
        self._witness_type = RLNWitnessInput
        self.metrics_type = PipelineMetrics

    def warm_up(self) -> None:
        """The prover's own warm-up: the MSMs' window tables and a first
        batch through every kernel."""
        self.rln.prover.warm_up()

    def prepare(self, ws: List[Dict]) -> Tuple[list, List[int], List[int]]:
        W = self._witness_type
        objs = []
        for w in ws:
            common = (w["identity_secret"], w["user_message_limit"])
            if "message_id" in w:
                objs.append(W.new_single(*common, w["message_id"], w["path_elements"],
                                         w["identity_path_index"], w["x"],
                                         w["external_nullifier"]))
            else:
                objs.append(W.new_multi(*common, w["message_ids"], w["path_elements"],
                                        w["identity_path_index"], w["x"],
                                        w["external_nullifier"], w["selector_used"]))
        return objs, [w["r"] for w in ws], [w["s"] for w in ws]

    def call(self, prepared, metrics=None):
        objs, rs, ss = prepared
        return self.rln.generate_proofs(objs, rs, ss, metrics=metrics)

    @staticmethod
    def answers(out) -> List[Tuple[tuple, dict]]:
        return [(proof, dict(vars(values))) for proof, values in out]
