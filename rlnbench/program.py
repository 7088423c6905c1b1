"""The system under test, as the closed loop drives it: the port's RLN
facade over one configuration's circuit, on the card.

This module and programs/<name>.py, the program a configuration names, are
the only modules of the benchmark's own process that import the port. This
one builds the engine through the port's public readers and facade, turns
the generator's raw witness fields into the port's witness type before a
call's clock starts, and hands back each proof with its public values as a
plain dict.

What the closed loop (loops.closed) relies on, in every program:

    Program(config)          built in set-up from the configuration's dict
    members(pool)            optional: called once, before warm_up, where the
                             traffic has `members`, with traffic.members()'s
                             list, the pool in root epoch 0; work a deployment
                             does once a member and root goes here, inside
                             setup_s. Each raw witness names its "member" and
                             "epoch": when the epoch moves, every member's
                             path changes, and work kept for the old path is
                             done again in the window
    warm_up()                set-up's own work, before a first call
    prepare(raw)             a call's raw witnesses (traffic.witnesses) made
                             into the program's inputs, before its clock
    call(prepared, metrics)  one timed call; metrics is a metrics_type() or
                             None (the traced segment)
    answers(out)             a call's result as [(proof, values dict)], one a
                             lane, which the check compares
    metrics_type             a class whose instances carry `stages`, a dict
                             of stage name to seconds that the stage readers
                             (metrics/*_ms.batch.py) read
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
