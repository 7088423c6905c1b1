"""Stand-ins for the program under test, for driving a run on the CPU: the
plain reference in the program's place (sound), and the faults a closed
cell can have, planted in it."""

from __future__ import annotations

import os

from rlnbench.manifest import ROOT
from rlnbench.reference import jobs, msm
from rlnbench.reference.wire import values_from_public
from rlnbench.traffic import named_inputs


class _Metrics:
    def __init__(self):
        self.stages = {}


class ReferenceProgram:
    """The reference in the program's place: every call proves each witness
    by the plain reference at the witness's own (r, s)."""

    metrics_type = _Metrics

    def __init__(self, config: dict):
        self.config = config
        jobs.init(os.path.join(ROOT, config["zkey"]), os.path.join(ROOT, config["graph"]),
                  config["tree_depth"], config["max_out"])

    def warm_up(self):
        pass

    def prepare(self, ws):
        return ws

    def call(self, ws, metrics=None):
        out = []
        for w in ws:
            res = jobs.prove_job({"named": named_inputs(w), "r": w["r"], "s": w["s"]})
            out.append((res["proof"], values_from_public(res["public"], self.config["public_inputs"],
                                                             self.config["max_out"])))
        return out

    @staticmethod
    def answers(out):
        return out


class HalfBatchProgram(ReferenceProgram):
    """Proves the first half of each batch and answers the second half with
    the first half's proofs."""

    def call(self, ws, metrics=None):
        half = super().call(ws[:max(1, len(ws) // 2)])
        return [half[i % len(half)] for i in range(len(ws))]


class AlteredAnswerProgram(ReferenceProgram):
    """Every proof's C moved by the generator of G1 where it is produced."""

    def call(self, ws, metrics=None):
        return [((a, b, msm.sum_points([c, (1, 2)])), v) for (a, b, c), v in super().call(ws)]


MEMBER = ("identity_secret", "user_message_limit", "path_elements", "identity_path_index")


class PooledProgram(ReferenceProgram):
    """The reference in the program's place for traffic with `members`:
    takes the pool (root epoch 0) in set-up and keeps each member's fields
    by (member, epoch); a lane in an epoch it has not seen takes them from
    its witness, as a deployment does a member's work again for a new root.
    Proves each lane from the kept fields and the message's own, and
    appends what the loop called, in order, to the file the configuration
    names under "events"."""

    def members(self, pool):
        self.kept = {(k, 0): m for k, m in enumerate(pool)}
        self._event("members", len(pool))

    def warm_up(self):
        self._event("warm_up", len(getattr(self, "kept", {})))

    def call(self, ws, metrics=None):
        return super().call([{**w, **self._kept(w)} for w in ws], metrics)

    def _kept(self, w):
        key = (w["member"], w["epoch"])
        if key not in self.kept:
            self.kept[key] = {f: w[f] for f in MEMBER}
        return self.kept[key]

    def _event(self, name, count):
        with open(self.config["events"], "a") as f:
            f.write(f"{name} {count}\n")


class AlteredPooledProgram(PooledProgram):
    """PooledProgram with every proof's C moved by the generator of G1."""

    def call(self, ws, metrics=None):
        return [((a, b, msm.sum_points([c, (1, 2)])), v) for (a, b, c), v in super().call(ws)]


class StalePooledProgram(PooledProgram):
    """PooledProgram that keeps each member's epoch-0 fields after the root
    has changed: work done for a path that no longer holds."""

    def _kept(self, w):
        return self.kept[(w["member"], 0)]
