"""Stand-ins for the port behind programs/partial.py, for driving it on the
CPU: its own keying of partial proofs runs unchanged, and the facade it
calls is a plain one that counts what it is asked for and, where it
proves, proves by the plain two-phase reference (reference/partial.py)."""

from __future__ import annotations

import os
from types import SimpleNamespace

from rlnbench.manifest import HERE, ROOT, _load
from rlnbench.reference import partial as ref_partial
from rlnbench.reference import prover as ref
from rlnbench.reference.wire import values_from_public

_partial = _load(HERE, "programs", "partial")
PartialProgram, member_fields = _partial.Program, _partial.member_fields


class _Metrics:
    def __init__(self):
        self.stages = {}


class CountingRLN:
    """A facade that proves nothing: a partial proof is what it was made
    from (and self.partial's); finish_proofs raises for a lane handed a partial of another
    member, root or path, and answers None. `made` lists the lanes of each
    generate_partial_proofs call."""

    def __init__(self, config: dict):
        self.config = config
        self.made = []

    def generate_partial_proofs(self, pws, metrics=None):
        self.made.append(len(pws))
        return [(member_fields(pw), self.partial(pw)) for pw in pws]

    def partial(self, pw):
        return None

    def finish_proofs(self, partials, objs, rs, ss, metrics=None):
        out = []
        for (fields, made), w, r, s in zip(partials, objs, rs, ss):
            if fields != member_fields(w):
                raise AssertionError("a lane was handed another member's or path's partial")
            out.append(self.finish(made, w, r, s))
        return out

    def finish(self, made, w, r, s):
        return None


class ReferenceRLN(CountingRLN):
    """CountingRLN whose partial proofs and finishes are the plain two-phase
    reference's, over the configuration's circuit."""

    def __init__(self, config: dict):
        super().__init__(config)
        self.circuit = ref.load_circuit(os.path.join(ROOT, config["zkey"]),
                                        os.path.join(ROOT, config["graph"]),
                                        config["tree_depth"], config["max_out"])

    def partial(self, pw):
        named = {"identitySecret": [pw.identity_secret], "userMessageLimit": [pw.user_message_limit],
                 "messageId": [0], "pathElements": list(pw.path_elements),
                 "identityPathIndex": list(pw.identity_path_index), "x": [0],
                 "externalNullifier": [0]}
        return ref_partial.partial(self.circuit, ref_partial.partial_assignment(self.circuit, named))

    def finish(self, made, w, r, s):
        z = ref.assignment(self.circuit, w.named_inputs())
        values = values_from_public(ref.public_inputs(self.circuit, z),
                                    self.config["public_inputs"], self.config["max_out"])
        return ref_partial.finish(self.circuit, made, z, r, s), SimpleNamespace(**values)


class CountingPartialProgram(PartialProgram):
    """programs/partial.py's Program over CountingRLN (no port prover)."""

    facade = CountingRLN

    def __init__(self, config: dict):
        from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput, RLNWitnessInput

        self.rln = self.facade(config)
        self._witness_type = RLNWitnessInput
        self._partial_type = RLNPartialWitnessInput
        self.metrics_type = _Metrics
        self.held = {}

    def warm_up(self):
        pass


class ReferencePartialProgram(CountingPartialProgram):
    """programs/partial.py's Program over the plain two-phase reference."""

    facade = ReferenceRLN
