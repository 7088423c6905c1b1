"""zerokit's two-phase proving as a node that proves for many members runs
it: each member's partial proof is made once while its root holds, and
each message pays only a finish (rln/src/partial_proof.rs:108-299,
rln-cli/src/examples/partial.rs: "cache partial proof, finish per
message").

The program the configuration rln-v2-depth20-partial names: program.py's
Program (the port's RLN facade over the configuration's circuit) with

    members(pool)   the pool's partial proofs at root epoch 0, in one
                    RLN.generate_partial_proofs call, inside setup_s
    prepare(raw)    the witnesses' types only, as program.py's, and each
                    lane's (member, epoch): no witness, hash or MSM
    call            a lane's partial proof is the one held for its (member,
                    epoch) if that was made from the lane's own identity
                    secret, limit and path; the lanes that have none get
                    one first, in one generate_partial_proofs call inside
                    the call's clock; then every lane through one
                    RLN.finish_proofs at its (r, s)

Partials stay held for every epoch the program has seen, so a traced
segment (stream "trace", root epoch 0) finishes only, and the
configuration's msm_points is its MSM work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from rlnbench.program import Program as FullProgram


def member_fields(w) -> Tuple:
    """What a partial proof is made from: the identity secret, the user
    message limit, the path and its index bits."""
    return (w.identity_secret, w.user_message_limit, tuple(w.path_elements),
            tuple(w.identity_path_index))


class Program(FullProgram):
    def __init__(self, config: dict, device: str = "cuda"):
        super().__init__(config, device)
        from zerokit_tpu_torch.protocol.witness import RLNPartialWitnessInput

        self._partial_type = RLNPartialWitnessInput
        self.held: Dict[Tuple[int, int], Tuple[Tuple, object]] = {}

    def members(self, pool: List[Dict]) -> None:
        new = self._partial_type.new
        pws = [new(m["identity_secret"], m["user_message_limit"], m["path_elements"],
                   m["identity_path_index"]) for m in pool]
        self._make({((k, 0), member_fields(pw)): pw for k, pw in enumerate(pws)})

    def prepare(self, ws: List[Dict]):
        objs, rs, ss = super().prepare(ws)
        return objs, [(w["member"], w["epoch"]) for w in ws], rs, ss

    def call(self, prepared, metrics=None):
        objs, keys, rs, ss = prepared
        fields = [member_fields(w) for w in objs]
        todo = {}
        for key, f, w in zip(keys, fields, objs):
            if self.held.get(key, (None,))[0] != f:
                todo.setdefault((key, f), self._partial_type.from_witness(w))
        made = self._make(todo, metrics) if todo else {}
        partials = [made[(key, f)] if (key, f) in made else self.held[key][1]
                    for key, f in zip(keys, fields)]
        return self.rln.finish_proofs(partials, objs, rs, ss, metrics=metrics)

    def _make(self, todo: Dict, metrics=None) -> Dict:
        """Partial proofs for {(key, fields): partial witness} in one call:
        each held by its key beside what it was made from, and returned by
        (key, fields)."""
        made = dict(zip(todo, self.rln.generate_partial_proofs(list(todo.values()),
                                                               metrics=metrics)))
        for (key, f), partial in made.items():
            self.held[key] = (f, partial)
        return made
