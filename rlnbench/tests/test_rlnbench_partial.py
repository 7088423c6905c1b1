"""The partial/finish cell (v2d20-partial-b256) on the CPU: programs/partial.py
makes a member's partial proof again exactly when its (member, root epoch)
moves or the lane's path differs from the one its partial was made from,
in set-up for the pool and never in prepare; over the plain two-phase
reference it reads correct through the whole run. The partial
configuration's counts are the artifacts', recounted by the reference,
and the reference's two-phase prover loads nothing of the port or JAX."""

import json
import os

import pytest

from rlnbench import run
from rlnbench import traffic as gen
from rlnbench.manifest import HERE, ROOT, Manifest
from rlnbench.reference import partial as ref_partial
from rlnbench.reference import prover as ref
from rlnbench.run import forbidden_modules
from rlnbench.tests.standins_partial import CountingPartialProgram
from rlnbench.tests.test_rlnbench_importcheck import _loaded

SEED = 6000000521


def test_partials_are_made_again_when_the_member_epoch_or_path_moves(small_bench):
    man, _, _ = small_bench
    cfg = man.config("rln-v2-depth10")
    traffic = {"loop": "closed", "batch": 4, "members": 3, "root_every": 8}
    prog = CountingPartialProgram(cfg)
    prog.members(gen.members(cfg, traffic, SEED))
    assert prog.rln.made == [3]

    def call(index, tamper=None):
        ws = gen.witnesses(cfg, traffic, SEED, "window", index, 4)
        if tamper is not None:
            ws[tamper] = {**ws[tamper], "path_elements": [v + 1 for v in ws[tamper]["path_elements"]]}
        prepared = prog.prepare(ws)
        before = list(prog.rln.made)
        prog.call(prepared)
        return [(w["member"], w["epoch"]) for w in ws], prog.rln.made[len(before):]

    prog.prepare(gen.witnesses(cfg, traffic, SEED, "window", 2, 4))
    assert prog.rln.made == [3]  # prepare makes none
    assert call(0) == ([(0, 0), (1, 0), (2, 0), (0, 0)], [])
    assert call(1) == ([(1, 0), (2, 0), (0, 0), (1, 0)], [])
    # messages 8-11: the root changed, every member's path with it
    assert call(2) == ([(2, 1), (0, 1), (1, 1), (2, 1)], [3])
    assert call(3) == ([(0, 1), (1, 1), (2, 1), (0, 1)], [])
    # a lane whose path is not the one its held partial was made from
    assert call(3, tamper=1) == ([(0, 1), (1, 1), (2, 1), (0, 1)], [1])
    assert call(3) == ([(0, 1), (1, 1), (2, 1), (0, 1)], [1])
    # the partials of an earlier root stay held (the traced segment's epoch 0)
    assert call(0) == ([(0, 0), (1, 0), (2, 0), (0, 0)], [])


def test_the_partial_program_over_the_reference_reads_correct(small_bench, capsys):
    man, data, base = small_bench
    (base / "programs").mkdir()
    (base / "programs" / "standin-partial.py").write_text(
        "from rlnbench.tests.standins_partial import ReferencePartialProgram as Program\n")
    cfg = json.loads((base / "configs" / "rln-v2-depth10.json").read_text())
    cfg.update(name="rln-v2-depth10-partial", program="standin-partial")
    (base / "configs" / "rln-v2-depth10-partial.json").write_text(json.dumps(cfg))
    (base / "traffic" / "closed-b2-m2.json").write_text(
        json.dumps({"loop": "closed", "batch": 2, "members": 2, "root_every": 1,
                    "trace_calls": 1}))
    data["workloads"].append({"name": "v2d10-partial", "config": "rln-v2-depth10-partial",
                              "traffic": "closed-b2-m2", "chips": 1,
                              "why": "the partial program over the reference, a root a message"})
    rc = run.main(["--workload", "v2d10-partial", "--seed", str(SEED), "--seconds", "0.01",
                   "--trace", "0"], on_card=False, manifest=man)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] == 2 and line["failed"] == 0


def test_partial_configuration_counts_are_the_artifacts():
    with open(os.path.join(HERE, "configs", "rln-v2-depth20-partial.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "configs", "rln-v2-depth20.json")) as f:
        full = json.load(f)
    shared = ("zkey", "graph", "tree_depth", "max_out", "wires", "graph_nodes", "constraints",
              "qap_domain", "public_inputs")
    assert {k: cfg[k] for k in shared} == {k: full[k] for k in shared}
    assert cfg["assumed"]["user_message_limit"] == full["assumed"]["user_message_limit"]
    c = ref.load_circuit(os.path.join(ROOT, cfg["zkey"]), os.path.join(ROOT, cfg["graph"]),
                         cfg["tree_depth"], cfg["max_out"])
    w = gen.members(cfg, {"members": 1}, SEED)[0]
    named = {"identitySecret": [w["identity_secret"]], "userMessageLimit": [100],
             "messageId": [0], "pathElements": w["path_elements"],
             "identityPathIndex": w["identity_path_index"], "x": [0], "externalNullifier": [0]}
    known = [v is not None for v in ref_partial.partial_assignment(c, named)]
    pk, n = c.zkey.pk, c.num_inputs

    def finite(q, on):
        return sum(p is not None and k for p, k in zip(q, on))

    for side, counts in ((known, cfg["partial_points"]),
                         ([not k for k in known], cfg["msm_points"])):
        assert {k: v for k, v in counts.items() if k != "h"} == {
            "a": finite(pk.a_query, side), "b1": finite(pk.b_g1_query, side),
            "b2": finite(pk.b_g2_query, side), "l": finite(pk.l_query, side[n:])}
    assert cfg["msm_points"]["h"] == full["msm_points"]["h"]
    assert cfg["unknown_wires"] == known.count(False)
    assert cfg["assumed"]["root_every"] == Manifest.load().traffic("closed-partial-b256")[
        "root_every"]


@pytest.mark.parametrize("module", ["rlnbench.reference.partial"])
def test_the_partial_reference_loads_nothing_of_the_port(module):
    loaded = _loaded(f"import {module}")
    tops = {name.split(".")[0] for name in loaded}
    assert "zerokit_tpu_torch" not in tops and "torch" not in tops
    assert forbidden_modules(loaded) == []


def test_the_partial_program_loads_no_jax():
    loaded = _loaded("from rlnbench.manifest import Manifest\nManifest.load().program('partial')")
    assert forbidden_modules(loaded) == []
