"""A closed cell whose configuration names its own program and whose
traffic keeps a standing pool of members runs from new files and a new
entry alone: the loop builds the named program (programs/<name>.py), hands
it the pool once before its warm-up, and the check draws each sampled
witness again, member, root epoch and message, and judges the program's
answer: a program that keeps a member's work past a change of the root
reads false."""

import json

import pytest

from rlnbench import run


@pytest.mark.parametrize("program, correct", [
    ("PooledProgram", True),
    ("AlteredPooledProgram", False),
    ("StalePooledProgram", False),
])
def test_a_named_program_over_a_pool_of_members(small_bench, capsys, program, correct):
    man, data, base = small_bench
    events = base / "events.txt"
    (base / "programs").mkdir()
    (base / "programs" / "standin-pooled.py").write_text(
        f"from rlnbench.tests.standins import {program} as Program\n")
    cfg = json.loads((base / "configs" / "rln-v2-depth10.json").read_text())
    cfg.update(name="rln-v2-depth10-pooled", program="standin-pooled", events=str(events))
    (base / "configs" / "rln-v2-depth10-pooled.json").write_text(json.dumps(cfg))
    (base / "traffic" / "closed-b4-m3.json").write_text(
        json.dumps({"loop": "closed", "batch": 4, "members": 3, "root_every": 2,
                    "trace_calls": 1}))
    data["workloads"].append({"name": "v2d10-pooled", "config": "rln-v2-depth10-pooled",
                              "traffic": "closed-b4-m3", "chips": 1,
                              "why": "a closed cell with its own program, a pool of 3, a root a pair"})
    rc = run.main(["--workload", "v2d10-pooled", "--seed", "6000000101", "--seconds", "0.01",
                   "--trace", "0"], on_card=False, manifest=man)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert line["attempted"] == 4 and line["failed"] == 0
    assert events.read_text().splitlines() == ["members 3", "warm_up 3"]
