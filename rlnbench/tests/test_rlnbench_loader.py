"""The loader finds a configuration, a traffic mix and a metric by file
name, also ones added in another folder; a new cell needs new files and an
entry only."""

import json

from rlnbench import run
from rlnbench.manifest import Manifest
from rlnbench.tests.standins import ReferenceProgram


def test_finds_files_by_name():
    man = Manifest.load()
    assert man.config("rln-v2-depth20")["tree_depth"] == 20
    assert man.traffic("closed-b256")["batch"] == 256
    assert man.reader("serve_lanes_per_batch.serve")(
        {"counters": {"total_proofs": 30, "total_batches": 3}}) == 10
    assert man.reader("witness_ms.batch")({"calls": []}) is None


def test_finds_files_added_in_another_folder(small_bench):
    man, data, base = small_bench
    assert man.config("rln-v2-depth10")["tree_depth"] == 10
    assert man.traffic("closed-b2")["batch"] == 2
    assert man.cell("v2d10-b2").traffic == "closed-b2"


def test_a_new_cell_and_metric_need_only_files(small_bench, capsys):
    man, data, base = small_bench
    (base / "metrics" / "calls_seen.test.py").write_text(
        "def read(ctx):\n    return len(ctx['calls'])\n")
    data["per_layer"].append({"name": "calls_seen.test", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "facade",
                              "moves": "proofs_per_s", "workloads": ["v2d10-b2"]})
    rc = run.main(["--workload", "v2d10-b2", "--seed", "4294967311", "--seconds", "0.01",
                   "--trace", "1"], make_program=ReferenceProgram, on_card=False, manifest=man)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"] == {"calls_seen.test": {"value": 1, "unit": "calls"}}
    assert list(line)[-1] == "check"
