"""BENCHMARK.json against the contract's names, units and keys, and each
configuration file against the circuit artifacts it names."""

import json
import os
import re
from typing import List

import pytest

from rlnbench.manifest import HERE, ROOT, Manifest
from rlnbench.reference import prover as ref

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
END_TO_END_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}


def problems(data: dict) -> List[str]:
    """What in a BENCHMARK.json breaks the names, units and keys the
    benchmark's contract allows; empty if nothing does."""
    out = []
    names = [c["name"] for c in data["configs"]] + [w["name"] for w in data["workloads"]]
    metrics = data["end_to_end"] + data["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names + [w["config"] for w in data["workloads"]] + [
            w["traffic"] for w in data["workloads"]] + [
            k for c in data["configs"] for k in c["reduced"]]:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for group in (data["configs"], data["workloads"], metrics):
        seen = [g["name"] for g in group]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate names in {seen}")
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"]: m for m in data["end_to_end"]}
    for m in data["end_to_end"]:
        if set(m) - END_TO_END_KEYS:
            out.append(f"{m['name']}: keys {sorted(set(m) - END_TO_END_KEYS)}")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in data["per_layer"]:
        if set(m) - LAYER_KEYS or not {"layer", "moves", "workloads"} <= set(m):
            out.append(f"{m['name']}: keys {sorted(m)}")
            continue
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']}")
        reports = set(e2e.get(m["moves"], {}).get("workloads", cells))
        for w in m["workloads"]:
            if w not in cells or w not in reports:
                out.append(f"{m['name']}: cell {w} does not report {m['moves']}")
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']}")
        if m["source"] not in ("device_trace", "program_span", "program_counter", "host_clock"):
            out.append(f"{m['name']}: source {m['source']}")
    for text in ([c["why"] for c in data["configs"]] + [w["why"] for w in data["workloads"]]
                 + [m["layer"] for m in data["per_layer"]] + [c["source"] for c in data["configs"]]
                 + list(data["command"])):
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            out.append(f"bad text {text!r}")
    return out


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keeps_the_contract(data):
    assert problems(data) == []
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["paths"] == ["rlnbench"]
    assert {m["name"] for m in data["end_to_end"]} == {"proofs_per_s", "setup_s"}
    assert all(w["chips"] == 1 for w in data["workloads"])


def test_every_metric_names_its_layer_moves_and_cells(data):
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    for m in data["per_layer"]:
        assert m["layer"] and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer metric
        man = Manifest(data)
        assert len(man.metrics_for(cell, False)) >= 2
        assert man.metrics_for(cell, True)


def test_a_bad_name_or_unit_is_found(data):
    bad = json.loads(json.dumps(data))
    bad["per_layer"][0]["unit"] = "proofs per s"
    bad["workloads"][0]["name"] = "a,b"
    found = problems(bad)
    assert any("unit" in p for p in found) and any("a,b" in p for p in found)


def missing_programs(man: Manifest) -> List[str]:
    """The programs that a configuration of the manifest names under
    "program" and that have no file programs/<name>.py."""
    out = []
    for c in man.data["configs"]:
        name = man.config(c["name"]).get("program")
        if name is not None and not os.path.exists(os.path.join(man.base, "programs",
                                                                f"{name}.py")):
            out.append(f"{c['name']}: no programs/{name}.py")
    return out


def test_a_named_program_has_its_file(data, small_bench):
    assert missing_programs(Manifest(data)) == []
    man, bench, base = small_bench
    cfg = json.loads((base / "configs" / "rln-v2-depth10.json").read_text())
    cfg.update(name="named", program="standin-named")
    (base / "configs" / "named.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "named", "source": "https://example.org", "file":
                             str(base / "configs" / "named.json"), "reduced": [], "why": "test"})
    assert missing_programs(man) == ["named: no programs/standin-named.py"]
    (base / "programs").mkdir()
    (base / "programs" / "standin-named.py").write_text(
        "from rlnbench.tests.standins import ReferenceProgram as Program\n")
    assert missing_programs(man) == []
    assert man.program("standin-named").__name__ == "ReferenceProgram"


def pools_without_a_root(man: Manifest) -> List[str]:
    """The cells whose traffic keeps a pool of `members` and gives no
    positive `root_every`: a pool whose root never changes."""
    out = []
    for w in man.data["workloads"]:
        t = man.traffic(w["traffic"])
        every = t.get("root_every")
        if t.get("members") and not (isinstance(every, int) and every >= 1):
            out.append(f"{w['name']}: members without root_every")
    return out


def test_a_pool_of_members_has_a_root_epoch(data, small_bench):
    assert pools_without_a_root(Manifest(data)) == []
    man, bench, base = small_bench
    bench["workloads"].append({"name": "pooled", "config": "rln-v2-depth10",
                               "traffic": "closed-pool", "chips": 1, "why": "test"})
    for every, found in ((None, 1), (0, 1), (64, 0)):
        t = {"loop": "closed", "batch": 4, "members": 16}
        if every is not None:
            t["root_every"] = every
        (base / "traffic" / "closed-pool.json").write_text(json.dumps(t))
        assert pools_without_a_root(man) == ["pooled: members without root_every"] * found


@pytest.mark.parametrize("name", ["rln-v2-depth20", "rln-multi-msg-depth20-maxout4"])
def test_config_counts_are_the_artifacts(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    c = ref.load_circuit(os.path.join(ROOT, cfg["zkey"]), os.path.join(ROOT, cfg["graph"]),
                         cfg["tree_depth"], cfg["max_out"])
    pk, m = c.zkey.pk, c.zkey.matrices

    def finite(q):
        return sum(p is not None for p in q)

    assert cfg["wires"] == len(pk.a_query)
    assert cfg["graph_nodes"] == len(c.graph.nodes)
    assert cfg["constraints"] == m.num_constraints
    assert cfg["msm_points"] == {"a": finite(pk.a_query), "b1": finite(pk.b_g1_query),
                                 "b2": finite(pk.b_g2_query), "l": finite(pk.l_query),
                                 "h": finite(pk.h_query)}
    width = {"ys": cfg["max_out"], "nullifiers": cfg["max_out"], "selector_used": cfg["max_out"]}
    assert sum(width.get(n) or 1 for n in cfg["public_inputs"]) == m.num_instance_variables - 1
