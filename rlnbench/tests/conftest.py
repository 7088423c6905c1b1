"""pytest settings of the benchmark's own tests (run from the repo root:
python -m pytest rlnbench/tests -q). Tests marked `card` need a CUDA card
and skip without one; whether there is one is decided in the `card`
fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_bench(tmp_path):
    """A manifest over a copy of the benchmark's folders in tmp_path with one
    more configuration (the depth-10 RLN circuit), two more traffic mixes
    (a closed loop of 2, an open loop) and a cell for each, added as files
    and entries only. Returns (manifest, data, base)."""
    import json
    import shutil

    from rlnbench.manifest import HERE, ROOT, Manifest

    base = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(f"{HERE}/{sub}", base / sub)
    with open(f"{ROOT}/BENCHMARK.json") as f:
        data = json.load(f)
    with open(f"{HERE}/configs/rln-v2-depth20.json") as f:
        cfg = json.load(f)
    cfg.update(name="rln-v2-depth10", tree_depth=10,
               zkey="zerokit_tpu/resources/tree_depth_10/rln_final.arkzkey",
               graph="zerokit_tpu/resources/tree_depth_10/graph.bin")
    (base / "configs" / "rln-v2-depth10.json").write_text(json.dumps(cfg))
    (base / "traffic" / "closed-b2.json").write_text(
        json.dumps({"loop": "closed", "batch": 2, "trace_calls": 1}))
    (base / "traffic" / "open-test.json").write_text(
        json.dumps({"loop": "open", "rate_per_s": 4}))
    data["workloads"] += [
        {"name": "v2d10-b2", "config": "rln-v2-depth10", "traffic": "closed-b2", "chips": 1,
         "why": "a small closed cell for the CPU tests"},
        {"name": "v2d10-open", "config": "rln-v2-depth10", "traffic": "open-test", "chips": 1,
         "why": "a small open cell for the CPU tests"},
    ]
    for m in data["end_to_end"] + data["per_layer"]:
        for old, new in (("v2d20-b256", "v2d10-b2"), ("v2d20-serve", "v2d10-open")):
            if old in m.get("workloads", []):
                m["workloads"].append(new)
    return Manifest(data, str(base)), data, base
