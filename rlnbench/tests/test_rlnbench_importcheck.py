"""The import check compares top-level module names whole: the port's
name begins with the JAX package's and is not it. Nothing the benchmark
runs loads JAX or the JAX package, and the reference loads nothing of the
port."""

import glob
import os
import subprocess
import sys

import pytest

from rlnbench.manifest import HERE, ROOT
from rlnbench.run import forbidden_modules

PROGRAMS = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(HERE, "programs",
                                                                           "*.py")))


def test_top_level_names_compared_whole():
    names = ["zerokit_tpu_torch", "zerokit_tpu_torch.api", "zerokit_tpuX", "jaxtyping",
             "numpy", "jax_extra", "flaxen"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["zerokit_tpu.api", "jaxlib.xla_client", "jax", "flax"]) == [
        "flax", "jax", "jaxlib", "zerokit_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


@pytest.mark.parametrize("modules", [
    "rlnbench.run rlnbench.loops rlnbench.check rlnbench.program rlnbench.serve_child "
    "rlnbench.sweep rlnbench.control rlnbench.yardstick",
])
def test_the_harness_loads_no_jax(modules):
    """Every module of the harness, and every program a configuration can
    name (programs/*.py, loaded as the closed loop loads them)."""
    code = "\n".join(f"import {m}" for m in modules.split())
    code += "\nfrom rlnbench.manifest import Manifest\n"
    code += "".join(f"Manifest.load().program({p!r})\n" for p in PROGRAMS)
    loaded = _loaded(code)
    assert forbidden_modules(loaded) == []


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import rlnbench.reference.jobs, rlnbench.reference.wire, rlnbench.check")
    tops = {name.split(".")[0] for name in loaded}
    assert "zerokit_tpu_torch" not in tops and "torch" not in tops
    assert forbidden_modules(loaded) == []
