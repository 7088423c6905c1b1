"""zerokit_tpu_torch stands alone: no JAX, no zerokit_tpu, verbatim copies.

The port runs on hosts without JAX, so importing it (down to the prover and
its tools) must not pull in JAX, the JAX package or the repository's tools/.
The modules it copies from the JAX package must stay the same code: their
text equals the source once import lines are removed. Every module of the
JAX package has its counterpart module in the port, and every public
top-level def and class there a counterpart name, but for the removals and
renames listed below with their reasons (read from source text: no JAX
import).
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VERBATIM = [
    "constants.py",
    "hostmath/bn254.py",
    "hostmath/arkserde.py",
    "circuit/graph.py",
    "circuit/zkey.py",
    "circuit/witness_host.py",
    "groth16/setup.py",
    "groth16/verifier.py",
    "errors.py",
    "hash/grain.py",
    "hash/keccak.py",
    "hash/chacha.py",
    "protocol/identity.py",
    "protocol/keygen.py",
    "protocol/witness.py",
    "protocol/proof.py",
    "protocol/slashing.py",
    "protocol/serialize.py",
    "runtime/batch_job.py",
]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import zerokit_tpu_torch\n"
        "import zerokit_tpu_torch.groth16.prover\n"
        "import zerokit_tpu_torch.groth16.setup\n"
        "import zerokit_tpu_torch.circuit.witness_eval\n"
        "import zerokit_tpu_torch.circuit.witness_kernels\n"
        "import zerokit_tpu_torch.groth16.verifier\n"
        "import zerokit_tpu_torch.resources\n"
        "import zerokit_tpu_torch.runtime.profiling\n"
        "import zerokit_tpu_torch.tools.tc_mont_prototype\n"
        "import zerokit_tpu_torch.tools.microbench\n"
        "import zerokit_tpu_torch.tools.profile_batch\n"
        "import zerokit_tpu_torch.tools.profile_tree\n"
        "import zerokit_tpu_torch.tools.witness_graphs\n"
        "import zerokit_tpu_torch.tools.bench_components\n"
        "import zerokit_tpu_torch.tools.ntt_micro\n"
        "import zerokit_tpu_torch.tools.export_js_fixture\n"
        "import zerokit_tpu_torch.api\n"
        "import zerokit_tpu_torch.errors\n"
        "import zerokit_tpu_torch.hash.poseidon\n"
        "import zerokit_tpu_torch.hash.poseidon_kernels\n"
        "import zerokit_tpu_torch.hash.grain\n"
        "import zerokit_tpu_torch.hash.keccak\n"
        "import zerokit_tpu_torch.hash.chacha\n"
        "import zerokit_tpu_torch.tree.merkle\n"
        "import zerokit_tpu_torch.tree.batched\n"
        "import zerokit_tpu_torch.protocol.identity\n"
        "import zerokit_tpu_torch.protocol.keygen\n"
        "import zerokit_tpu_torch.protocol.witness\n"
        "import zerokit_tpu_torch.protocol.proof\n"
        "import zerokit_tpu_torch.protocol.slashing\n"
        "import zerokit_tpu_torch.protocol.serialize\n"
        "import zerokit_tpu_torch.tree.pmtree\n"
        "import zerokit_tpu_torch.runtime.batch_job\n"
        "import zerokit_tpu_torch.runtime.build\n"
        "import zerokit_tpu_torch.server\n"
        "import zerokit_tpu_torch.ffi_glue\n"
        "import zerokit_tpu_torch.cli._common\n"
        "import zerokit_tpu_torch.cli.relay\n"
        "import zerokit_tpu_torch.cli.stateless\n"
        "import zerokit_tpu_torch.cli.partial\n"
        "import zerokit_tpu_torch.cli.multi_message_id\n"
        "import zerokit_tpu_torch.parallel.sharded\n"
        "import zerokit_tpu_torch.parallel.ntt_sharded\n"
        "import zerokit_tpu_torch.parallel.launch\n"
        "import zerokit_tpu_torch.parallel.dryrun\n"
        "from zerokit_tpu_torch import RLN, keygen, poseidon_hash, OptimalMerkleTree\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'zerokit_tpu.', 'tools.'))\n"
        "             or m in ('zerokit_tpu', 'tools', 'mxu_mont_prototype'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


def test_no_source_line_imports_jax_or_the_jax_package():
    """Also catches imports inside functions, which the check above only
    sees when they run."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|zerokit_tpu|tools)(\.|\s|$)")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "zerokit_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offending = []
    for path in paths:
        with open(path) as f:
            offending += [
                f"{os.path.relpath(path, REPO)}: {line.strip()}"
                for line in f if pattern.match(line)
            ]
    assert offending == []


def _strip_imports(text: str):
    lines = []
    skipping = False
    for line in text.splitlines():
        if skipping:
            skipping = not line.rstrip().endswith(")")
            continue
        if line.startswith(("import ", "from ")):
            skipping = line.rstrip().endswith("(")
            continue
        lines.append(line)
    return lines


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_source(rel):
    with open(os.path.join(REPO, "zerokit_tpu", rel)) as f:
        src = _strip_imports(f.read())
    with open(os.path.join(REPO, "zerokit_tpu_torch", rel)) as f:
        port = _strip_imports(f.read())
    assert port == src


# JAX package modules without a port module of the same path
MODULES = {
    "ff/pallas_field.py": ("kernels", "K1-K3 are CUDA kernels in csrc/ behind ff/field_kernels.py"),
    "ff/pallas_ntt.py": ("kernels", "K4-K5 are CUDA kernels in csrc/ behind ff/ntt_kernels.py"),
    "runtime/cache.py": ("removal", "the XLA compile cache; the port builds with nvcc at first "
                         "use (ff/_cuda.py)"),
    "groth16/msm_host.py": ("test oracle", "the host MSM backend is not a prover backend of "
                            "the port; tests hold the port against it"),
    "resources/__init__.py": ("resources.py", "the artifacts are read by path"),
}
# (JAX module, name) -> (port counterpart "module:name", or None for a removal; reason)
NAMES = {
    ("cli/_common.py", "setup_jax_cache"): (None, "the XLA cache; nvcc builds at first use"),
    ("groth16/curve.py", "PallasCurveOps"): (None, "the Pallas EC path; K2 is a CUDA kernel"),
    ("groth16/curve.py", "best_curve_ops"): (None, "automatic backend choice; one CUDA path"),
    ("groth16/msm.py", "pack_aos_rows"): (None, "limb-pair packing for TPU gathers"),
    ("groth16/msm.py", "msm_pipeline"): (None, "eager steps for XLA compile economy; the "
                                         "fused pass is its counterpart"),
    ("groth16/msm_fused.py", "available"): (None, "the Pallas availability probe"),
    ("groth16/msm.py", "digits_for_windows"): ("groth16/msm_fused.py:digits_for_windows",
                                               "moved beside the pass that uses it"),
    ("groth16/msm_fused.py", "fused_multi_msm_pass"): ("groth16/msm_fused.py:fused_msm_pass",
                                                       "one pass for one or k MSMs"),
    ("parallel/dryrun.py", "run_depth10"): ("parallel/dryrun.py:run_depth", "any depth"),
    ("parallel/dryrun.py", "run_depth10_lite"): ("parallel/dryrun.py:run_depth", "any depth"),
}


def _defined(path: str, bound: bool) -> set:
    """Public top-level names of a module's source: def and class, and with
    `bound` also names that assignments and imports bind."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif bound and isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif bound and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _reference_modules():
    root = os.path.join(REPO, "zerokit_tpu")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root)


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    missing = []
    for rel in _reference_modules():
        port = os.path.join(REPO, "zerokit_tpu_torch", rel)
        if rel in MODULES:
            assert not os.path.exists(port), f"{rel} is listed as without a port module"
            continue
        assert os.path.exists(port), f"no port module for zerokit_tpu/{rel}"
        have = _defined(port, bound=True)
        for name in sorted(_defined(os.path.join(REPO, "zerokit_tpu", rel), bound=False) - have):
            if (rel, name) not in NAMES:
                missing.append(f"{rel}:{name}")
    assert missing == []


@pytest.mark.parametrize("key", sorted(NAMES))
def test_listed_removals_and_renames_hold(key):
    rel, name = key
    target, reason = NAMES[key]
    assert reason
    assert name in _defined(os.path.join(REPO, "zerokit_tpu", rel), bound=False)
    if target is None:
        assert name not in _defined(os.path.join(REPO, "zerokit_tpu_torch", rel), bound=True)
    else:
        mod, new = target.split(":")
        assert new in _defined(os.path.join(REPO, "zerokit_tpu_torch", mod), bound=True)
