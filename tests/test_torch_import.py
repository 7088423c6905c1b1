"""zerokit_tpu_torch stands alone: no JAX, no zerokit_tpu, verbatim copies.

The port runs on hosts without JAX, so importing it (down to the prover and
its tools) must not pull in JAX, the JAX package or the repository's tools/.
The modules it copies from the JAX package must stay the same code: their
text equals the source once import lines are removed.
"""

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
