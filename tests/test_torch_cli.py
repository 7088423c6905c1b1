"""The port's CLI examples (zerokit_tpu_torch/cli/) driven as a user would.

tests/test_cli.py's case on the port: the interactive relay REPL at depth
10 on the CPU (--device cpu), fed its command script over stdin, without
proving (the protocol-values path), asserting registration, signaling,
double-signal slashing and the out-of-range error line. The scripted relay
demo's root is held against the JAX package's depth-10 tree holding the
rate commitments it prints. The scripted demos of the stateless and
multi-message-id CLIs run without proving, and without a card the default
device raises.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from zerokit_tpu.tree.merkle import OptimalMerkleTree as JaxOptimalTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = "\n".join(
    [
        "register",
        "register",
        "send 0 hello",
        "send 1 hi there",
        "send 0 again",  # same epoch -> slashed
        "epoch two",
        "send 0 fresh epoch",  # rate limit reset
        "send 9 nobody",  # out of range -> error line, not a crash
        "root",
        "log",
        "quit",
        "",
    ]
)


def _run(module, *args, stdin=None):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        input=stdin, cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_relay_repl_slashing_flow():
    r = _run("zerokit_tpu_torch.cli.relay", "--depth", "10", "--device", "cpu", stdin=SCRIPT)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "registered user 0" in out
    assert "registered user 1" in out
    assert out.count("sent; nullifier") == 3  # two in epoch 1, one in epoch 2
    assert "SPAM: user 0 double-signaled" in out
    assert "(matches: True)" in out
    assert "no such user 9" in out
    assert "bye" in out


def test_relay_demo_root_equals_the_jax_tree():
    """The scripted relay demo prints its members' rate commitments and the
    root of its PmTree: the JAX package's tree holding them has that root."""
    r = _run("zerokit_tpu_torch.cli.relay", "--demo", "--depth", "10", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    commitments = [int(v, 16) for v in re.findall(r"rate commitment 0x([0-9a-f]{64})", r.stdout)]
    root = int(re.search(r"tree root: 0x([0-9a-f]{64})", r.stdout).group(1), 16)
    tree = JaxOptimalTree(10)
    for i, c in enumerate(commitments):
        tree.set(i, c)
    assert len(commitments) == 3 and root == tree.root()
    assert "slashing recovered the correct secret: True" in r.stdout


@pytest.mark.parametrize("module", ["stateless", "multi_message_id"])
def test_demos_without_proving(module):
    r = _run(f"zerokit_tpu_torch.cli.{module}", "--demo", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert ("matches external tree: True" in r.stdout
            or "inactive slots zeroed and root matches: True" in r.stdout)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    r = _run("zerokit_tpu_torch.cli.relay", "--depth", "10", stdin="quit\n")
    assert r.returncode != 0 and "no CUDA device" in r.stderr
