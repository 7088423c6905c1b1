"""The port's export of the JS client's Groth16 fixture.

The tracked clients/js/test/fixtures/groth16_depth10.json was written by the
JAX tool (tools/export_js_fixture.py). The port builds the same witness,
verifying key and public inputs (checked here without proving), verifies
the tracked proof, writes only under build/ and compares bytes. Its whole
depth-10 export, a proof on the CPU's plain versions, equals the tracked
file byte for byte (marked slow: depth-10 CPU proving takes minutes).
"""

import json
import os

import pytest
import torch

from zerokit_tpu_torch.circuit.zkey import zkey_from_bytes
from zerokit_tpu_torch.groth16.verifier import (prepare_verifying_key, rln_public_inputs,
                                                verify_proof)
from zerokit_tpu_torch.hostmath import arkserde
from zerokit_tpu_torch.protocol.proof import proof_values_from_witness
from zerokit_tpu_torch.resources import load_resource
from zerokit_tpu_torch.tools import export_js_fixture as ej

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tracked():
    with open(ej.TRACKED) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def vk():
    return zkey_from_bytes(load_resource("tree_depth_10/rln_final.arkzkey")).pk.vk


def test_paths_stay_out_of_the_tracked_tree():
    assert ej.TRACKED == os.path.join(REPO, "clients", "js", "test", "fixtures",
                                      "groth16_depth10.json")
    assert ej.OUT == os.path.join(REPO, "build", "zerokit_tpu_torch", "groth16_depth10.json")
    with pytest.raises(SystemExit):
        ej.main(["--device", "cpu", "--out", ej.TRACKED])


def test_vk_values_and_public_inputs_equal_the_tracked_file(tracked, vk):
    values = proof_values_from_witness(ej.fixture_witness("cpu"))
    assert ej.vk_json(vk) == tracked["vk"]
    assert [str(v) for v in rln_public_inputs(values)] == tracked["publicInputs"]
    assert tracked["values"] == {
        "mode": "single", "root": str(values.root),
        "externalNullifier": str(values.external_nullifier), "x": str(values.x),
        "y": str(values.y), "nullifier": str(values.nullifier)}


def test_tracked_proof_verifies_under_the_port_verifier(tracked, vk):
    proof = arkserde.proof_from_bytes(bytes.fromhex(tracked["proofCompressedHex"]))
    inputs = [int(v) for v in tracked["publicInputs"]]
    pvk = prepare_verifying_key(vk)
    assert verify_proof(pvk, proof, inputs)
    assert not verify_proof(pvk, proof, [inputs[0] + 1] + inputs[1:])


def test_compare_is_byte_for_byte(tracked, tmp_path, monkeypatch, capsys):
    """--compare exits 0 on the tracked bytes and 1 on any other; the file
    goes to --out."""
    out = tmp_path / "fixture.json"
    monkeypatch.setattr(ej, "build_fixture", lambda device: tracked)
    assert ej.main(["--device", "cpu", "--out", str(out), "--compare"]) == 0
    with open(ej.TRACKED, "rb") as f:
        assert out.read_bytes() == f.read()
    changed = dict(tracked, publicInputs=tracked["publicInputs"][::-1])
    monkeypatch.setattr(ej, "build_fixture", lambda device: changed)
    assert ej.main(["--device", "cpu", "--out", str(out), "--compare"]) == 1
    assert "DIFFERS" in capsys.readouterr().out


@pytest.mark.slow
def test_depth10_export_equals_the_tracked_file(tmp_path):
    out = tmp_path / "groth16_depth10.json"
    assert ej.main(["--device", "cpu", "--out", str(out), "--compare"]) == 0
