"""Exports the Groth16 verification fixture of the JS client tests, through the port.

Counterpart of tools/export_js_fixture.py: the embedded depth-10 verifying
key (decimal-string coordinates), a real proof made by the port's prover
(RLN.stateless on the depth-10 resources, blinding r = 31337, s = 271828;
128-byte ark-compressed hex), its proof values and the public inputs in
the verifier's order, as JSON with indent=1. The port's proofs equal the
JAX prover's at the same (r, s), so the output equals the tracked
clients/js/test/fixtures/groth16_depth10.json byte for byte.

It writes build/zerokit_tpu_torch/groth16_depth10.json (never the tracked
file); --compare exits 1 unless the bytes equal the tracked file's.

Run: python -m zerokit_tpu_torch.tools.export_js_fixture [--device cuda]
         [--out PATH] [--compare]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..runtime.profiling import REPO_DIR

TRACKED = os.path.join(REPO_DIR, "clients", "js", "test", "fixtures", "groth16_depth10.json")
OUT = os.path.join(REPO_DIR, "build", "zerokit_tpu_torch", "groth16_depth10.json")
DEPTH = 10
R_BLIND, S_BLIND = 31337, 271828


def g1_json(p):
    return None if p is None else [str(p[0]), str(p[1])]


def g2_json(p):
    if p is None:
        return None
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])]]


def vk_json(vk) -> dict:
    return {
        "alphaG1": g1_json(vk.alpha_g1),
        "betaG2": g2_json(vk.beta_g2),
        "gammaG2": g2_json(vk.gamma_g2),
        "deltaG2": g2_json(vk.delta_g2),
        "gammaAbcG1": [g1_json(p) for p in vk.gamma_abc_g1],
    }


def fixture_witness(device="cuda"):
    """The fixture's RLN witness: member 0 of a depth-10 tree on `device`."""
    from .. import hash_to_field_le, poseidon_hash, poseidon_hash_pair
    from ..protocol.witness import RLNWitnessInput
    from ..tree.merkle import OptimalMerkleTree

    tree = OptimalMerkleTree(DEPTH, device=device)
    secret = hash_to_field_le(b"js-fixture-secret")
    limit = 5
    tree.set(0, poseidon_hash_pair(poseidon_hash([secret]), limit))
    mp = tree.proof(0)
    ext = poseidon_hash_pair(hash_to_field_le(b"js-ep"), hash_to_field_le(b"js-app"))
    return RLNWitnessInput.new_single(
        secret, limit, 2, mp.get_path_elements(), mp.get_path_index(),
        hash_to_field_le(b"js fixture signal"), ext,
    )


def fixture_json(vk, proof, values) -> dict:
    from ..groth16.verifier import rln_public_inputs
    from ..hostmath import arkserde

    return {
        "vk": vk_json(vk),
        "proofCompressedHex": arkserde.proof_to_bytes(proof).hex(),
        "publicInputs": [str(v) for v in rln_public_inputs(values)],
        "values": {
            "mode": "single",
            "root": str(values.root),
            "externalNullifier": str(values.external_nullifier),
            "x": str(values.x),
            "y": str(values.y),
            "nullifier": str(values.nullifier),
        },
    }


def build_fixture(device="cuda") -> dict:
    """Proves the fixture's witness on `device` and checks that it verifies."""
    from ..api import RLN
    from ..resources import load_resource

    rln = RLN.stateless(
        zkey_bytes=load_resource(f"tree_depth_{DEPTH}/rln_final.arkzkey"),
        graph_bytes=load_resource(f"tree_depth_{DEPTH}/graph.bin"),
        device=device,
    )
    proof, values = rln.generate_proof(fixture_witness(device), r=R_BLIND, s=S_BLIND)
    if not rln.verify(proof, values):
        raise AssertionError("fixture proof must verify")
    return fixture_json(rln.zkey.pk.vk, proof, values)


def dumps(fixture: dict) -> str:
    """The file's text, as json.dump(fixture, f, indent=1) writes it."""
    return json.dumps(fixture, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--compare", action="store_true",
                    help=f"exit 1 unless the bytes equal {os.path.relpath(TRACKED, REPO_DIR)}")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(TRACKED):
        ap.error("the tracked fixture is not rewritten; --compare checks it")
    text = dumps(build_fixture(args.device))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(text.encode())
    print(f"wrote {args.out}")
    if args.compare:
        with open(TRACKED, "rb") as f:
            same = f.read() == text.encode()
        print(f"{'equal to' if same else 'DIFFERS from'} {TRACKED}")
        return 0 if same else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
