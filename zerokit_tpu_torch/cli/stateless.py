"""Stateless demo: proofs against an externally-managed Merkle tree.

Mirrors rln-cli/src/examples/stateless.rs: the RLN engine holds no tree;
the app maintains an OptimalMerkleTree, hands membership paths to the
prover, and verifies against a set of accepted roots.
"""

from __future__ import annotations

import argparse

from .. import RLN, RLNWitnessInput, hash_to_field_le, poseidon_hash, poseidon_hash_pair, seeded_keygen
from ..protocol.proof import proof_values_from_witness
from ..tree.merkle import OptimalMerkleTree
from ._common import add_device_arg, fr_hex, say

LIMIT = 100


def run_demo(prove: bool = False, device="cuda") -> bool:
    tree = OptimalMerkleTree(20, device=device)
    rln = RLN.stateless(device=device) if prove else None

    secret, commitment = seeded_keygen(b"stateless-demo-user")
    rate_commitment = poseidon_hash_pair(commitment, LIMIT)
    tree.set(5, rate_commitment)
    say(f"registered at index 5; root {fr_hex(tree.root())}")

    mp = tree.proof(5)
    ext = poseidon_hash_pair(hash_to_field_le(b"epoch"), hash_to_field_le(b"stateless-demo"))
    x = hash_to_field_le(b"the signal")
    witness = RLNWitnessInput.new_single(
        secret, LIMIT, 7, mp.get_path_elements(), mp.get_path_index(), x, ext
    )
    values = proof_values_from_witness(witness)
    ok = values.root == tree.root()
    say(f"proof values root matches external tree: {ok}")
    if prove:
        proof, values = rln.generate_proof(witness)
        ok = rln.verify_with_roots(proof, values, x, [tree.root()])
        say(f"proof verified against accepted roots: {ok}")
    return bool(ok)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--prove", action="store_true")
    add_device_arg(parser)
    args = parser.parse_args()
    assert run_demo(args.prove, args.device)


if __name__ == "__main__":
    main()
