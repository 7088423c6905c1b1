"""Two-phase proving demo: cache a partial proof, finish per message.

Mirrors rln-cli/src/examples/partial.rs: the static witness part (identity +
Merkle path) is precomputed into a PartialProof; each message only pays the
finish step (complement MSMs + h-query MSM + blinding).
"""

from __future__ import annotations

import argparse
import time

from .. import RLN, RLNWitnessInput, hash_to_field_le, keygen, poseidon_hash_pair
from ..protocol.serialize import bytes_to_rln_partial_proof, rln_partial_proof_to_bytes
from ..protocol.witness import RLNPartialWitnessInput
from ..tree.merkle import OptimalMerkleTree
from ._common import add_device_arg, say

LIMIT = 100


def run_demo(prove: bool = True, device="cuda") -> bool:
    tree = OptimalMerkleTree(20, device=device)
    secret, commitment = keygen()
    tree.set(0, poseidon_hash_pair(commitment, LIMIT))
    mp = tree.proof(0)

    partial_witness = RLNPartialWitnessInput.new(
        secret, LIMIT, mp.get_path_elements(), mp.get_path_index()
    )
    rln = RLN.stateless(device=device)
    t0 = time.time()
    partial = rln.generate_partial_proof(partial_witness)
    say(f"partial proof precomputed in {time.time() - t0:.1f}s")

    # serialization roundtrip (reference proof.rs:537-588 wire format)
    blob = rln_partial_proof_to_bytes(partial)
    partial2, _ = bytes_to_rln_partial_proof(blob)
    say(f"partial proof serialized to {len(blob)} bytes; roundtrip ok: "
        f"{partial2.partial_pi_a == partial.partial_pi_a}")

    ext = poseidon_hash_pair(hash_to_field_le(b"epoch"), hash_to_field_le(b"partial-demo"))
    ok = True
    for i, message in enumerate([b"first message", b"second message"]):
        witness = RLNWitnessInput.new_single(
            secret, LIMIT, i, mp.get_path_elements(), mp.get_path_index(),
            hash_to_field_le(message), ext,
        )
        t0 = time.time()
        proof, values = rln.finish_proof(partial2, witness)
        dt = time.time() - t0
        verified = rln.verify(proof, values)
        say(f"message {i}: finished in {dt:.1f}s, verified: {verified}")
        ok = ok and verified
    return ok


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", action="store_true")
    add_device_arg(parser)
    args = parser.parse_args()
    assert run_demo(device=args.device)


if __name__ == "__main__":
    main()
