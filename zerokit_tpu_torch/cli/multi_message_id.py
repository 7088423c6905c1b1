"""Multi-message-id burn demo (max_out = 4).

Mirrors rln-cli/src/examples/multi_message_id.rs: one proof covers several
message slots; inactive slots carry zeroed outputs via selectors.
"""

from __future__ import annotations

import argparse

from .. import RLN, RLNWitnessInput, hash_to_field_le, keygen, poseidon_hash_pair
from ..protocol.proof import proof_values_from_witness
from ..tree.merkle import OptimalMerkleTree
from ._common import add_device_arg, fr_hex, say

LIMIT = 100
MAX_OUT = 4


def run_demo(prove: bool = False, device="cuda") -> bool:
    tree = OptimalMerkleTree(20, device=device)
    secret, commitment = keygen()
    tree.set(0, poseidon_hash_pair(commitment, LIMIT))

    mp = tree.proof(0)
    ext = poseidon_hash_pair(hash_to_field_le(b"epoch"), hash_to_field_le(b"multi-demo"))
    witness = RLNWitnessInput.new_multi(
        secret, LIMIT, [1, 2, 3, 0], mp.get_path_elements(), mp.get_path_index(),
        hash_to_field_le(b"burst of messages"), ext, [True, True, False, False],
    )
    values = proof_values_from_witness(witness)
    say(f"active nullifiers: {[fr_hex(n) for n in values.nullifiers[:2]]}")
    ok = (
        values.nullifiers[2] == 0
        and values.nullifiers[3] == 0
        and values.ys[2] == 0
        and values.root == tree.root()
    )
    say(f"inactive slots zeroed and root matches: {ok}")
    if prove:
        rln = RLN.stateless(mode="multi", device=device)
        proof, values = rln.generate_proof(witness)
        ok = rln.verify(proof, values)
        say(f"multi proof verified: {ok}")
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
