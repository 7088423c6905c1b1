"""Relay demo: stateful RLN spam prevention with slashing.

Mirrors rln-cli/src/examples/relay.rs: users register into a persistent
Poseidon tree, send rate-limited messages (one per epoch at limit 1), a
nullifier log detects double-signaling, and the violator's identity secret
is recovered with the share algebra.
"""

from __future__ import annotations

import argparse
import tempfile

from .. import RLN, RLNWitnessInput, hash_to_field_le, keygen, poseidon_hash, poseidon_hash_pair
from ..protocol.proof import proof_values_from_witness
from ..tree.pmtree import PmTree, PmTreeConfig
from ._common import add_device_arg, fr_hex, say

LIMIT = 1


def run_demo(depth: int = 20, prove: bool = False, device="cuda") -> bool:
    cfg = PmTreeConfig.create(temporary=True)
    tree = PmTree(depth, cfg, device=device)
    rln = RLN.stateful(tree=tree, device=device) if prove else None

    say("== relay demo: register 3 users ==")
    users = []
    for i in range(3):
        secret, commitment = keygen()
        rate_commitment = poseidon_hash_pair(commitment, LIMIT)
        tree.set(i, rate_commitment)
        users.append(secret)
        say(f"user {i}: rate commitment {fr_hex(rate_commitment)}")
    say(f"tree root: {fr_hex(tree.root())}")

    epoch = hash_to_field_le(b"demo-epoch")
    rln_id = hash_to_field_le(b"relay-demo")
    ext = poseidon_hash_pair(epoch, rln_id)

    nullifier_log = {}

    def signal(user: int, message: bytes):
        mp = tree.proof(user)
        w = RLNWitnessInput.new_single(
            users[user], LIMIT, 0, mp.get_path_elements(), mp.get_path_index(),
            hash_to_field_le(message), ext,
        )
        values = proof_values_from_witness(w)
        if prove:
            proof, values = rln.generate_proof(w)
            assert rln.verify_rln_proof(proof, values, hash_to_field_le(message))
        if values.nullifier in nullifier_log:
            prior = nullifier_log[values.nullifier]
            from ..protocol.slashing import recover_id_secret

            recovered = recover_id_secret(prior, values)
            say(f"SPAM detected! recovered secret {fr_hex(recovered)}")
            return recovered
        nullifier_log[values.nullifier] = values
        say(f"user {user} signaled: nullifier {fr_hex(values.nullifier)}")
        return None

    say("== users signal once each ==")
    signal(0, b"hello from user 0")
    signal(1, b"hello from user 1")
    say("== user 0 signals twice in the same epoch ==")
    recovered = signal(0, b"second message, same epoch")
    ok = recovered == users[0]
    say(f"slashing recovered the correct secret: {ok}")
    tree.close_db_connection()
    return ok


def run_repl(depth: int = 20, prove: bool = False, device="cuda") -> None:
    """Interactive loop, mirroring the reference's clap REPL
    (rln-cli/src/examples/relay.rs): commands read from stdin, one per line.

      register                 add a new identity; prints its index
      send <user> <message>    signal as user (nullifier logged; double
                               signaling in the same epoch slashes)
      epoch <label>            switch to a new epoch (resets rate limits)
      root                     print the current tree root
      log                      print the nullifier log for this epoch
      help / quit

    Pipe a script for non-interactive use:
      printf 'register\\nsend 0 hi\\nquit\\n' | python -m zerokit_tpu_torch.cli.relay
    """
    cfg = PmTreeConfig.create(temporary=True)
    tree = PmTree(depth, cfg, device=device)
    rln = RLN.stateful(tree=tree, device=device) if prove else None
    users = []
    epoch_label = b"repl-epoch-0"
    rln_id = hash_to_field_le(b"relay-repl")
    ext = poseidon_hash_pair(hash_to_field_le(epoch_label), rln_id)
    nullifier_log = {}

    say(f"relay REPL (depth {depth}, prove={prove}, device={tree.device}) — 'help' for commands")
    import sys

    for line in sys.stdin:
        parts = line.strip().split(None, 2)
        if not parts:
            continue
        cmd = parts[0].lower()
        try:
            if cmd in ("quit", "exit"):
                break
            elif cmd == "help":
                say(run_repl.__doc__)
            elif cmd == "register":
                secret, commitment = keygen()
                idx = len(users)
                tree.set(idx, poseidon_hash_pair(commitment, LIMIT))
                users.append(secret)
                say(f"registered user {idx}; root {fr_hex(tree.root())}")
            elif cmd == "epoch":
                label = (parts[1] if len(parts) > 1 else "next").encode()
                ext = poseidon_hash_pair(hash_to_field_le(label), rln_id)
                nullifier_log.clear()
                say(f"epoch -> {label.decode()} (nullifier log cleared)")
            elif cmd == "root":
                say(f"root {fr_hex(tree.root())}")
            elif cmd == "log":
                for n, v in nullifier_log.items():
                    say(f"  nullifier {fr_hex(n)} x {fr_hex(v.x)}")
                say(f"({len(nullifier_log)} entries)")
            elif cmd == "send":
                user = int(parts[1])
                message = (parts[2] if len(parts) > 2 else "").encode()
                if user < 0 or user >= len(users):
                    say(f"no such user {user} (register first)")
                    continue
                mp = tree.proof(user)
                w = RLNWitnessInput.new_single(
                    users[user], LIMIT, 0, mp.get_path_elements(),
                    mp.get_path_index(), hash_to_field_le(message), ext,
                )
                values = proof_values_from_witness(w)
                if prove:
                    proof, values = rln.generate_proof(w)
                    ok = rln.verify_rln_proof(
                        proof, values, hash_to_field_le(message)
                    )
                    say(f"proof verified: {ok}")
                if values.nullifier in nullifier_log:
                    from ..protocol.slashing import recover_id_secret

                    recovered = recover_id_secret(
                        nullifier_log[values.nullifier], values
                    )
                    say(
                        f"SPAM: user {user} double-signaled; recovered secret "
                        f"{fr_hex(recovered)} (matches: {recovered == users[user]})"
                    )
                else:
                    nullifier_log[values.nullifier] = values
                    say(f"sent; nullifier {fr_hex(values.nullifier)}")
            else:
                say(f"unknown command {cmd!r} — 'help' for commands")
        except Exception as e:  # REPL: report, don't die
            say(f"error: {type(e).__name__}: {e}")
    tree.close_db_connection()
    say("bye")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", action="store_true", help="run the scripted demo")
    parser.add_argument("--prove", action="store_true", help="generate real ZK proofs")
    parser.add_argument("--depth", type=int, default=20)
    add_device_arg(parser)
    args = parser.parse_args()
    if args.demo:
        assert run_demo(args.depth, args.prove, args.device)
    else:
        run_repl(args.depth, args.prove, args.device)


if __name__ == "__main__":
    main()
