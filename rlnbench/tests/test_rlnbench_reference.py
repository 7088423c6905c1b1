"""The plain reference against the port, byte for byte: one lane of the
depth-10 RLN circuit at a fixed (r, s), the port on the CPU with its plain
kernel versions (some minutes, for the port's window tables)."""

import random

from zerokit_tpu_torch import RLN
from zerokit_tpu_torch.protocol.serialize import rln_proof_to_bytes
from zerokit_tpu_torch.protocol.proof import RLNProof
from zerokit_tpu_torch.protocol.witness import RLNWitnessInput
from zerokit_tpu_torch.resources import load_resource, resource_path

from rlnbench.reference import prover as ref
from rlnbench.reference.constants import R
from rlnbench.reference.wire import proof_to_wire, public_inputs, values_from_public

ORDER = ["y", "root", "nullifier", "x", "external_nullifier"]


def test_reference_proof_equals_the_ports():
    rng = random.Random(20261018)
    secret, x, ext = (rng.randrange(R) for _ in range(3))
    path = [rng.randrange(R) for _ in range(10)]
    bits = [rng.randrange(2) for _ in range(10)]
    r, s = rng.randrange(R), rng.randrange(R)
    named = {"identitySecret": [secret], "userMessageLimit": [100], "messageId": [7],
             "pathElements": path, "identityPathIndex": bits, "x": [x],
             "externalNullifier": [ext]}
    circuit = ref.load_circuit(resource_path("tree_depth_10/rln_final.arkzkey"),
                               resource_path("tree_depth_10/graph.bin"), 10, None)
    z = ref.assignment(circuit, named)
    want = ref.prove(circuit, z, r, s)

    rln = RLN.stateless(zkey_bytes=load_resource("tree_depth_10/rln_final.arkzkey"),
                        graph_bytes=load_resource("tree_depth_10/graph.bin"), device="cpu")
    w = RLNWitnessInput.new_single(secret, 100, 7, path, bits, x, ext)
    (proof, values), = rln.generate_proofs([w], [r], [s])
    assert tuple(proof) == tuple(want)
    assert public_inputs(vars(values), ORDER) == ref.public_inputs(circuit, z)
    ours = proof_to_wire(want, values_from_public(ref.public_inputs(circuit, z), ORDER, None))
    assert ours == rln_proof_to_bytes(RLNProof(proof=proof, proof_values=values))


def test_witness_bytes_equal_the_ports(small_bench):
    from zerokit_tpu_torch.protocol.serialize import rln_witness_to_bytes

    from rlnbench import traffic as gen
    from rlnbench.reference.wire import witness_to_bytes

    man, _, _ = small_bench
    for cfg_name in ("rln-v2-depth10", "rln-multi-msg-depth20-maxout4"):
        cfg = man.config(cfg_name)
        for w in gen.witnesses(cfg, {}, 99, "window", 0, 3):
            common = (w["identity_secret"], w["user_message_limit"])
            if "message_id" in w:
                obj = RLNWitnessInput.new_single(*common, w["message_id"], w["path_elements"],
                                                 w["identity_path_index"], w["x"],
                                                 w["external_nullifier"])
            else:
                obj = RLNWitnessInput.new_multi(*common, w["message_ids"], w["path_elements"],
                                                w["identity_path_index"], w["x"],
                                                w["external_nullifier"], w["selector_used"])
            assert witness_to_bytes(w) == rln_witness_to_bytes(obj)
