"""zerokit_tpu_torch: the PyTorch + CUDA port of zerokit_tpu.

Batched RLN Groth16 proving over BN254 on an NVIDIA H100: witness
evaluation, the QAP witness map, from_mont and the five fixed-base MSMs on
the card, then the native blinding assembly; partial/finish proving;
batched Poseidon and the device-resident Merkle tree; the RLN protocol layer
(identities, proof values, slashing) and the RLN facade over the prover.
Every kernel of those paths is a hand-written CUDA kernel under csrc/
(built with nvcc at first use); each has a plain PyTorch version that CPU
tensors take.

Field elements keep zerokit_tpu's layout at every public function: (16, ...)
limbs of 16 bits, Montgomery radix 2^256, stored as int32 tensors holding
values in [0, 2^16).

Importing this package imports no JAX and nothing from zerokit_tpu.
"""

__version__ = "0.1.0"

from .api import RLN  # noqa: F401
from .protocol.identity import IdSecret  # noqa: F401
from .protocol.keygen import (  # noqa: F401
    extended_keygen,
    extended_seeded_keygen,
    hash_to_field_be,
    hash_to_field_le,
    keygen,
    seeded_keygen,
)
from .protocol.proof import RLNProof, RLNProofValues, proof_values_from_witness  # noqa: F401
from .protocol.slashing import compute_id_secret, recover_id_secret, recover_secret  # noqa: F401
from .protocol.witness import (  # noqa: F401
    RLNPartialWitnessInput,
    RLNWitnessInput,
    compute_tree_root,
)
from .hash.poseidon import poseidon_hash, poseidon_hash_pair  # noqa: F401
from .tree.merkle import FullMerkleTree, OptimalMerkleTree  # noqa: F401
