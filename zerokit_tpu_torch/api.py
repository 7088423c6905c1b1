"""Public RLN API, shaped like the reference's V3 generation, over the torch prover.

The reference exposes `RLNV3<State, ZkProof>` with type-level tree/backend
selection (rln/src/public.rs:774-997) plus a legacy feature-gated `RLN`.
Here there is ONE runtime-composed object:

    rln = RLN.stateless()                          # embedded depth-20 single
    rln = RLN.stateless(mode="multi")              # embedded multi max_out=4
    rln = RLN.stateful(tree=OptimalMerkleTree(20))
    rln = RLN.stateless(zkey_bytes=..., graph_bytes=...)

Counterpart of zerokit_tpu/api.py; `mesh=` becomes `device=` ("cuda" by
default: the constructors raise without a card; tests pass "cpu"). The
stateful tree is the host OptimalMerkleTree, whose rehash runs in the
native host library when it loads (tree/merkle.py).

Proving is batch-first: `generate_proofs` evaluates witnesses, runs the
QAP witness map and all MSMs for the whole batch on the device
(groth16/prover.Groth16Prover). Single-proof methods are the batch of one.

Method parity with the reference (tree ops public.rs:292-593, proof ops
public.rs:595-955): set_leaf/get_leaf/set_leaves_from/init_tree_with_leaves/
atomic_operation/set_next_leaf/delete_leaf/get_root/get_subtree_root/
get_merkle_proof/get_empty_leaves_indices/leaves_set/metadata/flush,
generate_proof/verify/verify_with_roots/generate_partial_proof/finish_proof,
recover_id_secret.
"""

from __future__ import annotations

import functools
import secrets
from typing import Dict, List, Optional, Sequence, Tuple

from . import errors
from .circuit.graph import Graph, graph_from_bytes
from .circuit.zkey import Zkey, zkey_from_bytes
from .constants import DEFAULT_MAX_OUT, DEFAULT_TREE_DEPTH, NUM_LIMBS, R
from .ff.field import FrField, encode_canonical_fast
from .groth16.prover import Groth16Prover, PartialProof
from .groth16.verifier import prepare_verifying_key, rln_public_inputs, verify_proof
from .protocol.proof import RLNProof, RLNProofValues, proof_values_from_witness
from .protocol.slashing import recover_secret
from .protocol.witness import RLNPartialWitnessInput, RLNWitnessInput
from .resources import load_resource
from .tree.merkle import MerkleProof, OptimalMerkleTree


@functools.lru_cache(maxsize=None)
def default_zkey(mode: str = "single") -> Zkey:
    rel = (
        "tree_depth_20/rln_final.arkzkey"
        if mode == "single"
        else "tree_depth_20/multi_message_id/max_out_4/rln_final.arkzkey"
    )
    return zkey_from_bytes(load_resource(rel))


@functools.lru_cache(maxsize=None)
def default_graph(mode: str = "single") -> Graph:
    if mode == "single":
        return graph_from_bytes(
            load_resource("tree_depth_20/graph.bin"), DEFAULT_TREE_DEPTH, None
        )
    return graph_from_bytes(
        load_resource("tree_depth_20/multi_message_id/max_out_4/graph.bin"),
        DEFAULT_TREE_DEPTH,
        DEFAULT_MAX_OUT,
    )


class RLN:
    """RLN proving/verification engine with optional tree state."""

    def __init__(self, zkey: Zkey, graph: Graph, tree=None, device="cuda"):
        """device: where the prover runs (one card; the multi-device path is
        not ported)."""
        self.zkey = zkey
        self.graph = graph
        self.tree = tree
        self.prover = Groth16Prover(zkey, graph, device=device)
        self.device = self.prover.device
        self.pvk = prepare_verifying_key(zkey.pk.vk)

    # -- constructors -------------------------------------------------------

    @classmethod
    def stateless(
        cls,
        mode: str = "single",
        zkey_bytes: Optional[bytes] = None,
        graph_bytes: Optional[bytes] = None,
        device="cuda",
    ) -> "RLN":
        zkey = zkey_from_bytes(zkey_bytes) if zkey_bytes else default_zkey(mode)
        graph = (
            graph_from_bytes(graph_bytes) if graph_bytes else default_graph(mode)
        )
        return cls(zkey, graph, device=device)

    @classmethod
    def stateful(
        cls,
        tree=None,
        mode: str = "single",
        zkey_bytes: Optional[bytes] = None,
        graph_bytes: Optional[bytes] = None,
        device="cuda",
    ) -> "RLN":
        rln = cls.stateless(mode, zkey_bytes, graph_bytes, device=device)
        rln.tree = (
            tree if tree is not None
            else OptimalMerkleTree(rln.graph.tree_depth, device=rln.device)
        )
        return rln

    # -- utility ------------------------------------------------------------

    def tree_depth(self) -> int:
        return self.graph.tree_depth

    def max_out(self) -> int:
        return self.graph.max_out

    def _require_tree(self):
        if self.tree is None:
            raise errors.ZerokitError("stateless RLN instance has no tree")
        return self.tree

    # -- tree ops (delegated; reference public.rs:292-593) -------------------

    def set_leaf(self, index: int, leaf: int) -> None:
        self._require_tree().set(index, leaf)

    def get_leaf(self, index: int) -> int:
        return self._require_tree().get(index)

    def set_leaves_from(self, index: int, leaves: Sequence[int]) -> None:
        self._require_tree().set_range(index, leaves)

    def init_tree_with_leaves(self, leaves: Sequence[int]) -> None:
        tree = self._require_tree()
        self.tree = type(tree)(tree.depth(), device=tree.device)
        self.tree.set_range(0, leaves)

    def atomic_operation(self, index: int, leaves, indices) -> None:
        self._require_tree().override_range(index, leaves, indices)

    def set_next_leaf(self, leaf: int) -> None:
        self._require_tree().update_next(leaf)

    def delete_leaf(self, index: int) -> None:
        self._require_tree().delete(index)

    def leaves_set(self) -> int:
        return self._require_tree().leaves_set()

    def get_root(self) -> int:
        return self._require_tree().root()

    def get_subtree_root(self, level: int, index: int) -> int:
        return self._require_tree().get_subtree_root(level, index)

    def get_merkle_proof(self, index: int) -> MerkleProof:
        return self._require_tree().proof(index)

    def get_empty_leaves_indices(self) -> List[int]:
        return self._require_tree().get_empty_leaves_indices()

    def set_metadata(self, metadata: bytes) -> None:
        self._require_tree().set_metadata(metadata)

    def get_metadata(self) -> bytes:
        return self._require_tree().metadata()

    def flush(self) -> None:
        self._require_tree().close_db_connection()

    # -- proving ------------------------------------------------------------

    def _batch_named_inputs(
        self, witnesses: Sequence[RLNWitnessInput]
    ) -> Dict[str, List[List[int]]]:
        named: Dict[str, List[List[int]]] = {}
        per_witness = [w.named_inputs() for w in witnesses]
        for name in per_witness[0]:
            length = len(per_witness[0][name])
            named[name] = [
                [pw[name][slot] for pw in per_witness] for slot in range(length)
            ]
        return named

    def generate_proofs(
        self,
        witnesses: Sequence[RLNWitnessInput],
        rs: Optional[Sequence[int]] = None,
        ss: Optional[Sequence[int]] = None,
        metrics=None,
    ) -> List[Tuple[tuple, RLNProofValues]]:
        """Batched prove: the whole batch runs through the device pipeline.
        Pass a runtime.profiling.PipelineMetrics as `metrics` for a per-stage
        timing report."""
        if not witnesses:
            return []
        for w in witnesses:
            w.validate_against_graph(self.graph)
        values = [proof_values_from_witness(w) for w in witnesses]
        if rs is not None and len(rs) != len(witnesses):
            raise errors.ZerokitError(
                f"rs has {len(rs)} entries, expected {len(witnesses)}"
            )
        if ss is not None and len(ss) != len(witnesses):
            raise errors.ZerokitError(
                f"ss has {len(ss)} entries, expected {len(witnesses)}"
            )
        if rs is None:
            rs = [secrets.randbelow(R) for _ in witnesses]
        if ss is None:
            ss = [secrets.randbelow(R) for _ in witnesses]
        named = self._batch_named_inputs(witnesses)
        proofs = self.prover.prove_batch(named, rs, ss, metrics=metrics)
        return list(zip(proofs, values))

    def generate_proof(
        self,
        witness: RLNWitnessInput,
        r: Optional[int] = None,
        s: Optional[int] = None,
    ) -> Tuple[tuple, RLNProofValues]:
        rs = [r if r is not None else secrets.randbelow(R)]
        ss = [s if s is not None else secrets.randbelow(R)]
        return self.generate_proofs([witness], rs, ss)[0]

    def generate_proofs_with_witness(
        self,
        calculated_witnesses: Sequence[Sequence[int]],
        witnesses: Sequence[RLNWitnessInput],
        rs: Optional[Sequence[int]] = None,
        ss: Optional[Sequence[int]] = None,
    ) -> List[Tuple[tuple, RLNProofValues]]:
        """Proves from externally-computed witness vectors (the browser/wasm
        flow: the host runs the circom witness calculator and hands the full
        wire assignment over; reference public.rs:643
        generate_rln_proof_with_witness). Each calculated witness is the full
        assignment [1, publics..., aux...] of length n_wires."""
        if len(calculated_witnesses) != len(witnesses):
            raise errors.ZerokitError("witness vector / input count mismatch")
        n_wires = self.prover.n_wires
        batch = len(witnesses)
        for cw in calculated_witnesses:
            if len(cw) != n_wires:
                raise errors.ZerokitError(
                    f"calculated witness has {len(cw)} wires, expected {n_wires}"
                )
        # same witness-shape validation as the internal path (reference
        # public.rs generate_rln_proof_with_witness validates the inputs too)
        for w in witnesses:
            w.validate_against_graph(self.graph)
        values = [proof_values_from_witness(w) for w in witnesses]
        if rs is not None and len(rs) != batch:
            raise errors.ZerokitError(f"rs has {len(rs)} entries, expected {batch}")
        if ss is not None and len(ss) != batch:
            raise errors.ZerokitError(f"ss has {len(ss)} entries, expected {batch}")
        if rs is None:
            rs = [secrets.randbelow(R) for _ in witnesses]
        if ss is None:
            ss = [secrets.randbelow(R) for _ in witnesses]
        flat = [
            calculated_witnesses[b][i] % R
            for i in range(n_wires)
            for b in range(batch)
        ]
        canon = encode_canonical_fast(flat).reshape(NUM_LIMBS, n_wires, batch)
        assignment = FrField.to_mont(canon.to(self.device))
        proofs = self.prover.prove_batch_with_assignment(assignment, rs, ss)
        return list(zip(proofs, values))

    def generate_proof_with_witness(
        self,
        calculated_witness: Sequence[int],
        witness: RLNWitnessInput,
        r: Optional[int] = None,
        s: Optional[int] = None,
    ) -> Tuple[tuple, RLNProofValues]:
        rs = [r if r is not None else secrets.randbelow(R)]
        ss = [s if s is not None else secrets.randbelow(R)]
        return self.generate_proofs_with_witness([calculated_witness], [witness], rs, ss)[0]

    def generate_partial_proof(self, partial_witness: RLNPartialWitnessInput) -> PartialProof:
        partial_witness.validate_against_graph(self.graph)
        from .circuit.witness_host import calc_witness_partial

        named = partial_witness.named_inputs_partial(self.graph.max_out)
        assignment = calc_witness_partial(named, self.graph)
        return self.prover.prove_partial(assignment[1:])

    def finish_proof(
        self,
        partial: PartialProof,
        witness: RLNWitnessInput,
        r: Optional[int] = None,
        s: Optional[int] = None,
    ) -> Tuple[tuple, RLNProofValues]:
        witness.validate_against_graph(self.graph)
        values = proof_values_from_witness(witness)
        named = self._batch_named_inputs([witness])
        assignment = self.prover.full_assignments(named, 1)
        r = r if r is not None else secrets.randbelow(R)
        s = s if s is not None else secrets.randbelow(R)
        proof = self.prover.finish_proof(partial, assignment, r, s)
        return proof, values

    # -- verification -------------------------------------------------------

    def verify(self, proof, values: RLNProofValues) -> bool:
        return verify_proof(self.pvk, proof, rln_public_inputs(values))

    def verify_batch(self, proofs: Sequence, values_list: Sequence[RLNProofValues]) -> bool:
        """Batched verification: one random-linear-combination multi-pairing
        (B+3 Miller loops + one final exponentiation) instead of B full
        verifies. The serving-path dual of the batch-first prover; the
        reference verifies one proof per call (proof.rs:856-894)."""
        from .groth16.verifier import verify_batch

        return verify_batch(
            self.pvk, proofs, [rln_public_inputs(v) for v in values_list]
        )

    def verify_rln_proof(self, proof, values: RLNProofValues, x: int) -> bool:
        """Stateful verify against the current tree root (public.rs:725-745)."""
        if not self.verify(proof, values):
            raise errors.InvalidProof("pairing check failed")
        if self._require_tree().root() != values.root:
            raise errors.InvalidRoot("proof root does not match tree root")
        if x % R != values.x:
            raise errors.InvalidSignal("signal mismatch")
        return True

    def verify_with_roots(
        self, proof, values: RLNProofValues, x: int, roots: Sequence[int]
    ) -> bool:
        """V3 ordering: roots and x checked before the pairing
        (public.rs:937-954)."""
        if roots and values.root not in [r % R for r in roots]:
            raise errors.InvalidRoot("proof root not in accepted roots")
        if x % R != values.x:
            raise errors.InvalidSignal("signal mismatch")
        if not self.verify(proof, values):
            raise errors.InvalidProof("pairing check failed")
        return True

    # -- slashing -----------------------------------------------------------

    @staticmethod
    def recover_id_secret(v1: RLNProofValues, v2: RLNProofValues) -> int:
        return recover_secret(v1, v2)
