"""Batched Groth16 prover on the card.

Counterpart of zerokit_tpu/groth16/prover.py (full proving; ark-groth16
create_proof_with_reduction_and_matrices with CircomReduction, reference
call site rln/src/protocol/proof.rs:721,766):

    g_a  = alpha + sum_i z_i A_i + r delta_1
    g1_b = beta_1 + sum_i z_i B1_i + s delta_1   (zero when r == 0)
    g2_b = beta_2 + sum_i z_i B2_i + s delta_2
    g_c  = s g_a + r g1_b - rs delta_1 + sum_aux z L + sum h_i H_i

Stages (their names are the JAX prover's): witness_eval (the device
evaluator, circuit/witness_eval.py; the host interpreter for a graph it
rejects), qap_witness_map, from_mont, msm_ab1l (a/b1/l as one
FusedMSMGroup), msm_b2, msm_h, host_assembly (native batched blinding
assembly). Everything before host_assembly runs on the prover's device.

Partial/finish (reference rln/src/partial_proof.rs:108-299): the witness is
split by a known-mask; prove_partial precomputes the four MSMs over the
known entries (with the alpha/beta offsets), finish_proof runs the
complement MSMs, the h MSM and the blinding algebra.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circuit import graph as graphmod
from ..circuit import witness_host
from ..circuit.witness_eval import UnsupportedGraph, WitnessEvaluator, compile_graph
from ..constants import NUM_LIMBS, R
from ..ff.field import FrField, encode_canonical_fast, resolve_device
from ..ff.fq2 import Fq2Adapter, FqAdapter
from ..hostmath import bn254
from ..runtime.profiling import stage_timer
from .msm import LANE_BATCH, MSM, FusedMSMGroup
from .qap import WitnessMapper

Proof = Tuple[object, object, object]  # (a: G1 affine, b: G2 affine, c: G1 affine)

MIN_BATCH = 4
# lanes per witness-evaluator pass: wider batches stream through passes of
# this width (its cost is the step chain, nearly flat in lanes; PERF.md)
EVAL_CHUNK = 256


def _padded_batch(b: int) -> int:
    """Pads batch sizes to powers of two (at least MIN_BATCH)."""
    n = MIN_BATCH
    while n < b:
        n *= 2
    return n


@dataclass
class PartialProof:
    """Precomputed partial proof (reference partial_proof.rs:30-43).

    mask[i] refers to assignment entry i of (instance[1:] || witness),
    i.e. the full assignment without its leading constant-1 wire.
    """

    mask: List[bool]
    partial_pi_a: object  # G1 affine
    partial_rho: object  # G1 affine
    partial_pi_b: object  # G2 affine
    partial_pi_c: object  # G1 affine


class ProverError(ValueError):
    pass


class Groth16Prover:
    def __init__(self, zkey, graph: graphmod.Graph, device="cuda"):
        """zkey: a Zkey parsed by either package (the proving key carries
        over as plain ints); graph: the witness graph (None when callers
        hand in assignments). A graph that compile_graph rejects (Pow, Idiv,
        Mod, Shl, UnoOp::Id) is evaluated by the host interpreter; that is
        decided here, from the graph."""
        self.zkey = zkey
        self.graph = graph
        self.device = resolve_device(device)
        try:
            compiled = compile_graph(graph) if graph is not None else None
        except UnsupportedGraph:
            compiled = None
        self.evaluator: Optional[WitnessEvaluator] = (
            WitnessEvaluator(compiled, self.device) if compiled is not None else None)
        pk = zkey.pk
        self.num_inputs = zkey.matrices.num_instance_variables
        self.n_wires = len(pk.a_query)
        self.mapper = WitnessMapper(zkey.matrices, self.device)
        self.msm_a = MSM(pk.a_query, FqAdapter, self.device)
        self.msm_b1 = MSM(pk.b_g1_query, FqAdapter, self.device)
        self.msm_b2 = MSM(pk.b_g2_query, Fq2Adapter, self.device)
        self.msm_h = MSM(pk.h_query, FqAdapter, self.device)
        self.msm_l = MSM(pk.l_query, FqAdapter, self.device)
        # a/b1/l share one padded size on real circuits: one pass for all three
        self._g1_group = None
        # canonical scalars and affine MSM results of the last batch proved,
        # kept for checks against host MSMs
        self.last_batch: Dict[str, object] = {}
        if self.msm_a.n == self.msm_b1.n == self.msm_l.n:
            self._g1_group = FusedMSMGroup([self.msm_a, self.msm_b1, self.msm_l])

    def warm_up(self) -> None:
        """Runs once what a first batch runs, so that a service's first
        request does not: the five MSMs' window tables (whose EC launches
        build the kernel library, nvcc at first use, on the card), then a
        throwaway batch of one through prove_batch (the evaluator's slot
        buffer, the first launch of every kernel and torch op of the path).
        The batch holds seeded values in every input of the graph, so its
        proof proves nothing. Without a graph, the tables alone."""
        for msm in (self.msm_a, self.msm_b1, self.msm_b2, self.msm_h, self.msm_l):
            msm.tables()
        if self._g1_group is not None:
            self._g1_group.tables_cat()
        if self.graph is not None:
            rng = random.Random(0)
            named = {name: [[rng.randrange(R)] for _ in range(size)]
                     for name, (_, size) in self.graph.input_mapping.items()}
            self.prove_batch(named, [rng.randrange(R)], [rng.randrange(R)])

    def _stage(self, metrics, name: str):
        return stage_timer(metrics, name, self.device)

    # -- witness evaluation --------------------------------------------------

    def full_assignments(self, named_inputs: Dict[str, Sequence[Sequence[int]]], batch: int):
        """Montgomery assignment (16, n_wires, B) on the device. With the
        device evaluator, each EVAL_CHUNK pass is padded to its power-of-two
        size class (the padding lanes replicate lane 0), so B may exceed
        batch and callers slice back down; the host interpreter gives
        B = batch."""
        if self.evaluator is None:
            return self._host_assignments(named_inputs, batch)
        if batch > EVAL_CHUNK:
            parts = []
            for lo in range(0, batch, EVAL_CHUNK):
                hi = min(lo + EVAL_CHUNK, batch)
                sub = {name: [col[lo:hi] for col in cols] for name, cols in named_inputs.items()}
                parts.append(self.full_assignments(sub, hi - lo))
            return torch.cat(parts, dim=2)
        target = _padded_batch(batch)
        if target != batch:
            named_inputs = {
                name: [list(col) + [col[0]] * (target - batch) for col in cols]
                for name, cols in named_inputs.items()
            }
        buf = self.evaluator.build_input_buffer(named_inputs, target)
        out = self.evaluator.evaluate_mont(buf)
        # scrub the host input buffer (it holds identity-secret limbs): the
        # device's copy of it completed inside evaluate_mont (a blocking
        # copy); reference semantics: iden3calc.rs:44-57 zeroizes it
        buf.fill(0)
        return out

    def _host_assignments(self, named_inputs, batch: int):
        """The host witness interpreter, one lane at a time."""
        cols = []
        for b in range(batch):
            single = {k: [col[b] for col in v] for k, v in named_inputs.items()}
            cols.append(witness_host.calc_witness(single, self.graph))
        flat = [cols[b][i] for i in range(self.n_wires) for b in range(batch)]
        canon = encode_canonical_fast(flat).reshape(NUM_LIMBS, self.n_wires, batch)
        return FrField.to_mont(canon.to(self.device))

    # -- full proving --------------------------------------------------------

    def prove_batch(
        self,
        named_inputs: Dict[str, Sequence[Sequence[int]]],
        rs: Sequence[int],
        ss: Sequence[int],
        metrics=None,
    ) -> List[Proof]:
        batch = len(rs)
        with self._stage(metrics, "witness_eval"):
            assignment = self.full_assignments(named_inputs, batch)
        return self.prove_batch_with_assignment(assignment, rs, ss, metrics=metrics)

    def prove_batch_with_assignment(self, assignment, rs, ss, metrics=None) -> List[Proof]:
        """assignment: (16, n_wires, B) Montgomery limbs; B = len(rs)."""
        batch = len(rs)
        assignment = assignment.to(self.device)
        if batch > LANE_BATCH:  # stream wide batches through LANE_BATCH passes
            proofs: List[Proof] = []
            for lo in range(0, batch, LANE_BATCH):
                hi = min(lo + LANE_BATCH, batch)
                proofs.extend(
                    self.prove_batch_with_assignment(
                        assignment[:, :, lo:hi], rs[lo:hi], ss[lo:hi], metrics=metrics
                    )
                )
            if metrics is not None:
                metrics.batch = batch
            return proofs
        target = _padded_batch(batch)
        if assignment.shape[2] < target:
            reps = assignment[:, :, :1].expand(-1, -1, target - assignment.shape[2])
            assignment = torch.cat([assignment, reps], dim=2)
        assignment = assignment.contiguous()
        if metrics is not None:
            metrics.batch = batch
        with self._stage(metrics, "qap_witness_map"):
            h = self.mapper.witness_map(assignment)
        with self._stage(metrics, "from_mont"):
            z_canon = FrField.from_mont(assignment)
            h_canon = FrField.from_mont(h)
        if self._g1_group is not None:
            with self._stage(metrics, "msm_ab1l"):
                l_aux = z_canon[:, self.num_inputs :]
                acc_a, acc_b1, acc_l = self._g1_group([z_canon, z_canon, l_aux])
                a_pts = self.msm_a.to_affine_ints(acc_a)
                b1_pts = self.msm_b1.to_affine_ints(acc_b1)
                l_pts = self.msm_l.to_affine_ints(acc_l)
        else:
            with self._stage(metrics, "msm_a"):
                a_pts = self.msm_a.to_affine_ints(self.msm_a(z_canon))
            with self._stage(metrics, "msm_b1"):
                b1_pts = self.msm_b1.to_affine_ints(self.msm_b1(z_canon))
            with self._stage(metrics, "msm_l"):
                l_aux = z_canon[:, self.num_inputs :]
                l_pts = self.msm_l.to_affine_ints(self.msm_l(l_aux))
        with self._stage(metrics, "msm_b2"):
            b2_pts = self.msm_b2.to_affine_ints(self.msm_b2(z_canon))
        with self._stage(metrics, "msm_h"):
            h_pts = self.msm_h.to_affine_ints(self.msm_h(h_canon))

        self.last_batch = {
            "z_canon": z_canon, "h_canon": h_canon,
            "a": a_pts, "b1": b1_pts, "b2": b2_pts, "l": l_pts, "h": h_pts,
        }
        pk = self.zkey.pk
        from ..runtime import native

        with self._stage(metrics, "host_assembly"):
            if native.assemble_available():
                # one native call for the whole batch (native/pairing.cpp
                # rln_groth16_assemble_batch)
                return native.groth16_assemble_batch_native(
                    pk, a_pts[:batch], b1_pts[:batch], b2_pts[:batch],
                    l_pts[:batch], h_pts[:batch], rs, ss,
                )
            return [
                self._assemble(
                    pk, rs[b], ss[b], a_pts[b], b1_pts[b], b2_pts[b], l_pts[b], h_pts[b]
                )
                for b in range(batch)
            ]

    @staticmethod
    def _assemble(pk, r, s, a_pt, b1_pt, b2_pt, l_pt, h_pt) -> Proof:
        """Per-proof blinding algebra (ark-groth16 semantics; reference math
        partial_proof.rs:237-268): native small linear combinations when the
        library loads, Python big integers otherwise."""
        from ..runtime import native

        r, s = r % R, s % R
        if native.pairing_available():
            g_a = native.g1_msm_native([pk.vk.alpha_g1, a_pt, pk.delta_g1], [1, 1, r])
            g1_b = (
                native.g1_msm_native([pk.beta_g1, b1_pt, pk.delta_g1], [1, 1, s])
                if r != 0
                else None
            )
            g2_b = native.g2_msm_native([pk.vk.beta_g2, b2_pt, pk.vk.delta_g2], [1, 1, s])
            g_c = native.g1_msm_native(
                [g_a, g1_b, pk.delta_g1, l_pt, h_pt],
                [s, r, (R - r * s % R) % R, 1, 1],
            )
            return (g_a, g2_b, g_c)
        g_a = bn254.G1.add(pk.vk.alpha_g1, a_pt)
        g_a = bn254.G1.add(g_a, bn254.G1.mul(pk.delta_g1, r))
        if r != 0:
            g1_b = bn254.G1.add(pk.beta_g1, b1_pt)
            g1_b = bn254.G1.add(g1_b, bn254.G1.mul(pk.delta_g1, s))
        else:
            g1_b = None
        g2_b = bn254.G2.add(pk.vk.beta_g2, b2_pt)
        g2_b = bn254.G2.add(g2_b, bn254.G2.mul(pk.vk.delta_g2, s))
        g_c = bn254.G1.add(bn254.G1.mul(g_a, s), bn254.G1.mul(g1_b, r))
        g_c = bn254.G1.add(g_c, bn254.G1.neg(bn254.G1.mul(pk.delta_g1, r * s % R)))
        g_c = bn254.G1.add(g_c, l_pt)
        g_c = bn254.G1.add(g_c, h_pt)
        return (g_a, g2_b, g_c)

    # -- partial / finish ----------------------------------------------------

    def _shifted_mask(self, mask: Sequence[bool]) -> np.ndarray:
        """PartialProof mask (len n_wires-1) -> per-wire mask incl. wire 0."""
        if len(mask) != self.n_wires - 1:
            raise ProverError(
                f"mask length {len(mask)} != {self.n_wires - 1} assignment entries"
            )
        return np.concatenate([[True], np.asarray(mask, dtype=bool)])

    def _lanes(self, x: torch.Tensor) -> torch.Tensor:
        """(16, n, 1) -> (16, n, _padded_batch(1)) on the device, the lanes
        replicating lane 0."""
        width = _padded_batch(1)
        return x.to(self.device).expand(-1, -1, width).contiguous()

    def prove_partial(self, partial_values: Sequence[Optional[int]]) -> PartialProof:
        """partial_values: assignment entries (instance[1:] || witness), None =
        unknown (reference PartialAssignment, partial_proof.rs:17-28)."""
        mask = [v is not None for v in partial_values]
        wire_mask = self._shifted_mask(mask)
        z = [1] + [0 if v is None else int(v) for v in partial_values]
        z_canon = self._lanes(encode_canonical_fast(z).reshape(NUM_LIMBS, self.n_wires, 1))
        m = torch.from_numpy(wire_mask[:, None])
        a_pt = self.msm_a.to_affine_ints(self.msm_a(z_canon, mask=m))[0]
        b1_pt = self.msm_b1.to_affine_ints(self.msm_b1(z_canon, mask=m))[0]
        b2_pt = self.msm_b2.to_affine_ints(self.msm_b2(z_canon, mask=m))[0]
        aux = z_canon[:, self.num_inputs :]
        l_pt = self.msm_l.to_affine_ints(self.msm_l(aux, mask=m[self.num_inputs :]))[0]
        pk = self.zkey.pk
        # alpha/beta offsets are folded in at prove_partial time
        # (partial_proof.rs:159-170); a_query[0] (wire 0) is in the masked
        # MSM above since wire 0 is always "known".
        pi_a = bn254.G1.add(pk.vk.alpha_g1, a_pt)
        rho = bn254.G1.add(pk.beta_g1, b1_pt)
        pi_b = bn254.G2.add(pk.vk.beta_g2, b2_pt)
        return PartialProof(
            mask=mask, partial_pi_a=pi_a, partial_rho=rho, partial_pi_b=pi_b, partial_pi_c=l_pt
        )

    def finish_proof(self, partial: PartialProof, assignment: torch.Tensor, r: int,
                     s: int) -> Proof:
        """assignment: (16, n_wires, 1) Montgomery limbs of the full witness."""
        wire_known = self._shifted_mask(partial.mask)
        # complement mask: unknown wires only; wire 0 was covered by partial
        m = torch.from_numpy((~wire_known)[:, None])
        assignment = self._lanes(assignment[:, :, :1])
        h = self.mapper.witness_map(assignment)
        z_canon = FrField.from_mont(assignment)
        h_canon = FrField.from_mont(h)
        a_rem = self.msm_a.to_affine_ints(self.msm_a(z_canon, mask=m))[0]
        b1_rem = self.msm_b1.to_affine_ints(self.msm_b1(z_canon, mask=m))[0]
        b2_rem = self.msm_b2.to_affine_ints(self.msm_b2(z_canon, mask=m))[0]
        aux = z_canon[:, self.num_inputs :]
        l_rem = self.msm_l.to_affine_ints(self.msm_l(aux, mask=m[self.num_inputs :]))[0]
        h_acc = self.msm_h.to_affine_ints(self.msm_h(h_canon))[0]

        pk = self.zkey.pk
        r %= R
        s %= R
        g_a = bn254.G1.add(partial.partial_pi_a, a_rem)
        g_a = bn254.G1.add(g_a, bn254.G1.mul(pk.delta_g1, r))
        if r != 0:
            g1_b = bn254.G1.add(partial.partial_rho, b1_rem)
            g1_b = bn254.G1.add(g1_b, bn254.G1.mul(pk.delta_g1, s))
        else:
            g1_b = None
        g2_b = bn254.G2.add(partial.partial_pi_b, b2_rem)
        g2_b = bn254.G2.add(g2_b, bn254.G2.mul(pk.vk.delta_g2, s))
        l_acc = bn254.G1.add(partial.partial_pi_c, l_rem)
        g_c = bn254.G1.add(bn254.G1.mul(g_a, s), bn254.G1.mul(g1_b, r))
        g_c = bn254.G1.add(g_c, bn254.G1.neg(bn254.G1.mul(pk.delta_g1, r * s % R)))
        g_c = bn254.G1.add(g_c, l_acc)
        g_c = bn254.G1.add(g_c, h_acc)
        return (g_a, g2_b, g_c)


def random_batch_inputs(rng, batch: int, depth: int):
    """(named inputs, r values, s values) of one batch of RLN witnesses from
    a numpy Generator: the named inputs shaped as RLN.generate_proofs builds
    them (name -> slots -> lanes), with seeded Fr values, userMessageLimit
    100 and messageId 1."""

    def fr():
        return int.from_bytes(rng.bytes(32), "little") % R

    lanes = []
    for _ in range(batch):
        lanes.append({
            "identitySecret": [fr()],
            "userMessageLimit": [100],
            "messageId": [1],
            "pathElements": [fr() for _ in range(depth)],
            "identityPathIndex": [int(v) for v in rng.integers(0, 2, size=depth)],
            "x": [fr()],
            "externalNullifier": [fr()],
        })
    named = {
        name: [[lane[name][slot] for lane in lanes] for slot in range(len(lanes[0][name]))]
        for name in lanes[0]
    }
    rs = [fr() for _ in range(batch)]
    ss = [fr() for _ in range(batch)]
    return named, rs, ss
