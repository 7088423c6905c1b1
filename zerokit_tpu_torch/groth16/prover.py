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
Between witness_eval and the witness map, outside every stage, the span
host.public reads the batch's public wires z[1:num_inputs] to the host
(public_wires): each proof attests to exactly these values, so
prove_batch_public hands them back beside the proofs.

Partial/finish (reference rln/src/partial_proof.rs:108-299): the witness is
split by a known-mask; prove_partial precomputes the four MSMs over the
known entries (with the alpha/beta offsets), finish_proof runs the
complement MSMs, the h MSM and the blinding algebra.

With a mesh (parallel/sharded.py), every rank calls the same methods with
the same inputs (SPMD). The batch pads to _padded_batch(max(batch, dp))
lanes and dp rank d takes its contiguous share of them: it evaluates those
witnesses (W1), maps them (the QAP lift sharded over tp when the domain
splits, parallel/ntt_sharded.py) and runs their MSMs through ShardedMSMs
(points sharded over tp). The affine MSM results are gathered over dp
(stage dp_gather) with the lanes' public wires, and every rank assembles
and returns the whole batch's proofs and public wires, the proofs equal to
the single-device proofs at the same (r, s). One device
runs the same path with all lanes its own and no gather.
prove_partial / finish_proof run through the same ShardedMSMs, whose
__call__ splits and gathers the lanes over dp itself.
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
from ..ff.field import FrField, decode_canonical_fast, encode_canonical_fast, resolve_device
from ..ff.fq2 import Fq2Adapter, FqAdapter
from ..hostmath import bn254
from ..runtime.profiling import span, stage_timer
from .msm import LANE_BATCH, MSM, FusedMSMGroup, _pad_lanes
from .qap import WitnessMapper

Proof = Tuple[object, object, object]  # (a: G1 affine, b: G2 affine, c: G1 affine)

MIN_BATCH = 4
_POINT_KEYS = ("a", "b1", "b2", "l", "h")
# lanes per witness-evaluator pass: wider batches stream through passes of
# this width (its cost is the step chain, nearly flat in lanes; PERF.md)
EVAL_CHUNK = 256


def _padded_batch(b: int) -> int:
    """Pads batch sizes to powers of two (at least MIN_BATCH)."""
    n = MIN_BATCH
    while n < b:
        n *= 2
    return n


def public_wires(assignment: torch.Tensor, num_inputs: int) -> List[List[int]]:
    """The public wires z[1:num_inputs] of every lane of the Montgomery
    assignment (16, n_wires, B), canonical, one list a lane: one product
    by 1 on the device over the small slice, then one copy to the host."""
    canon = FrField.from_mont(assignment[:, 1:num_inputs])
    vals = decode_canonical_fast(canon.cpu())  # wire-major: vals[i * B + b]
    width = assignment.shape[2]
    return [vals[b::width] for b in range(width)]


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
    def __init__(self, zkey, graph: graphmod.Graph, device="cuda", mesh=None):
        """zkey: a Zkey parsed by either package (the proving key carries
        over as plain ints); graph: the witness graph (None when callers
        hand in assignments). A graph that compile_graph rejects (Pow, Idiv,
        Mod, Shl, UnoOp::Id) is evaluated by the host interpreter; that is
        decided here, from the graph. mesh: a parallel.sharded.Mesh to prove
        over, on the mesh's device (device is then not read); None proves
        on `device` alone."""
        self.zkey = zkey
        self.graph = graph
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        try:
            compiled = compile_graph(graph) if graph is not None else None
        except UnsupportedGraph:
            compiled = None
        self.evaluator: Optional[WitnessEvaluator] = (
            WitnessEvaluator(compiled, self.device) if compiled is not None else None)
        pk = zkey.pk
        self.num_inputs = zkey.matrices.num_instance_variables
        self.n_wires = len(pk.a_query)
        self.mapper = WitnessMapper(zkey.matrices, self.device, mesh)
        if mesh is None:
            def make(points, adapter):
                return MSM(points, adapter, self.device)
        else:
            from ..parallel.sharded import ShardedMSM

            def make(points, adapter):
                return ShardedMSM(points, adapter, mesh)
        self.msm_a = make(pk.a_query, FqAdapter)
        self.msm_b1 = make(pk.b_g1_query, FqAdapter)
        self.msm_b2 = make(pk.b_g2_query, Fq2Adapter)
        self.msm_h = make(pk.h_query, FqAdapter)
        self.msm_l = make(pk.l_query, FqAdapter)
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
        with span("host.witness_inputs"):
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
        with span("host.witness_inputs"):
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

    def _batch_target(self, batch: int) -> int:
        """Power-of-two batch size class, at least the mesh's dp degree."""
        return _padded_batch(max(batch, self.mesh.dp if self.mesh is not None else 1))

    def _my_lanes(self, batch: int) -> slice:
        """The lanes this process proves: under a mesh, dp rank d's
        contiguous share of the batch padded to its size class; else the
        whole batch."""
        if self.mesh is None:
            return slice(0, batch)
        per = -(-self._batch_target(batch) // self.mesh.dp)
        return slice(self.mesh.dp_index * per, (self.mesh.dp_index + 1) * per)

    def prove_batch(
        self,
        named_inputs: Dict[str, Sequence[Sequence[int]]],
        rs: Sequence[int],
        ss: Sequence[int],
        metrics=None,
    ) -> List[Proof]:
        return self.prove_batch_public(named_inputs, rs, ss, metrics)[0]

    def prove_batch_public(
        self,
        named_inputs: Dict[str, Sequence[Sequence[int]]],
        rs: Sequence[int],
        ss: Sequence[int],
        metrics=None,
    ) -> Tuple[List[Proof], List[List[int]]]:
        """(every lane's proof, every lane's public wires z[1:num_inputs]
        as the proof attests to them, canonical). Counts the lanes under
        metrics.counts["public_from_assignment"]."""
        mine = self._my_lanes(len(rs))
        width = mine.stop - mine.start
        with span("prover.pad"):
            named = {
                name: [(list(col) + [col[0]] * (mine.stop - len(col)))[mine] for col in cols]
                for name, cols in named_inputs.items()
            }
        with self._stage(metrics, "witness_eval"):
            assignment = self.full_assignments(named, width)
        out = self._prove_lanes(assignment[:, :, :width], rs, ss, metrics)
        if metrics is not None:
            metrics.count("public_from_assignment", len(rs))
        return out

    def prove_batch_with_assignment(self, assignment, rs, ss, metrics=None) -> List[Proof]:
        """assignment: (16, n_wires, B) Montgomery limbs of the whole batch
        (on every rank under a mesh); B >= len(rs)."""
        mine = self._my_lanes(len(rs))
        assignment = _pad_lanes(assignment.to(self.device), mine.stop)[:, :, mine]
        return self._prove_lanes(assignment, rs, ss, metrics)[0]

    def _prove_lanes(self, assignment, rs, ss, metrics) -> Tuple[List[Proof], List[List[int]]]:
        """This process's lanes (16, n_wires, width): their public wires read
        to the host, then the witness map and the MSMs in passes of
        LANE_BATCH lanes (a ragged pass padded to its size class, its
        padding lanes replicating its first); under a mesh the affine
        results and the public wires are gathered over dp. Then every
        lane's proof, and every lane's public wires."""
        batch = len(rs)
        if metrics is not None:
            metrics.batch = batch
        with span("host.public"):
            publics = public_wires(assignment, self.num_inputs)
        points: Dict[str, list] = {key: [] for key in _POINT_KEYS}
        for lo in range(0, assignment.shape[2], LANE_BATCH):
            part = assignment[:, :, lo : lo + LANE_BATCH]
            width = part.shape[2]
            part = _pad_lanes(part, _padded_batch(width)).contiguous()
            res = self._affine_results(part, metrics)
            for key in _POINT_KEYS:
                points[key].extend(res[key][:width])
        if self.mesh is not None:
            from ..parallel.sharded import all_gather_object

            with self._stage(metrics, "dp_gather"):
                shares = all_gather_object(self.mesh, (points, publics), "dp")
            points = {key: [p for share, _ in shares for p in share[key]] for key in _POINT_KEYS}
            publics = [p for _, share in shares for p in share]
        points = {key: points[key][:batch] for key in _POINT_KEYS}
        self.last_batch.update(points)
        return self._assemble_batch(points, rs, ss, metrics), publics[:batch]

    def _affine_results(self, assignment, metrics) -> Dict[str, list]:
        """The witness map and the five MSMs of the lanes of assignment
        (16, n_wires, B): their affine results, one list per MSM."""
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
                a_pts = self.msm_a.to_affine_ints(self.msm_a.local(z_canon))
            with self._stage(metrics, "msm_b1"):
                b1_pts = self.msm_b1.to_affine_ints(self.msm_b1.local(z_canon))
            with self._stage(metrics, "msm_l"):
                l_aux = z_canon[:, self.num_inputs :]
                l_pts = self.msm_l.to_affine_ints(self.msm_l.local(l_aux))
        with self._stage(metrics, "msm_b2"):
            b2_pts = self.msm_b2.to_affine_ints(self.msm_b2.local(z_canon))
        with self._stage(metrics, "msm_h"):
            h_pts = self.msm_h.to_affine_ints(self.msm_h.local(h_canon))
        self.last_batch = {
            "z_canon": z_canon, "h_canon": h_canon,
            "a": a_pts, "b1": b1_pts, "b2": b2_pts, "l": l_pts, "h": h_pts,
        }
        return {"a": a_pts, "b1": b1_pts, "b2": b2_pts, "l": l_pts, "h": h_pts}

    def _assemble_batch(self, points, rs, ss, metrics) -> List[Proof]:
        batch = len(rs)
        pk = self.zkey.pk
        a_pts, b1_pts, b2_pts = points["a"], points["b1"], points["b2"]
        l_pts, h_pts = points["l"], points["h"]
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
        """(16, n, 1) -> (16, n, _batch_target(1)) on the device, the lanes
        replicating lane 0."""
        width = self._batch_target(1)
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
