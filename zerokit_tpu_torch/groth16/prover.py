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

Partial/finish (reference rln/src/partial_proof.rs:108-299), batched: the
wires split by the prover's one known-mask, the graph's (every wire but
those reachable from the message inputs, witness_eval.unknown_mask; a
prover without a graph takes its first partial proof's), and a partial
proof of another mask is refused. On first use the prover builds MSMs
over the finite points of a, b1, b2 and l at the known wires and at the
unknown ones (MSM's `index`).
prove_partial_batch runs the known ones over the lanes of a partial
assignment (stage partial_msm; partial_assignments evaluates it on the
device, stage partial_witness) and folds in alpha and beta.
finish_batch / finish_batch_public run the passes of a full proof with
the unknown subsets in place of a/b1/b2/l (stage msm_finish): each lane's
partial sums are added on the device (span finish.sum) before to_affine,
and the native batched assembly blinds them as it blinds a full proof.
prove_partial / finish_proof are their one-lane calls.

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
The partial runs every lane on every rank through ShardedMSMs over the
known subsets; the finish splits its lanes over dp as a full proof does.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circuit import graph as graphmod
from ..circuit import witness_host
from ..circuit.witness_eval import UnsupportedGraph, WitnessEvaluator, compile_graph, unknown_mask
from ..constants import NUM_LIMBS, R
from ..ff.field import FrField, decode_canonical_fast, encode_canonical_fast, resolve_device
from ..ff.fq2 import Fq2Adapter, FqAdapter
from ..hostmath import bn254
from ..runtime.profiling import span, stage_timer
from .msm import LANE_BATCH, MSM, FusedMSMGroup, _pad_lanes, encode_affine_points, subset_size
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


@dataclass
class _Part:
    """The MSMs of a, b1, b2 and l over the finite points of one side of a
    known-mask: the wires a partial proof knows, or the rest, which the
    finish walks. a, b1 and l share one padded size and run as one
    FusedMSMGroup."""

    msms: Dict[str, MSM]
    group: Optional[FusedMSMGroup]
    points_g1eq: int  # finite points a lane, a G2 point counted as three


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
            def make(points, adapter, **subset):
                return MSM(points, adapter, self.device, **subset)
        else:
            from ..parallel.sharded import ShardedMSM

            def make(points, adapter, **subset):
                return ShardedMSM(points, adapter, mesh, **subset)
        self._make = make
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
        self.h_points = sum(p is not None for p in pk.h_query)
        # two-phase proving: the one known-mask and its (known, unknown) parts, on first use
        self._known: Optional[np.ndarray] = None
        self._known_entries: Optional[List[bool]] = None
        self._parts: Optional[Tuple[_Part, _Part]] = None
        self._parts_lock = threading.Lock()

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
        out = self._prove_lanes(self._mine_assignment(named_inputs, mine, metrics), rs, ss,
                                metrics)
        if metrics is not None:
            metrics.count("public_from_assignment", len(rs))
        return out

    def _mine_assignment(self, named_inputs, mine: slice, metrics) -> torch.Tensor:
        """The Montgomery assignment (16, n_wires, width) of this process's
        lanes of the batch (padded with lane 0 to the mesh's size class)."""
        width = mine.stop - mine.start
        with span("prover.pad"):
            named = {
                name: [(list(col) + [col[0]] * (mine.stop - len(col)))[mine] for col in cols]
                for name, cols in named_inputs.items()
            }
        with self._stage(metrics, "witness_eval"):
            return self.full_assignments(named, width)[:, :, :width]

    def prove_batch_with_assignment(self, assignment, rs, ss, metrics=None) -> List[Proof]:
        """assignment: (16, n_wires, B) Montgomery limbs of the whole batch
        (on every rank under a mesh); B >= len(rs)."""
        mine = self._my_lanes(len(rs))
        assignment = _pad_lanes(assignment.to(self.device), mine.stop)[:, :, mine]
        return self._prove_lanes(assignment, rs, ss, metrics)[0]

    def _prove_lanes(self, assignment, rs, ss, metrics,
                     results=None) -> Tuple[List[Proof], List[List[int]]]:
        """This process's lanes (16, n_wires, width): their public wires read
        to the host, then the witness map and the MSMs in passes of
        LANE_BATCH lanes (a ragged pass padded to its size class, its
        padding lanes replicating its first); under a mesh the affine
        results and the public wires are gathered over dp. Then every
        lane's proof, and every lane's public wires. results(part, lo)
        gives a pass's affine points, lo its first lane (default: a full
        proof's, _affine_results)."""
        if results is None:
            def results(part, lo):
                return self._affine_results(part, metrics)
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
            res = results(part, lo)
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

    @property
    def known_wires(self) -> np.ndarray:
        """(n_wires,) bool: the wires this prover's partial proofs know
        (_split's known-mask)."""
        self._split()
        return self._known

    def _shifted_mask(self, mask: Sequence[bool]) -> np.ndarray:
        """PartialProof mask (len n_wires-1) -> per-wire mask incl. wire 0."""
        if len(mask) != self.n_wires - 1:
            raise ProverError(
                f"partial mask has {len(mask)} entries, expected {self.n_wires - 1}"
            )
        return np.concatenate([[True], np.asarray(mask, dtype=bool)])

    def _split(self, mask: Optional[Sequence[bool]] = None) -> Tuple[_Part, _Part]:
        """The (known, unknown) parts of the prover's one known-mask, built
        on first use (their window tables at their first pass). The mask is
        the graph's: every wire but witness_eval.unknown_mask's. A prover
        without a graph takes the first mask (PartialProof.mask, entries
        1..) it is given. Any other mask raises ProverError: masks come
        from clients' bytes, and parts for each would fill the device."""
        with self._parts_lock:
            if self._parts is None:
                if self.graph is not None:
                    wire_known = ~unknown_mask(self.graph)
                elif mask is None:
                    raise ProverError("a prover without a graph takes its known-mask from its "
                                      "first partial proof")
                else:
                    wire_known = self._shifted_mask(mask)
                self._parts = (self._part(wire_known), self._part(~wire_known))
                self._known, self._known_entries = wire_known, [bool(k) for k in wire_known[1:]]
        if mask is not None and mask is not self._known_entries:
            self._shifted_mask(mask)
            if list(mask) != self._known_entries:
                raise ProverError("a partial proof's mask is not this prover's known-mask")
        return self._parts

    def _part(self, wires: np.ndarray) -> _Part:
        pk = self.zkey.pk
        queries = {"a": (pk.a_query, wires, FqAdapter), "b1": (pk.b_g1_query, wires, FqAdapter),
                   "b2": (pk.b_g2_query, wires, Fq2Adapter),
                   "l": (pk.l_query, wires[self.num_inputs:], FqAdapter)}
        index = {key: [i for i, p in enumerate(q) if on[i] and p is not None]
                 for key, (q, on, _) in queries.items()}
        g1 = subset_size(max(len(index[key]) for key in ("a", "b1", "l")))
        msms = {key: self._make(q, adapter, index=index[key], size=None if key == "b2" else g1)
                for key, (q, _, adapter) in queries.items()}
        group = None
        if msms["a"].n == msms["b1"].n == msms["l"].n:
            group = FusedMSMGroup([msms["a"], msms["b1"], msms["l"]])
        g1eq = len(index["a"]) + len(index["b1"]) + 3 * len(index["b2"]) + len(index["l"])
        return _Part(msms, group, g1eq)

    def finish_points(self) -> int:
        """The finite points a finish walks a lane (a G2 point counted as
        three): the unknown wires' of a, b1, b2 and l and all of h's."""
        return self._split()[1].points_g1eq + self.h_points

    def _part_accs(self, part: _Part, z_canon: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The projective accumulators (16, C, 3, B) of a part's four MSMs
        over the lanes of the canonical assignment z_canon (16, n_wires, B)."""
        aux = z_canon[:, self.num_inputs:]
        if part.group is not None:
            a, b1, l_acc = part.group([z_canon, z_canon, aux])
        else:
            a, b1, l_acc = (part.msms["a"].local(z_canon), part.msms["b1"].local(z_canon),
                            part.msms["l"].local(aux))
        return {"a": a, "b1": b1, "b2": part.msms["b2"].local(z_canon), "l": l_acc}

    def partial_assignments(self, named_inputs: Dict[str, Sequence[Sequence[int]]], batch: int,
                            metrics=None) -> torch.Tensor:
        """The Montgomery assignment (16, n_wires, batch) of `batch` partial
        witnesses, named as full_assignments takes them with the message
        inputs at 0: the wires those reach are unknown_mask's, which no
        partial proof reads."""
        with self._stage(metrics, "partial_witness"), span("partial.witness"):
            return self.full_assignments(named_inputs, batch)[:, :, :batch]

    def prove_partial_batch(self, assignment: torch.Tensor, metrics=None) -> List[PartialProof]:
        """One partial proof a lane of the Montgomery assignment (16,
        n_wires, B), whose unknown wires may hold anything: the MSMs over
        the known wires' finite points of the prover's known-mask (_split),
        alpha and beta folded in (partial_proof.rs:159-170). Counts the
        lanes under metrics.counts["partials_made"]."""
        known, _ = self._split()
        mask = self._known_entries
        batch = assignment.shape[2]
        with self._stage(metrics, "partial_msm"), span("partial.msm"):
            z_canon = FrField.from_mont(assignment.to(self.device))
            accs = self._part_accs(known, z_canon)
            pts = {key: known.msms[key].to_affine_ints(acc) for key, acc in accs.items()}
        pk = self.zkey.pk
        if metrics is not None:
            metrics.count("partials_made", batch)
        return [
            PartialProof(
                mask=mask,
                partial_pi_a=bn254.G1.add(pk.vk.alpha_g1, pts["a"][b]),
                partial_rho=bn254.G1.add(pk.beta_g1, pts["b1"][b]),
                partial_pi_b=bn254.G2.add(pk.vk.beta_g2, pts["b2"][b]),
                partial_pi_c=pts["l"][b],
            )
            for b in range(batch)
        ]

    def prove_partial(self, partial_values: Sequence[Optional[int]]) -> PartialProof:
        """partial_values: assignment entries (instance[1:] || witness), None =
        unknown (reference PartialAssignment, partial_proof.rs:17-28): the
        one-lane prove_partial_batch; the known entries must be the
        prover's known-mask."""
        self._split([v is not None for v in partial_values])
        z = [1] + [0 if v is None else int(v) for v in partial_values]
        canon = encode_canonical_fast(z).reshape(NUM_LIMBS, self.n_wires, 1)
        return self.prove_partial_batch(FrField.to_mont(canon.to(self.device)))[0]

    def finish_batch(self, partials: Sequence[PartialProof], assignment: torch.Tensor,
                     rs: Sequence[int], ss: Sequence[int], metrics=None) -> List[Proof]:
        """assignment: (16, n_wires, B) Montgomery limbs of the whole batch's
        full witnesses (on every rank under a mesh), B >= len(rs);
        partials: each lane's partial proof, of the prover's known-mask
        (_split; another raises ProverError). Each lane's
        proof, equal to the full proof at the same (r, s)."""
        mine = self._my_lanes(len(rs))
        assignment = _pad_lanes(assignment.to(self.device), mine.stop)[:, :, mine]
        return self._finish_lanes(partials, assignment, rs, ss, metrics)[0]

    def finish_batch_public(self, partials: Sequence[PartialProof],
                            named_inputs: Dict[str, Sequence[Sequence[int]]], rs: Sequence[int],
                            ss: Sequence[int], metrics=None) -> Tuple[List[Proof], List[List[int]]]:
        """finish_batch from the witnesses' named inputs, evaluated as
        prove_batch_public evaluates them: (every lane's proof, every lane's
        public wires)."""
        mine = self._my_lanes(len(rs))
        return self._finish_lanes(partials, self._mine_assignment(named_inputs, mine, metrics),
                                  rs, ss, metrics)

    def _finish_lanes(self, partials, assignment, rs, ss, metrics):
        """This process's lanes of a finish through _prove_lanes, with
        _finish_results for a pass's points. Counts the batch's lanes under
        finish_lanes and the finite points its MSMs walked (a G2 point as
        three) under finish_points_g1eq."""
        if len(partials) != len(rs):
            raise ProverError(f"{len(partials)} partial proofs for {len(rs)} lanes")
        for p in partials:
            self._split(p.mask)
        _, unknown = self._split()
        mine = self._my_lanes(len(rs))
        lanes = (list(partials) + [partials[0]] * (mine.stop - len(partials)))[mine]
        with self._stage(metrics, "msm_finish"):
            sums = self._partial_sums(unknown, lanes)

        def results(part, lo):
            width = part.shape[2]
            pass_sums = {key: _pad_lanes(v[..., lo:lo + width], width) for key, v in sums.items()}
            return self._finish_results(unknown, part, pass_sums, metrics)

        out = self._prove_lanes(assignment, rs, ss, metrics, results)
        if metrics is not None:
            metrics.count("finish_lanes", len(rs))
            metrics.count("finish_points_g1eq",
                          len(rs) * (unknown.points_g1eq + self.h_points))
        return out

    def _partial_sums(self, unknown: _Part, partials) -> Dict[str, torch.Tensor]:
        """The lanes' partial sums as the finish adds them to its own, on the
        device (16, C, 3, B) projective: each known-wire MSM, the alpha and
        beta that the partial proof folded in taken out again (the native
        assembly adds them), so that the sum is the whole MSM of a full
        proof."""
        pk = self.zkey.pk
        cols = {"a": ([p.partial_pi_a for p in partials], bn254.G1.neg(pk.vk.alpha_g1)),
                "b1": ([p.partial_rho for p in partials], bn254.G1.neg(pk.beta_g1)),
                "b2": ([p.partial_pi_b for p in partials], bn254.G2.neg(pk.vk.beta_g2)),
                "l": ([p.partial_pi_c for p in partials], None)}
        out = {}
        with span("finish.sum"):
            for key, (points, offset) in cols.items():
                msm = unknown.msms[key]
                cv = msm.curve
                if offset is not None:
                    points = points + [offset]
                proj = cv.from_affine(encode_affine_points(points, msm.adapter).to(self.device))
                if offset is not None:
                    lanes, off = proj[..., :-1], proj[..., -1:]
                    proj = cv.add(lanes, off.expand(lanes.shape))
                out[key] = proj
        return out

    def _finish_results(self, unknown: _Part, assignment, sums, metrics) -> Dict[str, list]:
        """A finish pass over the lanes of assignment (16, n_wires, B): the
        witness map, the unknown-wire MSMs plus the lanes' partial sums
        (sums, (16, C, 3, B) a query), and the h MSM: their affine results,
        one list per query, as _affine_results gives a full proof's."""
        with self._stage(metrics, "qap_witness_map"):
            h = self.mapper.witness_map(assignment)
        with self._stage(metrics, "from_mont"):
            z_canon = FrField.from_mont(assignment)
            h_canon = FrField.from_mont(h)
        with self._stage(metrics, "msm_finish"):
            accs = self._part_accs(unknown, z_canon)
            with span("finish.sum"):
                accs = {key: unknown.msms[key].curve.add(acc, sums[key])
                        for key, acc in accs.items()}
            pts = {key: unknown.msms[key].to_affine_ints(acc) for key, acc in accs.items()}
        with self._stage(metrics, "msm_h"):
            pts["h"] = self.msm_h.to_affine_ints(self.msm_h.local(h_canon))
        return pts

    def finish_proof(self, partial: PartialProof, assignment: torch.Tensor, r: int,
                     s: int) -> Proof:
        """assignment: (16, n_wires, >= 1) Montgomery limbs of the full
        witness: the one-lane finish_batch."""
        return self.finish_batch([partial], assignment[:, :, :1], [r], [s])[0]


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
