"""CircomReduction witness map (snarkjs-compatible R1CS -> QAP) in torch.

Counterpart of zerokit_tpu/groth16/qap.py (reference semantics
rln/src/circuit/qap.rs:30-98): evaluate the A/B constraint rows on the
assignment, append the public inputs to A, C = A.*B on the constraint rows,
then h = coset(A)*coset(B) - coset(C), where coset(x) =
fft(distribute_powers(ifft(x), g_2N)).

On the card the row products run through K1 (ff/field_kernels.mont_mul)
and the three coset lifts as one batched pass through K4/K5
(ff/ntt_kernels.coset_lift_bn); CPU tensors take the plain versions.
Under a mesh whose tp ranks split the domain (parallel/ntt_sharded.fits),
every tp rank computes the rows for the lanes it is given and the lift is
the Bailey NTT over tp (parallel/ntt_sharded.sharded_coset_lift); h is
computed on each rank's rows and gathered over tp, so every tp rank
returns all of h, which each h-MSM shard reads its point range from.
witness_map runs under torch.profiler ranges qap.matvec and qap.coset_lift
(the split of tools/qap_profile.py); they cost nothing without a profiler.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..circuit.zkey import ConstraintMatrices
from ..constants import NUM_LIMBS
from ..ff.field import FR, FrField, _carry, resolve_device
from ..ff.ntt_kernels import coset_lift_bn
from ..parallel import ntt_sharded
from ..runtime.profiling import span
from . import ntt


class QAPError(ValueError):
    pass


class SparseMatrix:
    """Constraint matrix bucketed by padded row density.

    Rows are grouped into power-of-two nnz classes (pad = 2^ceil(log2 nnz));
    each bucket stores wire indices and Montgomery coefficients padded with
    (wire 0, coeff 0). The matvec is a gather, one batched multiply and a
    reshape-sum per bucket, then one permutation back to domain order."""

    def __init__(self, rows: List[List[Tuple[int, int]]], domain_size: int, device="cuda"):
        device = resolve_device(device)
        max_row_nnz = 1
        by_pad: dict = {}
        for r, row in enumerate(rows):
            if not row:
                continue
            max_row_nnz = max(max_row_nnz, len(row))
            pad = 1 << max(0, (len(row) - 1).bit_length())
            by_pad.setdefault(pad, []).append((r, row))
        self.buckets: List[Tuple[int, int, torch.Tensor, torch.Tensor]] = []
        out_rows: List[int] = []
        for pad in sorted(by_pad):
            rs = by_pad[pad]
            wires = np.zeros((len(rs), pad), dtype=np.int64)
            coeffs = [0] * (len(rs) * pad)
            for i, (r, row) in enumerate(rs):
                for j, (coeff, wire) in enumerate(row):
                    wires[i, j] = wire
                    coeffs[i * pad + j] = coeff
                out_rows.append(r)
            self.buckets.append(
                (
                    pad,
                    len(rs),
                    torch.from_numpy(wires.reshape(-1)).to(device),
                    FR.encode(coeffs).to(device),
                )
            )
        # perm[d] = concat position of row d's sum; absent rows -> zero slot
        n_used = len(out_rows)
        perm = np.full(domain_size, n_used, dtype=np.int64)
        for pos, r in enumerate(out_rows):
            perm[r] = pos
        self.perm = torch.from_numpy(perm).to(device)
        self.domain_size = domain_size
        self.max_row_nnz = max_row_nnz


def _reduce_partial(limbs: torch.Tensor, max_terms: int) -> torch.Tensor:
    """Reduces a (17, *batch) int64 value < max_terms * p to < p via
    conditional subtraction of p << j for j = ceil(log2 max_terms) .. 0."""
    n_bits = max(1, (max_terms - 1).bit_length())
    k = limbs.shape[0]
    for j in range(n_bits, -1, -1):
        pj = FR.p << j
        pj_col = torch.tensor(
            [(pj >> (16 * i)) & 0xFFFF for i in range(k)], dtype=torch.int64, device=limbs.device
        ).reshape((k,) + (1,) * (limbs.ndim - 1))
        diff, borrow = _carry(limbs - pj_col)
        limbs = torch.where(borrow[None] < 0, limbs, diff)
    return limbs[:NUM_LIMBS]


def sparse_matvec(matrix: SparseMatrix, assignment: torch.Tensor) -> torch.Tensor:
    """rows_out[r] = sum coeff * z[wire] over the row's nonzeros.

    assignment: (16, n_wires, B) Montgomery. Returns (16, domain_size, B)."""
    batch = assignment.shape[2]
    parts = []
    for pad, n_rows, wires, coeffs in matrix.buckets:
        z = assignment[:, wires]  # (16, n_rows*pad, B)
        prod = FrField.mul(z, coeffs[:, :, None].expand(z.shape))
        parts.append(prod.reshape(NUM_LIMBS, n_rows, pad, batch).to(torch.int64).sum(dim=2))
    zero = torch.zeros((NUM_LIMBS, 1, batch), dtype=torch.int64, device=assignment.device)
    cat = torch.cat(parts + [zero], dim=1)  # (16, n_used + 1, B)
    # a 17th limb absorbs the carries: the sum is < max_row_nnz * p < 2^270
    cat = torch.cat([cat, torch.zeros_like(cat[:1])], dim=0)
    limbs, _ = _carry(cat)
    red = _reduce_partial(limbs, matrix.max_row_nnz)
    return red[:, matrix.perm].to(torch.int32)


class WitnessMapper:
    """Witness map for one circuit's constraint matrices, on one device or
    over a mesh's tp ranks."""

    def __init__(self, matrices: ConstraintMatrices, device="cuda", mesh=None):
        """mesh: a parallel.sharded.Mesh; its device is used (device is then
        not read). The lift shards over tp when the domain splits over the
        tp ranks, else it runs on each rank whole (a layout decision: no
        sharded lift exists for that domain)."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.num_constraints = matrices.num_constraints
        self.num_inputs = matrices.num_instance_variables
        self.domain_size = ntt.domain_size_for(self.num_constraints + self.num_inputs)
        if mesh is not None and (mesh.tp == 1 or not ntt_sharded.fits(self.domain_size, mesh.tp)):
            mesh = None
        self.mesh = mesh
        self.a = SparseMatrix(matrices.a, self.domain_size, self.device)
        self.b = SparseMatrix(matrices.b, self.domain_size, self.device)
        self.root_2n = ntt.coset_root_2n(self.domain_size)

    def witness_map(self, assignment: torch.Tensor) -> torch.Tensor:
        """assignment: (16, n_wires, B) Montgomery -> h: (16, domain, B)."""
        batch = assignment.shape[2]
        with span("qap.matvec"):
            a = sparse_matvec(self.a, assignment)
            b = sparse_matvec(self.b, assignment)
            a[:, self.num_constraints : self.num_constraints + self.num_inputs] = assignment[
                :, : self.num_inputs
            ]
            # rows past num_constraints have b == 0, so c stays 0 there exactly
            # as the reference requires (qap.rs:60-67)
            c = FrField.mul(a, b)
        with span("qap.coset_lift"):
            # one batched lift for a/b/c on the kernels' (16, 3B, n) layout
            stacked = torch.cat([a, b, c], dim=2).transpose(1, 2).contiguous()
            if self.mesh is None:
                lifted = coset_lift_bn(stacked, self.root_2n)
            else:  # this tp rank's rows of the lifted values
                lifted = ntt_sharded.sharded_coset_lift(stacked, self.mesh, self.root_2n)
            la, lb, lc = lifted.split(batch, dim=1)
            h_bn = FrField.sub(FrField.mul(la, lb), lc)
            if self.mesh is not None:
                h_bn = ntt_sharded.gather_rows(h_bn, self.mesh)
            return h_bn.transpose(1, 2).contiguous()
