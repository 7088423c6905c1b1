"""Distributed NTT over the mesh's tp ranks (Bailey four-step with all_to_all).

Counterpart of zerokit_tpu/parallel/ntt_sharded.py, on the kernels' (16, B,
N) layout (ff/ntt_kernels.py). The domain splits N = n1 * n2 with n1 = D,
the tp size, and the coefficients are viewed as A[i1][i2], i = i1 * n2 + i2:

    1. tp rank t takes all rows i1 of its columns i2 in [t * m, (t + 1) * m),
       m = n2 / D (the "columns" layout);
    2. the length-n1 DFT over i1 (K1 products and adds);
    3. the twiddle by g_N^(k1 * i2) (K1);
    4. all_to_all over tp: rank t receives row k1 = t of every column;
    5. the local length-n2 NTT over i2 (groth16/ntt.natural_ntt: K4 + K5),
       1/N fused into it on the inverse.

Rank t ends with X[t + n1 * k2] for k2 = 0 .. n2 - 1 (the "rows" layout,
strided in the natural index). sharded_fft gathers the rows over tp into
the natural-order spectrum on every rank; rows_to_columns is the second
all_to_all that brings the rows back to the columns layout, so that a
second transform (the QAP's coset lift) needs no gather in between. Results
equal the single-device NTT's (tests/test_torch_ntt_sharded.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..constants import R
from ..ff.field import FR, FrField
from ..groth16 import ntt
from .sharded import Mesh, all_gather, all_to_all


def fits(n: int, d: int) -> bool:
    """Whether a domain of n splits over d tp ranks: n = d * n2 with n2 a
    power of two whose columns divide among the d ranks."""
    if d < 1 or n % d:
        return False
    n2 = n // d
    return n2 & (n2 - 1) == 0 and n2 % d == 0


def _encode(vals) -> np.ndarray:
    return FR.encode(vals).numpy()


@functools.lru_cache(maxsize=None)
def _small_dft_matrix(n1: int, inverse: bool) -> np.ndarray:
    """(16, n1, n1) Montgomery matrix W[k][i] = g^(ik), g of order n1."""
    g = ntt.domain_generator(n1)
    if inverse:
        g = pow(g, -1, R)
    return _encode([[pow(g, (i * k) % n1, R) for i in range(n1)] for k in range(n1)])


@functools.lru_cache(maxsize=None)
def _twiddle_block(n: int, n1: int, inverse: bool) -> np.ndarray:
    """(16, n1, n2) Montgomery table g_N^(k1 * i2)."""
    g = ntt.domain_generator(n)
    if inverse:
        g = pow(g, -1, R)
    n2 = n // n1
    return _encode([[pow(g, (k1 * i2) % n, R) for i2 in range(n2)] for k1 in range(n1)])


def _table(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32)).to(like.device)


def _local_small_dft(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """x (16, B, n1, m) -> y[k1] = sum_i1 W[k1][i1] x[i1]: the n1 * n1
    products in one K1 call, then n1 - 1 adds."""
    l, b, n1, m = x.shape
    shape = (l, b, n1, n1, m)  # (.., k1, i1, ..)
    w = _table(mat, x)[:, None, :, :, None].expand(shape)
    prod = FrField.mul(x[:, :, None].expand(shape), w)
    y = prod[:, :, :, 0]
    for i1 in range(1, n1):
        y = FrField.add(y, prod[:, :, :, i1])
    return y


def columns(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """values (16, B, N), the same on every tp rank -> this rank's columns
    (16, B, n1, m)."""
    l, b, n = values.shape
    d, t = mesh.tp, mesh.tp_index
    if not fits(n, d):
        raise ValueError(f"domain {n} does not split into {d} x a power of two")
    m = n // d // d
    return values.reshape(l, b, d, n // d)[..., t * m : (t + 1) * m]


def bailey(cols: torch.Tensor, mesh: Mesh, inverse: bool = False) -> torch.Tensor:
    """Steps 2-5 above: this rank's columns (16, B, n1, m) -> its rows
    (16, B, n2) of the natural-order (i)NTT of the whole domain."""
    l, b, n1, m = cols.shape
    n2 = n1 * m
    n = n1 * n2
    t = mesh.tp_index
    y = _local_small_dft(cols, _small_dft_matrix(n1, inverse))
    tw = _table(_twiddle_block(n, n1, inverse), y)[:, None, :, t * m : (t + 1) * m]
    y = FrField.mul(y, tw.expand(y.shape))
    # rank k1 receives row k1 of every rank's columns, in rank order
    recv = all_to_all(mesh, y.permute(2, 0, 1, 3))  # (n1 ranks, 16, B, m)
    rows = recv.permute(1, 2, 0, 3).reshape(l, b, n2)
    return ntt.natural_ntt(rows, inverse, pow(n, -1, R) if inverse else 1)


def gather_rows(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every tp rank's rows (16, B, n2) -> the natural order (16, B, N) on
    every rank (X[k1 + n1 * k2] is rank k1's k2-th value)."""
    l, b, n2 = rows.shape
    full = all_gather(mesh, rows)  # (n1, 16, B, n2)
    return full.permute(1, 2, 3, 0).reshape(l, b, n2 * mesh.tp)


@functools.lru_cache(maxsize=None)
def _rows_to_columns_plan(n: int, d: int, t: int) -> Tuple[np.ndarray, list, list, np.ndarray]:
    """The exchange that takes rank t's rows to its columns: (the order in
    which t sends its row values, grouped by destination; the counts it
    sends to each rank; the counts it receives from each; the position in
    t's columns block of each value received, in arrival order)."""
    n2 = n // d
    m = n2 // d

    def rows_of(r):  # global indices of rank r's row values, in local order
        return r + d * np.arange(n2)

    def dest_pos(idx):  # (destination rank, position in its (n1, m) block)
        i1, i2 = np.divmod(idx, n2)
        dest, j = np.divmod(i2, m)
        return dest, i1 * m + j

    dest, pos = dest_pos(rows_of(t))
    send = np.lexsort((pos, dest))
    in_splits = np.bincount(dest, minlength=d).tolist()
    arrivals, out_splits = [], []
    for src in range(d):
        sd, sp = dest_pos(rows_of(src))
        mine = np.sort(sp[sd == t])
        arrivals.append(mine)
        out_splits.append(len(mine))
    return send, in_splits, out_splits, np.concatenate(arrivals)


def rows_to_columns(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The second all_to_all: this rank's rows (16, B, n2) -> its columns
    (16, B, n1, m) of the same values, the input layout of bailey."""
    l, b, n2 = rows.shape
    d = mesh.tp
    send, in_splits, out_splits, arrivals = _rows_to_columns_plan(n2 * d, d, mesh.tp_index)
    idx = torch.from_numpy(send).to(rows.device)
    recv = all_to_all(mesh, rows.index_select(2, idx).permute(2, 0, 1), in_splits,
                      out_splits)  # (n1 * m, 16, B) in arrival order
    inv = torch.from_numpy(np.argsort(arrivals)).to(rows.device)
    return recv.index_select(0, inv).permute(1, 2, 0).reshape(l, b, d, n2 // d)


def row_powers(n: int, root: int, mesh: Mesh, like: torch.Tensor) -> torch.Tensor:
    """(16, 1, n2) table root^(t + n1 * k2) of this rank's rows."""
    return _table(ntt.power_table(n, root)[:, mesh.tp_index :: mesh.tp], like)[:, None, :]


def sharded_fft(values: torch.Tensor, mesh: Mesh, inverse: bool = False) -> torch.Tensor:
    """values (16, B, N), the same on every tp rank -> the natural-order
    (i)NTT (16, B, N) on every rank, through the Bailey exchange and a
    gather of the rows."""
    return gather_rows(bailey(columns(values, mesh), mesh, inverse), mesh)


def sharded_coset_lift(values: torch.Tensor, mesh: Mesh, root: int) -> torch.Tensor:
    """fft(distribute_powers(ifft(values), root)) of (16, B, N), the same on
    every tp rank, as this rank's rows (16, B, n2): inverse Bailey,
    the rows' powers (K1), rows_to_columns, forward Bailey."""
    n = values.shape[2]
    poly = bailey(columns(values, mesh), mesh, inverse=True)
    poly = FrField.mul(poly, row_powers(n, root, mesh, poly).expand(poly.shape))
    return bailey(rows_to_columns(poly, mesh), mesh)
