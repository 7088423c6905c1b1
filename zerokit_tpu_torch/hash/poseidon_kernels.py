"""P1, the batched Poseidon permutation (csrc/poseidon.cu), with its plain version.

P1 replaces zerokit_tpu/hash/poseidon.py `_batched_permutation(t)`, a
jitted lax.scan under XLA (not a Pallas kernel): t - 1 inputs of (16, n)
Montgomery Fr limbs -> state[0] of the permutation of [0, inputs...], for
t = 2..9.

P1 runs the permutation in its sparse partial-round form (sparse_form;
Grassi et al., "Poseidon", Appendix B): poseidon_mont_muls(t) products a
hash, 588 at t = 3 where the dense form takes 828. Its constant table is
built here from params_for_t, once per t and device. The plain version runs
the dense form round by round, as the JAX package does, so it is an oracle
independent of that table.

poseidon_perm takes each input as a (16, n) int32 tensor or view and passes
the kernel its data pointer, lane stride and limb stride, so a tree level
(16, 2n) serves as its own lefts (level[:, 0::2]) and rights
(level[:, 1::2]) with no copy. launch_shape picks each launch's shape
(threads a hash: 1, or t rounded up to a power of two for calls too small
to give every warp scheduler more than two warps; warps a block) from n,
t and the card's SM count, and passes it to the kernel.

A CUDA tensor launches the kernel (or raises); CPU tensors take
poseidon_perm_plain, which runs on any device on the plain field FrPlain
(ff/field.mont_mul_sos) and never launches a kernel, so it can also be held
against P1 on the card. `launches` counts P1 launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..constants import NUM_LIMBS, R
from ..ff import _cuda
from ..ff.field import FR, FrPlain
from ..ff.field_kernels import on_cuda
from .poseidon import PoseidonError, params_for_t

L = NUM_LIMBS
MAX_INPUTS = 8  # t = 9
WARP = 32
MAX_WARPS = 8  # warps a block, where the lanes fill every SM
launches = {"poseidon": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ---------------------------------------------------------------------------
# the sparse partial-round form (host ints mod r)
# ---------------------------------------------------------------------------


def _mat_mul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % R for j in range(len(b[0]))]
            for i in range(len(a))]


def _mat_inv(m):
    """Gauss-Jordan inverse mod r."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for c in range(n):
        p = next(r for r in range(c, n) if a[r][c])
        a[c], a[p] = a[p], a[c]
        inv = pow(a[c][c], R - 2, R)
        a[c] = [x * inv % R for x in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(x - f * y) % R for x, y in zip(a[r], a[c])]
    return [row[n:] for row in a]


class SparseForm(NamedTuple):
    """One width's permutation in the form P1 runs (values mod r, not
    Montgomery). Rounds 0..RF/2 - 1 and RF/2 + RP..RF + RP - 1 are full,
    the RP between them partial.

    full_ark: RF rows of t constants, the full rounds' in order. Row 0's
              lane 0 is unused: lane 0 enters round 0 as the constant
              0 + ark[0], whose x^5 times column 0 of round 0's matrix is
              folded into row 1.
    part_ark: RP constants, each partial round's lane 0 (its other lanes'
              constants are carried forward through the sparse factors
              into the next round's).
    mds:      the t x t MDS matrix M, every full round's mix but the one
              before the partial rounds; the last round computes row 0.
    first:    B = D_0 . M, the mix of full round RF/2 - 1.
    sparse:   RP pairs (row 0: t values, column 0 below it: t - 1 values)
              of each partial round's sparse factor S_k.

    Each partial round's matrix B_k (M for the last) splits as S_k . D_k,
    D_k = diag(1, B_k[1:, 1:]) and S_k the identity but for row 0 and
    column 0. D_k commutes with lane 0's x^5, so it moves, applied to the
    round's constants, into the round before: B_(k-1) = D_k . M, and D_0
    lands in full round RF/2 - 1's matrix."""

    t: int
    rf: int
    rp: int
    full_ark: List[List[int]]
    part_ark: List[int]
    mds: List[List[int]]
    first: List[List[int]]
    sparse: List[Tuple[List[int], List[int]]]


@functools.lru_cache(maxsize=None)
def sparse_form(t: int) -> SparseForm:
    rf, rp, ark, mds = params_for_t(t)
    half = rf // 2
    if half < 2:
        raise PoseidonError(f"t = {t}: the sparse form needs RF >= 4, got {rf}")
    mds = [list(row) for row in mds]
    consts = [list(ark[r * t:(r + 1) * t]) for r in range(rf + rp)]
    sparse, b = [None] * rp, mds
    for k in range(rp - 1, -1, -1):
        hat = [row[1:] for row in b[1:]]
        sparse[k] = ([b[0][0]] + _mat_mul([b[0][1:]], _mat_inv(hat))[0],
                     [row[0] for row in b[1:]])
        d = [[1] + [0] * (t - 1)] + [[0] + row for row in hat]
        consts[half + k] = [row[0] for row in _mat_mul(d, [[c] for c in consts[half + k]])]
        b = _mat_mul(d, mds)
    # S_k . (0, c_1..) = (row0 . (0, c_1..), c_1..): each partial round keeps
    # its lane-0 constant and carries the rest into the next round's
    for k in range(rp):
        c = consts[half + k]
        carry = [sum(x * y for x, y in zip(sparse[k][0][1:], c[1:]))] + c[1:]
        consts[half + k + 1] = [(x + y) % R for x, y in zip(consts[half + k + 1], carry)]
    x0 = pow(ark[0], 5, R)
    consts[1] = [(c + row[0] * x0) % R for c, row in zip(consts[1], mds)]
    return SparseForm(t, rf, rp, consts[:half] + consts[half + rp:],
                      [consts[half + k][0] for k in range(rp)], mds, b, sparse)


def table_values(t: int) -> list:
    """The kernel's constants in table order, Montgomery form: full_ark
    (RF x t), part_ark (RP), mds (t x t), first (t x t), then each partial
    round's row 0 and column 0 (RP x (2t - 1))."""
    f = sparse_form(t)
    vals = ([x for row in f.full_ark for x in row] + f.part_ark
            + [x for row in f.mds for x in row] + [x for row in f.first for x in row]
            + [x for row0, col0 in f.sparse for x in row0 + col0])
    return [FR.to_mont_int(v) for v in vals]


@functools.lru_cache(maxsize=None)
def _table(t: int, device: str) -> torch.Tensor:
    raw = b"".join(v.to_bytes(32, "little") for v in table_values(t))
    words = np.frombuffer(raw, dtype="<u4").view(np.int32).copy()
    return torch.from_numpy(words).to(device)


# ---------------------------------------------------------------------------
# the launch shape
# ---------------------------------------------------------------------------


def group_of(t: int) -> int:
    """Threads a hash in P1's group form: t rounded up to a power of two."""
    return 1 << (t - 1).bit_length()


def launch_shape(n: int, sm_count: int, t: int) -> Tuple[int, int, int]:
    """(blocks, threads a block, threads a hash) of P1 on n lanes of width
    t, the shape poseidon_perm launches. group_of(t) threads a hash where that
    gives the card's 4 x sm_count warp schedulers at most two warps each
    (a lone warp's hash is a chain of dependent products, which the group
    form halves), else one. The lanes (n x threads a hash) go in blocks of w warps, the
    largest power of two up to MAX_WARPS with w <= (their warps) /
    sm_count, else 1: a call of fewer warps than twice the SM count gets
    one-warp blocks, one an SM; above that, a block holds more than 4 warps
    (so a scheduler gets a second) only where the blocks outnumber the
    SMs."""
    g = group_of(t)
    if -(-n * g // WARP) > 2 * 4 * sm_count:
        g = 1
    lanes = n * g
    per_sm = -(-lanes // WARP) // sm_count
    w = 1
    while w < MAX_WARPS and 2 * w <= per_sm:
        w *= 2
    return -(-lanes // (w * WARP)), w * WARP, g


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the wrapper and the plain version
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _plain_consts(t: int, device: str):
    """(ark (16, RF + RP, t), mds (16, t, t)) Montgomery limb tensors of
    the dense form."""
    rf, rp, ark, mds = params_for_t(t)
    ark_mont = FR.encode(list(ark)).reshape(L, rf + rp, t)
    mds_mont = FR.encode([x for row in mds for x in row]).reshape(L, t, t)
    return ark_mont.to(device), mds_mont.to(device)


def _lanes(inputs: Sequence[torch.Tensor]) -> int:
    t = len(inputs) + 1
    if not 2 <= t <= MAX_INPUTS + 1:
        raise PoseidonError(f"no Poseidon parameters for input length {t - 1}")
    shape = inputs[0].shape
    if len(shape) != 2 or shape[0] != L or any(x.shape != shape for x in inputs):
        raise ValueError(f"poseidon_perm: expected (16, n) inputs of one shape, got "
                         f"{[tuple(x.shape) for x in inputs]}")
    return shape[1]


def poseidon_perm(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """state[0] of the Poseidon permutation of [0, inputs...], t = len + 1:
    (16, n) int32 Montgomery limbs (< r), views of any strides, in; a new
    (16, n) tensor out."""
    inputs = list(inputs)
    n = _lanes(inputs)
    if not on_cuda(*inputs):
        return poseidon_perm_plain(inputs)
    for k, x in enumerate(inputs):
        if x.dtype != torch.int32:
            raise TypeError(f"input {k}: expected int32 limbs, got {x.dtype}")
        if min(x.stride()) < 0:
            raise ValueError(f"input {k}: negative stride")
    t = len(inputs) + 1
    rf, rp, _, _ = params_for_t(t)
    out = torch.empty((L, n), dtype=torch.int32, device=inputs[0].device)
    if n:
        vec = ctypes.c_longlong * MAX_INPUTS
        bases = vec(*[x.data_ptr() for x in inputs])
        lane_strides = vec(*[x.stride(1) for x in inputs])
        limb_strides = vec(*[x.stride(0) for x in inputs])
        _, threads, group = launch_shape(n, _sm_count(out.device), t)
        _cuda.launch("zk_poseidon", t, rf, rp, _table(t, str(out.device)), bases,
                     lane_strides, limb_strides, out, n, threads, group)
        launches["poseidon"] += 1
    return out


def _pow5(x: torch.Tensor) -> torch.Tensor:
    return FrPlain.mul(FrPlain.sqr(FrPlain.sqr(x)), x)


def poseidon_perm_plain(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of poseidon_perm in the dense form, round by round as
    the JAX package's _batched_permutation: ark add, x^5 on every lane
    (full rounds) or lane 0 (partial rounds), then the MDS mix as t x t
    products summed by field adds; the state is one (16, t, n) tensor."""
    inputs = list(inputs)
    n = _lanes(inputs)
    t = len(inputs) + 1
    rf, rp, _, _ = params_for_t(t)
    ark, mds = _plain_consts(t, str(inputs[0].device))
    state = torch.stack([torch.zeros_like(inputs[0])] + inputs, dim=1)  # (16, t, n)
    half = rf // 2
    for rnd in range(rf + rp):
        state = FrPlain.add(state, ark[:, rnd, :, None].expand(L, t, n))
        if rnd < half or rnd >= half + rp:
            state = _pow5(state)
        else:
            state = torch.cat([_pow5(state[:, :1]), state[:, 1:]], dim=1)
        prods = FrPlain.mul(mds[:, :, :, None].expand(L, t, t, n).contiguous(),
                            state[:, None].expand(L, t, t, n).contiguous())
        acc = prods[:, :, 0]
        for j in range(1, t):
            acc = FrPlain.add(acc, prods[:, :, j])
        state = acc
    return state[:, 0].contiguous()
