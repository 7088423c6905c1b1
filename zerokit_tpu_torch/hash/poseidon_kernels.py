"""P1, the batched Poseidon permutation (csrc/poseidon.cu), with its plain version.

P1 replaces zerokit_tpu/hash/poseidon.py `_batched_permutation(t)`, a
jitted lax.scan under XLA (not a Pallas kernel): t - 1 inputs of (16, n)
Montgomery Fr limbs -> state[0] of the permutation of [0, inputs...], for
t = 2..9.

poseidon_perm takes each input as a (16, n) int32 tensor or view and passes
the kernel its data pointer, lane stride and limb stride, so a tree level
(16, 2n) serves as its own lefts (level[:, 0::2]) and rights
(level[:, 1::2]) with no copy. The constant table (round constants, then
the MDS matrix, Montgomery and canonical, 8 little-endian 32-bit words a
value) is built once per t and device from params_for_t.

A CUDA tensor launches the kernel (or raises); CPU tensors take
poseidon_perm_plain, which runs on any device on the plain field FrPlain
(ff/field.mont_mul_sos) and never launches a kernel, so it can also be held
against P1 on the card. `launches` counts P1 launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ..constants import NUM_LIMBS
from ..ff import _cuda
from ..ff.field import FR, FrPlain
from ..ff.field_kernels import on_cuda
from .poseidon import PoseidonError, params_for_t

L = NUM_LIMBS
MAX_INPUTS = 8  # t = 9
launches = {"poseidon": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def table_values(t: int) -> list:
    """The kernel's constants in table order, Montgomery form: the
    (RF + RP) x t round constants row by row, then the t x t MDS matrix."""
    rf, rp, ark, mds = params_for_t(t)
    return [FR.to_mont_int(v) for v in list(ark) + [x for row in mds for x in row]]


@functools.lru_cache(maxsize=None)
def _table(t: int, device: str) -> torch.Tensor:
    raw = b"".join(v.to_bytes(32, "little") for v in table_values(t))
    words = np.frombuffer(raw, dtype="<u4").view(np.int32).copy()
    return torch.from_numpy(words).to(device)


@functools.lru_cache(maxsize=None)
def _plain_consts(t: int, device: str):
    """(ark (16, RF + RP, t), mds (16, t, t)) Montgomery limb tensors."""
    rf, rp, ark, mds = params_for_t(t)
    vals = table_values(t)
    n_ark = (rf + rp) * t
    ark_mont = FR.encode(vals[:n_ark], mont=False).reshape(L, rf + rp, t)
    mds_mont = FR.encode(vals[n_ark:], mont=False).reshape(L, t, t)
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
        _cuda.launch("zk_poseidon", t, rf, rp, _table(t, str(out.device)), bases,
                     lane_strides, limb_strides, out, n)
        launches["poseidon"] += 1
    return out


def _pow5(x: torch.Tensor) -> torch.Tensor:
    return FrPlain.mul(FrPlain.sqr(FrPlain.sqr(x)), x)


def poseidon_perm_plain(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of poseidon_perm, round by round as the JAX package's
    _batched_permutation: ark add, x^5 on every lane (full rounds) or lane
    0 (partial rounds), then the MDS mix as t x t products summed by field
    adds; the state is one (16, t, n) tensor."""
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
