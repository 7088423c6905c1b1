"""Poseidon hash over BN254 Fr: host scalar version + batched version on the card.

Counterpart of zerokit_tpu/hash/poseidon.py. Parity targets:
  * permutation structure — reference utils/src/poseidon/poseidon_hash.rs
    (ark -> sbox(x^5, partial rounds hit lane 0 only) -> MDS mix per round,
    state = [0, inputs...], output = state[0]),
  * round parameters — reference rln/src/hashers.rs:14-23
    (t = 2..9, RF = 8, RP per t, skip_matrices = 0),
  * golden hash vectors — utils/tests/poseidon_hash_test.rs.

The host part (ROUND_PARAMS, params_for_t, poseidon_hash) is the JAX
package's text. The batched part runs the permutation as the CUDA kernel P1
(hash/poseidon_kernels.py, csrc/poseidon.cu) on Montgomery limb tensors
(16, *batch) int32; CPU tensors take its plain version. Hashing a whole
Merkle level is one launch with batch = level width.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ..constants import R
from .grain import find_poseidon_ark_and_mds

# (t, RF, RP, skip_matrices) — reference rln/src/hashers.rs:14-23
ROUND_PARAMS = [
    (2, 8, 56, 0),
    (3, 8, 57, 0),
    (4, 8, 56, 0),
    (5, 8, 60, 0),
    (6, 8, 60, 0),
    (7, 8, 63, 0),
    (8, 8, 64, 0),
    (9, 8, 63, 0),
]

PRIME_BITS = 254


class PoseidonError(ValueError):
    pass


@functools.lru_cache(maxsize=None)
def params_for_t(t: int):
    for pt, rf, rp, skip in ROUND_PARAMS:
        if pt == t:
            ark, mds = find_poseidon_ark_and_mds(PRIME_BITS, t, rf, rp, skip)
            return rf, rp, ark, mds
    raise PoseidonError(f"no Poseidon parameters for input length {t - 1}")


# ---------------------------------------------------------------------------
# host (python int) version — protocol-layer single hashes
# ---------------------------------------------------------------------------


def poseidon_hash(inputs: Sequence[int]) -> int:
    if len(inputs) == 0:
        raise PoseidonError("empty input")
    t = len(inputs) + 1
    if 2 <= t <= 9:
        # fast path: native host runtime (C ABI), if built
        from ..runtime import native

        result = native.poseidon_hash_native([int(v) % R for v in inputs])
        if result is not None:
            return result
    rf, rp, ark, mds = params_for_t(t)
    state = [0] + [x % R for x in inputs]
    for rnd in range(rf + rp):
        # ark
        state = [(s + ark[rnd * t + i]) % R for i, s in enumerate(state)]
        # sbox
        if rnd < rf // 2 or rnd >= rf // 2 + rp:
            state = [pow(s, 5, R) for s in state]
        else:
            state[0] = pow(state[0], 5, R)
        # mix
        state = [sum(mds[i][j] * state[j] for j in range(t)) % R for i in range(t)]
    return state[0]


def poseidon_hash_pair(a: int, b: int) -> int:
    return poseidon_hash([a, b])


# ---------------------------------------------------------------------------
# batched version on the card (Montgomery limb tensors)
# ---------------------------------------------------------------------------


def poseidon_hash_mont(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Batched Poseidon: inputs are t - 1 Montgomery limb tensors (16, *batch)
    of one device; the output has their shape. 2-D inputs may be strided
    views (a tree level's cur[:, 0::2]): P1 reads them in place."""
    from .poseidon_kernels import poseidon_perm

    if len(inputs) == 0:
        raise PoseidonError("empty input")
    shape = inputs[0].shape
    if any(x.shape != shape for x in inputs):
        raise PoseidonError(f"input shapes differ: {[tuple(x.shape) for x in inputs]}")
    flat = [x if x.dim() == 2 else x.reshape(shape[0], -1) for x in inputs]
    return poseidon_perm(flat).reshape(shape)


def poseidon_hash_pair_mont(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return poseidon_hash_mont([left, right])
