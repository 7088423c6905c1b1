"""Batched short-Weierstrass (a = 0) complete projective group laws in torch.

Counterpart of zerokit_tpu/groth16/curve.py. One implementation over a field
adapter (ff/fq2.py) serves G1 (over Fq) and G2 (over Fq2).

Point layout: homogeneous projective (X, Y, Z) as one tensor (16, C, 3,
*batch); the identity is (0, 1, 0) (one in Montgomery form). Affine points
are (16, C, 2, *batch) with (0, 0) as the infinity sentinel.

add, add_mixed and double are RCB15 Algorithms 7, 8 and 9 and go to the K2
kernel (ff/field_kernels.ec_op) on CUDA tensors, to its plain version on CPU
tensors. from_affine, neg, identity_like and selects are torch glue.
"""

from __future__ import annotations

import torch

from ..ff import field_kernels as fk
from ..ff.field import FQ, FqField


class CurveOps:
    def __init__(self, fq):
        self.fq = fq  # field adapter (FqAdapter / Fq2Adapter)

    @property
    def components(self) -> int:
        return self.fq.components

    # -- constructors -------------------------------------------------------

    def _one(self, like):
        """Field one (Montgomery) shaped like `like` (16, C, *b)."""
        one = torch.zeros_like(like)
        one[:, 0] = torch.tensor(FQ.one_mont.astype("int32"), device=like.device).reshape(
            (16,) + (1,) * (like.ndim - 2)
        )
        return one

    def identity_like(self, p):
        """The neutral element (0, 1, 0) shaped like p (16, C, 3, *b)."""
        x = torch.zeros_like(p[:, :, 0])
        return torch.stack([x, self._one(x), x], dim=2)

    def from_affine(self, aff):
        """aff (16, C, 2, *b) -> projective; (0, 0) sentinel -> (0, 1, 0)."""
        x = aff[:, :, 0]
        y = aff[:, :, 1]
        inf = self.fq.is_zero(x) & self.fq.is_zero(y)
        one = self._one(x)
        y = torch.where(inf[None, None], one, y)
        z = torch.where(inf[None, None], torch.zeros_like(x), one)
        return torch.stack([x, y, z], dim=2)

    # -- group law (RCB15, a = 0, complete) ----------------------------------

    def add(self, p, q):
        return fk.ec_op("add", self.components, p.contiguous(), q.contiguous())

    def add_mixed(self, p, q_aff):
        return fk.ec_op("add_mixed", self.components, p.contiguous(), q_aff.contiguous())

    def double(self, p):
        return fk.ec_op("double", self.components, p.contiguous())

    def neg(self, p):
        """-P: negate Y. The identity (0, y, 0) stays a valid identity."""
        return torch.stack([p[:, :, 0], self.fq.neg(p[:, :, 1]), p[:, :, 2]], dim=2)

    # -- conversions --------------------------------------------------------

    def to_affine(self, p):
        """Batched projective -> affine; the identity maps to (0, 0).

        Z is inverted by Fermat (a^(q-2), inv(0) = 0). To spend one Fermat
        chain on the whole batch rather than one per lane, the inversion goes
        through a product tree (Montgomery's trick): Z = 0 lanes take 1 in
        the tree and 0 after it, which is exactly inv(0) = 0."""
        zinv = batch_inv(self.fq, p[:, :, 2])
        x = self.fq.mul(p[:, :, 0], zinv)
        y = self.fq.mul(p[:, :, 1], zinv)
        return torch.stack([x, y], dim=2)


def _fq_batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverses of the Fq elements a (16, N), with inv(0) = 0: a product tree
    up, one Fermat inversion of the root, and the tree down (3N products)."""
    n = a.shape[1]
    zero = FqField.is_zero(a)
    one = FqField.one(a)
    x = torch.where(zero[None], one, a)
    size = 1
    while size < n:
        size *= 2
    if size != n:
        x = torch.cat([x, FqField.one(a.new_zeros((16, size - n)))], dim=1)
    levels = [x]
    while levels[-1].shape[1] > 1:
        lv = levels[-1]
        levels.append(FqField.mul(lv[:, 0::2], lv[:, 1::2]))
    inv = FqField.inv(levels[-1])
    for lv in reversed(levels[:-1]):
        left = FqField.mul(inv, lv[:, 1::2])  # 1/(l r) * r = 1/l
        right = FqField.mul(inv, lv[:, 0::2])
        inv = torch.stack([left, right], dim=2).reshape(16, -1)
    inv = inv[:, :n]
    return torch.where(zero[None], torch.zeros_like(inv), inv)


def batch_inv(fq, a: torch.Tensor) -> torch.Tensor:
    """Inverses of the adapter's elements a (16, C, *batch); inv(0) = 0."""
    shape = a.shape
    if fq.components == 1:
        return _fq_batch_inv(a.reshape(16, -1)).reshape(shape)
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    a0, a1 = a[:, 0], a[:, 1]
    norm = FqField.add(FqField.sqr(a0), FqField.sqr(a1))
    ninv = _fq_batch_inv(norm.reshape(16, -1)).reshape(norm.shape)
    c0 = FqField.mul(a0, ninv)
    c1 = FqField.neg(FqField.mul(a1, ninv))
    return torch.stack([c0, c1], dim=1)
