"""Fq and Fq2 field adapters with one interface for the curve formulas.

Counterpart of zerokit_tpu/ff/fq2.py. An element is (16, C, *batch) int32
with C = 1 for Fq and 2 for Fq2 = Fq[u]/(u^2 + 1) (c0, c1), in Montgomery
form. Every result is canonical, so the plain Karatsuba below (three
reductions) gives the same integers as the lazy form of the TPU kernels.

FqAdapter and Fq2Adapter multiply through the K1 wrapper (the kernel on CUDA
tensors); FqPlainAdapter and Fq2PlainAdapter multiply with the plain SOS
product on any device, for the plain versions of the curve kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B_G2, Q
from .field import FQ, Field, FqField, FqPlain


class _Adapter:
    """Shared part of the two adapters over one Fq Field."""

    def __init__(self, field: Field):
        self.field = field

    def add(self, a, b):
        return self.field.add(a, b)  # componentwise for Fq2

    def sub(self, a, b):
        return self.field.sub(a, b)

    def neg(self, a):
        return self.field.neg(a)

    @staticmethod
    def is_zero(a):
        """(16, C, *batch) -> (*batch) bool: every limb of every component 0."""
        return (a == 0).flatten(0, 1).all(dim=0)


class FqOps(_Adapter):
    components = 1

    @staticmethod
    def encode(vals) -> torch.Tensor:
        """list of ints -> (16, 1, N)."""
        return FQ.encode(list(vals))[:, None, :]

    @staticmethod
    def decode(arr):
        return [int(v) for v in FQ.decode(arr[:, 0])]

    def mul(self, a, b):
        return self.field.mul(a, b)

    def sqr(self, a):
        return self.field.sqr(a)

    def b3_mul(self, a):
        """a * 3b for G1 (b = 3): a * 9 = 8a + a, pure additions."""
        f = self.field
        d = f.add(a, a)
        d = f.add(d, d)
        d = f.add(d, d)
        return f.add(d, a)


class Fq2Ops(_Adapter):
    components = 2

    @staticmethod
    def encode(vals) -> torch.Tensor:
        """list of (c0, c1) pairs -> (16, 2, N)."""
        enc0 = FQ.encode([v[0] for v in vals])
        enc1 = FQ.encode([v[1] for v in vals])
        return torch.stack([enc0, enc1], dim=1)

    @staticmethod
    def decode(arr):
        c0 = FQ.decode(arr[:, 0])
        c1 = FQ.decode(arr[:, 1])
        return [(int(a), int(b)) for a, b in zip(c0, c1)]

    def mul(self, a, b):
        # Karatsuba with u^2 = -1:
        # c0 = a0 b0 - a1 b1; c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1
        f = self.field
        a0, a1 = a[:, 0], a[:, 1]
        b0, b1 = b[:, 0], b[:, 1]
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(f.add(a0, a1), f.add(b0, b1))
        c0 = f.sub(t0, t1)
        c1 = f.sub(f.sub(t2, t0), t1)
        return torch.stack([c0, c1], dim=1)

    def sqr(self, a):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        f = self.field
        a0, a1 = a[:, 0], a[:, 1]
        c0 = f.mul(f.add(a0, a1), f.sub(a0, a1))
        t = f.mul(a0, a1)
        c1 = f.add(t, t)
        return torch.stack([c0, c1], dim=1)

    def b3_mul(self, a):
        """a * 3b for G2's twist constant b = B_G2 in Fq2 (one Fq2 mul by a
        precomputed Montgomery constant)."""
        c = torch.from_numpy(_B3_G2_MONT.astype(np.int32)).to(a.device)
        c = c.reshape((16, 2) + (1,) * (a.ndim - 2)).expand(a.shape)
        return self.mul(a, c)


# 3 * B_G2 in Montgomery form, laid out (16 limbs, 2 components)
_B3_G2_MONT = np.stack(
    [
        FQ.encode([3 * B_G2[0] % Q]).numpy().reshape(-1).astype(np.uint32),
        FQ.encode([3 * B_G2[1] % Q]).numpy().reshape(-1).astype(np.uint32),
    ],
    axis=1,
)

FqAdapter = FqOps(FqField)
Fq2Adapter = Fq2Ops(FqField)
FqPlainAdapter = FqOps(FqPlain)
Fq2PlainAdapter = Fq2Ops(FqPlain)
