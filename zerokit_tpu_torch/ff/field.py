"""Batched BN254 Fr/Fq Montgomery arithmetic on torch tensors.

Layout (the JAX package's, zerokit_tpu/ff/field.py): a field element is 16
little-endian limbs of 16 bits on axis 0, batch dims trailing — (16, *batch)
int32 tensors holding values in [0, 2^16). Montgomery radix R = 2^256.
Every operation returns the canonical representative (< p), so results are
the same integers whatever formulation computed them.

`mul` (and with it sqr, to_mont, from_mont and inv) of FrField and FqField
goes through ff/field_kernels.mont_mul: on a CUDA tensor that launches the
K1 kernel, on a CPU tensor it runs `mont_mul_sos` below. FrPlain and
FqPlain multiply with `mont_mul_sos` on any device: the kernels' plain
versions are built on them, so they never launch a kernel. add/sub/neg/
select are torch glue on either device.

The plain multiply is SOS Montgomery on float64 columns: every partial
product of two 16-bit limbs is < 2^32 and every column sum < 2^40, far below
float64's 2^53 exact-integer range, so the column sums can be one matmul
against a constant 0/1 matrix and stay exact. Intermediate columns stay in
a redundant limb form (two carry folds, no full normalisation) until the
final result.
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np
import torch

from ..constants import LIMB_BITS, LIMB_MASK, MONT_R, NUM_LIMBS, Q, R

L = NUM_LIMBS  # 16
_RADIX = 1 << LIMB_BITS
# lanes per chunk of the plain multiply: bounds its (256, chunk) float64
# partial-product temporary to 64 MiB
_PLAIN_CHUNK = 1 << 15


def int_to_limbs(x: int, n: int = NUM_LIMBS) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)], dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(arr.shape[0]))


def resolve_device(device) -> torch.device:
    """The entry points' device: the card unless the caller names another.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device=\"cpu\" to run on the CPU")
    return dev


DEVICE_ENV = "ZEROKIT_TORCH_DEVICE"


def device_from_env() -> str:
    """The device of the entry points that take no device argument (the C
    ABI's engines, `python -m zerokit_tpu_torch.server`): the environment
    variable ZEROKIT_TORCH_DEVICE, "cuda" when it is unset."""
    return os.environ.get(DEVICE_ENV, "cuda")


def from_numpy_limbs(arr, device="cuda") -> torch.Tensor:
    """uint32 limb array (the JAX package's arrays) -> int32 tensor on device."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > LIMB_MASK:
        raise ValueError("limb values must lie in [0, 2^16)")
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int32))).to(device)


def to_numpy_limbs(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (the JAX package's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def encode_canonical_fast(vals) -> torch.Tensor:
    """Python ints (each < 2^256) -> canonical limb tensor (16, N) int32 (CPU)."""
    vals = list(vals)
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), NUM_LIMBS)
    return torch.from_numpy(np.ascontiguousarray(u16.T).astype(np.int32))


def decode_canonical_fast(limbs) -> List[int]:
    """Canonical limb tensor/array (16, N) -> list of Python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(limbs).reshape(NUM_LIMBS, -1).T.astype("<u2"))
    raw = arr.tobytes()
    return [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(arr.shape[0])]


class FieldSpec:
    """Constants for one prime field (Fr or Fq) in limb form."""

    def __init__(self, p: int, name: str):
        self.p = p
        self.name = name
        self.r_mod = MONT_R % p
        self.r2_mod = (MONT_R * MONT_R) % p
        self.r_inv = pow(MONT_R, -1, p)
        self.ninv = (-pow(p, -1, MONT_R)) % MONT_R
        self.p_limbs = int_to_limbs(p)
        self.ninv_limbs = int_to_limbs(self.ninv)
        self.one_mont = int_to_limbs(self.r_mod)  # 1 in Montgomery form
        self.r2_limbs = int_to_limbs(self.r2_mod)

    def to_mont_int(self, x: int) -> int:
        return (x * MONT_R) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.r_inv) % self.p

    def encode(self, xs, mont: bool = True) -> torch.Tensor:
        """Python ints -> limb tensor (16, *np.shape(xs)) int32 (CPU)."""
        shape = np.shape(xs)
        flat = np.asarray(xs, dtype=object).reshape(-1)
        vals = [self.to_mont_int(int(v)) if mont else int(v) % self.p for v in flat]
        return encode_canonical_fast(vals).reshape((NUM_LIMBS,) + shape)

    def decode(self, limbs, mont: bool = True) -> np.ndarray:
        """Limb tensor/array (16, *batch) -> object array of Python ints (*batch)."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.detach().cpu().numpy()
        arr = np.asarray(limbs)
        vals = decode_canonical_fast(arr)
        out = np.empty(len(vals), dtype=object)
        for j, v in enumerate(vals):
            out[j] = self.from_mont_int(v) if mont else v
        return out.reshape(arr.shape[1:])


FR = FieldSpec(R, "fr")
FQ = FieldSpec(Q, "fq")
SPECS = {"fr": FR, "fq": FQ}


# ---------------------------------------------------------------------------
# Exact limb normalisation (int64 or float64 columns)
# ---------------------------------------------------------------------------


def _carry(cols: torch.Tensor):
    """Signed integer columns (k, *batch) -> (16-bit limbs, carry out of the
    top limb). Works on int64 (shifts) and on float64 holding integers below
    2^53 (floor division by 2^16, exact). Loops until no column carries;
    each round moves every carry up one limb."""
    is_float = cols.dtype == torch.float64
    c = cols.clone()
    top = torch.zeros_like(c[0])
    while True:
        hi = torch.floor(c * (1.0 / _RADIX)) if is_float else c >> LIMB_BITS
        if not bool(hi.any()):
            return c, top
        c = c - hi * _RADIX
        top = top + hi[-1]
        c[1:] += hi[:-1]


def _fold2(cols: torch.Tensor) -> torch.Tensor:
    """Two lo/hi carry folds of non-negative float64 columns (k, *batch),
    each < 2^48: every column ends below 2^16 + 2^6 (a redundant limb form)
    and the sum keeps its value mod 2^(16k)."""
    c = cols
    for _ in range(2):
        hi = torch.floor(c * (1.0 / _RADIX))
        c = c - hi * _RADIX
        c[1:] += hi[:-1]
    return c


def _normalize_nonneg(cols: torch.Tensor) -> torch.Tensor:
    """Non-negative float64 columns (k, *batch), each < 2^48 -> 16-bit limbs
    of their sum mod 2^(16k). After two folds the carries left are 0/1; a
    Kogge-Stone prefix resolves them in log2(k) rounds."""
    c = _fold2(cols)
    g = c >= _RADIX
    p = c == _RADIX - 1
    shift = 1
    while shift < c.shape[0]:
        g_new = g.clone()
        p_new = p.clone()
        g_new[shift:] |= p[shift:] & g[:-shift]
        p_new[shift:] &= p[:-shift]
        g, p = g_new, p_new
        shift *= 2
    c[1:] += g[:-1]
    return torch.where(c >= _RADIX, c - _RADIX, c)


@functools.lru_cache(maxsize=None)
def _limb_col(limbs: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """(len(limbs), 1) constant column on device."""
    return torch.tensor(limbs, dtype=dtype, device=device).reshape(-1, 1)


def _const_like(limbs: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    col = _limb_col(tuple(int(v) for v in limbs), dtype or like.dtype, str(like.device))
    return col.reshape((len(limbs),) + (1,) * (like.ndim - 1))


def _cond_sub_p(x: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """x (16, *b) normalised limbs < 2p -> x mod p."""
    diff, borrow = _carry(x - _const_like(spec.p_limbs, x))
    return torch.where(borrow[None] < 0, x, diff)


@functools.lru_cache(maxsize=None)
def _mont_mats(p: int, device: str):
    """float64 matrices of the plain multiply: column sums of a 16x16 limb
    outer product, and the Toeplitz forms of n' (mod 2^256) and p."""
    spec = SPECS["fr" if p == R else "fq"]
    m_ab = torch.zeros((2 * L, L * L), dtype=torch.float64)
    for i in range(L):
        for j in range(L):
            m_ab[i + j, i * L + j] = 1.0
    t_ninv = torch.zeros((L, L), dtype=torch.float64)
    t_p = torch.zeros((2 * L, L), dtype=torch.float64)
    for i in range(L):
        for k in range(i, L):
            t_ninv[k, i] = float(spec.ninv_limbs[k - i])
        for k in range(i, i + L):
            t_p[k, i] = float(spec.p_limbs[k - i])
    return m_ab.to(device), t_ninv.to(device), t_p.to(device)


def mont_mul_sos(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain Montgomery product a*b/R mod p on (16, *batch) int32 tensors of
    one device: SOS reduction t + ((t mod R) n' mod R) p, then one
    conditional subtraction. Inputs must be < p; the output is canonical."""
    shape = a.shape
    a = a.reshape(L, -1)
    b = b.reshape(L, -1)
    m_ab, t_ninv, t_p = _mont_mats(spec.p, str(a.device))
    n = a.shape[1]
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    for lo in range(0, n, _PLAIN_CHUNK):
        hi = min(lo + _PLAIN_CHUNK, n)
        av = a[:, lo:hi].to(torch.float64)
        bv = b[:, lo:hi].to(torch.float64)
        prod = (av[:, None, :] * bv[None, :, :]).reshape(L * L, hi - lo)
        # redundant limbs (< 2^16 + 2^6) keep every product column exact
        t = _fold2(m_ab @ prod)  # t = a*b < p^2 < 2^512
        m = _fold2(t_ninv @ t[:L])  # m = t*n' mod 2^256, m < 1.001 * 2^256
        u = _fold2(t_p @ m + t)  # u = t + m*p = 0 mod 2^256, u < 2^512
        # the low half of u is 0 or exactly 2^256: carry 1 iff any limb is set
        u_hi = u[L:].clone()
        u_hi[0] += (u[:L] != 0).any(dim=0)
        out[:, lo:hi] = _cond_sub_p(_normalize_nonneg(u_hi), spec).to(torch.int32)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Field operations
# ---------------------------------------------------------------------------


class Field:
    """Field ops bound to one FieldSpec on (16, *batch) int32 tensors. With
    plain=True every product is mont_mul_sos, on whatever device."""

    def __init__(self, spec: FieldSpec, plain: bool = False):
        self.spec = spec
        self.name = spec.name
        self.plain = plain
        self._inv_exp_bits = [(spec.p - 2) >> i & 1 for i in range(spec.p.bit_length())]

    def const(self, limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A constant broadcast to like's shape (a contiguous copy)."""
        return _const_like(limbs, like, torch.int32).expand(like.shape).contiguous()

    def one(self, like: torch.Tensor) -> torch.Tensor:
        return self.const(self.spec.one_mont, like)

    def add(self, a, b):
        limbs, _ = _carry(a.to(torch.int64) + b.to(torch.int64))
        return _cond_sub_p(limbs, self.spec).to(torch.int32)

    def sub(self, a, b):
        diff, borrow = _carry(a.to(torch.int64) - b.to(torch.int64))
        fixed, _ = _carry(diff + _const_like(self.spec.p_limbs, diff))
        return torch.where(borrow[None] < 0, fixed, diff).to(torch.int32)

    def neg(self, a):
        """p - a, and 0 for a = 0."""
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        if self.plain:
            return mont_mul_sos(self.spec, a, b)
        from . import field_kernels

        return field_kernels.mont_mul(self.name, a.contiguous(), b.contiguous())

    def sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        """canonical limbs -> Montgomery form (multiply by R^2)."""
        return self.mul(a, self.const(self.spec.r2_limbs, a))

    def from_mont(self, a):
        """Montgomery form -> canonical limbs (the product a * 1)."""
        from . import field_kernels

        if self.plain:
            return field_kernels.mont_from_plain(self.name, a)
        return field_kernels.mont_from(self.name, a.contiguous())

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, cond, a, b):
        """cond has the batch shape; limbwise where."""
        return torch.where(cond[None], a, b)

    def inv(self, a):
        """Batched inversion via Fermat: a^(p-2), square-and-multiply over
        the exponent's bits; inv(0) = 0."""
        result = self.one(a)
        base = a.contiguous()
        bits = self._inv_exp_bits
        for i, bit in enumerate(bits):
            if bit:
                result = self.mul(result, base)
            if i + 1 < len(bits):
                base = self.sqr(base)
        return result

    # -- canonical-form helpers (for witness bit ops) ------------------------

    @staticmethod
    def canon_shift_right_const(canon, k: int):
        """(canonical limbs) >> k for a Python-int shift amount."""
        limb_off, bit_off = divmod(k, LIMB_BITS)
        zero = torch.zeros((limb_off + 1,) + canon.shape[1:], dtype=canon.dtype,
                           device=canon.device)
        shifted = torch.cat([canon[limb_off:], zero], dim=0)
        hi = shifted[1 : L + 1] << (LIMB_BITS - bit_off)
        return ((shifted[:L] >> bit_off) | hi) & LIMB_MASK


FrField = Field(FR)
FqField = Field(FQ)
FrPlain = Field(FR, plain=True)
FqPlain = Field(FQ, plain=True)
