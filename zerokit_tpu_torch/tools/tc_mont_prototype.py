"""K6: the Fq Montgomery product with the reduction on the tensor cores.

Counterpart of tools/mxu_mont_prototype.py. Inside a Montgomery product
the reduction's two multiplies are by constants, m = (t mod 2^256) n' mod
2^256 and m q; a multiply by a constant is a matmul of the operand's 32
bytes against the constant's byte Toeplitz table (toeplitz_bytes, built as
_toeplitz_bytes builds it). The JAX tool ran those matmuls on the TPU's
MXU; csrc/mont_tc.cu runs them as u8 x u8 -> s32 mma.sync products on
the tensor cores, each warp on its own 32-lane tiles, while the 512-bit
product a * b stays on the CUDA cores.

  * mont_mul_tc(a, b): the kernel on (16, N) int32 Fq limbs in Montgomery
    form (K1's layout), or its plain version for CPU tensors;
  * smem_image: a table laid out as the kernel stages it in shared memory;
  * mont_mul_tc_plain(a, b): the same byte formulation in float64 matmuls
    (exact: every column sum is below 2^21), on any device;
  * const_mul_columns: the plain 16-bit column accumulators of one constant
    multiply, the values _const_mul_mxu returns;
  * main(lanes): K6 against its plain version and K1 fq bit for bit at
    full width, then each timed (CUDA events; K6 and K1 L2-cold on
    rotating copies, and back to back on the same tensors).

K6 stays off the proving path: it answers whether the tensor cores win.

Run on the card: python -m zerokit_tpu_torch.tools.tc_mont_prototype [lanes]
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..constants import NUM_LIMBS
from ..ff import _cuda
from ..ff.field import FQ, _cond_sub_p, _mont_mats, _normalize_nonneg, resolve_device
from ..ff.field_kernels import check_limbs, mont_mul, on_cuda
from ..runtime.profiling import ChipSpec, device_ms, host_call, l2_cold

L = NUM_LIMBS
launches = {"mont_mul_tc": 0}
_PLAIN_CHUNK = 1 << 15  # lanes per chunk: bounds the (256, chunk) float64 product


def reset_launches() -> None:
    launches["mont_mul_tc"] = 0


def toeplitz_bytes(limbs16: np.ndarray, n_out_bytecols: int) -> np.ndarray:
    """Constant (16-bit limbs) -> (32, n_out) uint8 byte Toeplitz T with
    T[i, k] = byte_{k-i} of the constant, so that for an operand's byte
    vector m (32,), (m @ T)[k] = sum_i m_i * c_{k-i} = byte-column k of
    m * c."""
    cbytes = []
    for v in limbs16:
        cbytes.append(int(v) & 0xFF)
        cbytes.append((int(v) >> 8) & 0xFF)
    t = np.zeros((32, n_out_bytecols), dtype=np.uint8)
    for i in range(32):
        for k in range(n_out_bytecols):
            j = k - i
            if 0 <= j < 32:
                t[i, k] = cbytes[j]
    return t


T_NINV = toeplitz_bytes(FQ.ninv_limbs, 32)  # m = t * n' mod 2^256: 32 columns
T_Q = toeplitz_bytes(FQ.p_limbs, 64)


def smem_image(table: np.ndarray) -> np.ndarray:
    """(32, N) table T[k, n] -> the N * 32 bytes the kernel copies into
    shared memory: B[n, k] = T[k, n] K-major in 8-row x 16-byte core
    matrices, byte (n // 8) * 256 + (k // 16) * 128 + (n % 8) * 16 + k % 16
    (csrc/mont_tc.cu img_off), which the kernel's B fragment loads read."""
    cols = table.shape[1]
    n = np.arange(cols)[:, None]
    k = np.arange(32)[None, :]
    img = np.zeros(cols * 32, dtype=np.uint8)
    img[(n // 8) * 256 + (k // 16) * 128 + (n % 8) * 16 + k % 16] = table.T
    return img


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    return (torch.from_numpy(T_NINV).to(device), torch.from_numpy(T_Q).to(device))


@functools.lru_cache(maxsize=None)
def _images(device: str):
    return tuple(torch.from_numpy(smem_image(t)).to(device) for t in (T_NINV, T_Q))


def const_mul_columns(limbs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """limbs (16, N) 16-bit values -> (n_out / 2, N) int64 16-bit column
    accumulators of value * constant: the byte columns bytes @ table (one
    float64 matmul, each sum < 2^21), paired as c[2j] + (c[2j + 1] << 8)."""
    x = limbs.to(torch.int64)
    n = x.shape[1]
    byts = torch.stack([x & 0xFF, x >> 8], dim=1).reshape(32, n).to(torch.float64)
    cols = table.to(device=x.device, dtype=torch.float64).T @ byts
    c16 = cols[0::2] + 256.0 * cols[1::2]
    return c16.to(torch.int64)


def mont_mul_tc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of mont_mul_tc: a * b / 2^256 mod q on (16, N) int32
    limbs (< q), by the kernel's byte formulation. Runs on any device and
    launches no kernel."""
    m_ab = _mont_mats(FQ.p, str(a.device))[0]
    t_ninv, t_q = _tables(str(a.device))
    n = a.shape[1]
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    for lo in range(0, n, _PLAIN_CHUNK):
        hi = min(lo + _PLAIN_CHUNK, n)
        av = a[:, lo:hi].to(torch.float64)
        bv = b[:, lo:hi].to(torch.float64)
        prod = (av[:, None, :] * bv[None, :, :]).reshape(L * L, hi - lo)
        t = _normalize_nonneg(m_ab @ prod)  # the 32 limbs of a * b
        m = _normalize_nonneg(const_mul_columns(t[:L], t_ninv).to(torch.float64))
        u = _normalize_nonneg(const_mul_columns(m, t_q).to(torch.float64) + t)
        # u = t + m q < 2^512 and u mod 2^256 = 0; its top half is < 2q
        out[:, lo:hi] = _cond_sub_p(u[L:], FQ).to(torch.int32)
    return out


def mont_mul_tc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6 on (16, N) int32 Fq limbs in Montgomery form (< q): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if a.ndim != 2 or a.shape != b.shape or a.shape[0] != L:
        raise ValueError(f"mont_mul_tc: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"mont_mul_tc: expected int32 limbs, got {a.dtype} and {b.dtype}")
    if not on_cuda(a, b):
        return mont_mul_tc_plain(a, b)
    check_limbs(a, "a")
    check_limbs(b, "b")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mont_mul_tc: a and b must be 16-byte aligned")
    img_n, img_q = _images(str(a.device))
    out = torch.empty_like(a)
    n = a.shape[1]
    if n:
        _cuda.launch("zk_mont_mul_tc", a, b, img_n, img_q, out, n)
        launches["mont_mul_tc"] += 1
    return out


def main(lanes: int = 1 << 16) -> dict:
    """K6 at `lanes` seeded lanes on the card (0, 1 and q - 1 in lanes 0-2),
    held bit for bit against its plain version and K1 fq, then K6 and K1
    fq timed L2-cold (l2_cold) and L2-warm, and the plain version
    (device_ms)."""
    dev = resolve_device("cuda")
    rng = np.random.default_rng(7)
    limbs = rng.integers(0, 1 << 16, size=(2, L, lanes), dtype=np.uint32)
    limbs[:, L - 1] %= (FQ.p >> 240) & 0xFFFF
    for j, v in enumerate((0, 1, FQ.p - 1)):
        limbs[:, :, j] = np.array([(v >> (16 * i)) & 0xFFFF for i in range(L)])[None]
    a, b = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in limbs)
    got, k6_s = host_call(lambda: mont_mul_tc(a, b))
    want = [x * y % FQ.p for x, y in zip(FQ.decode(a[:, :8]), FQ.decode(b[:, :8]))]
    if [int(v) for v in FQ.decode(got[:, :8])] != want:
        raise AssertionError("mont_mul_tc: the first lanes differ from the host product")
    plain, plain_s = host_call(lambda: mont_mul_tc_plain(a, b))
    k1, k1_s = host_call(lambda: mont_mul("fq", a, b))
    for other, want_t in (("its plain version", plain), ("K1 mont_mul fq", k1)):
        if not torch.equal(got, want_t):
            raise AssertionError(f"mont_mul_tc: mismatch against {other} at {lanes} lanes")
    label = ChipSpec.from_device(torch.cuda.current_device()).label()
    print(f"K6 mont_mul_tc: bit-exact against its plain version and K1 mont_mul fq at "
          f"{lanes} lanes", flush=True)
    k1_warm = device_ms(lambda: mont_mul("fq", a, b), enqueue_s=k1_s)
    k6_warm = device_ms(lambda: mont_mul_tc(a, b), enqueue_s=k6_s)
    k1_ms = device_ms(l2_cold(lambda a, b: mont_mul("fq", a, b), a, b))
    k6_ms = device_ms(l2_cold(mont_mul_tc, a, b))
    plain_ms = device_ms(lambda: mont_mul_tc_plain(a, b), 1, plain_s)
    for name, ms, warm in (("K1 mont_mul fq (CUDA cores)", k1_ms, k1_warm),
                           ("K6 mont_mul_tc (tensor cores)", k6_ms, k6_warm)):
        print(f"{name}: {ms:.4f} ms L2-cold ({lanes / ms / 1e3:.1f} M muls/s), {warm:.4f} ms "
              f"L2-warm; {label}", flush=True)
    print(f"K6 plain version: {plain_ms:.3f} ms; K6 / K1 speed: {k1_ms / k6_ms:.3f}x L2-cold, "
          f"{k1_warm / k6_warm:.3f}x L2-warm; {label}", flush=True)
    return {"lanes": lanes, "k1_ms": k1_ms, "k6_ms": k6_ms, "k1_warm_ms": k1_warm,
            "k6_warm_ms": k6_warm, "plain_ms": plain_ms, "ratio": k1_ms / k6_ms}

if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16)
