// Throughput of the card's 32-bit integer and float32 pipes: register-
// resident chains of one operation, the counterpart of the jnp chains of
// tools/tpu_microbench.py (mul_chain_u32, add_chain_u32, shift_chain_u32,
// fma_chain_f32), which XLA fused into one pass over the lanes. A chain of
// torch elementwise ops cannot stand in here: each op would be its own
// memory-bound launch.
//
// One thread per lane keeps kAcc independent accumulators, so the loop
// measures issue throughput, not latency. The inputs come from memory and
// the result goes back to it, so the compiler can neither fold nor drop a
// chain; each step is inline PTX of the one instruction measured.
//   op 0  mul.lo.u32 (IMAD)       op 1  mul.hi.u32 (IMAD.HI)
//   op 2  add.u32                 op 3  shr.u32 + xor.b32 (one step)
//   op 4  fma.rn.f32 (FFMA, on the same words read as floats)
// Memory traffic is 12 bytes a lane against iters * kAcc steps, far below
// the HBM rate at the iteration counts used.
//
// The latencies behind W1's step chain (csrc/witness_kernels.cu), each in
// SM cycles (clock64) of one dependent chain a thread, at few lanes:
//   latency_kernel  bn254.cuh's CIOS `mul`, W1's product:
//     x <- x * y / 2^256 mod r
//   roundtrip_kernel<Mode>  a lane's four threads pass 32-byte values
//     around through global (0) or shared (1) memory: load, add, store,
//     __syncwarp, the memory part of one W1 step; mode 2 is mode 1 with
//     each round's value also stored to global memory (W1's signals);
//     mode 3 is mode 1 with the four threads in four warps and a block
//     barrier (W1's mapping).

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace {

using zk::FrE;
using zk::u32;
typedef long long i64;

constexpr int kThreads = 256;
constexpr int kAcc = 8;

template <int Op>
__device__ __forceinline__ u32 step(u32 x, u32 y) {
  u32 r;
  if constexpr (Op == 0) {
    asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  } else if constexpr (Op == 1) {
    asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  } else if constexpr (Op == 2) {
    asm volatile("add.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  } else if constexpr (Op == 3) {
    asm volatile("{\n\t.reg .u32 s;\n\tshr.u32 s, %1, 7;\n\txor.b32 %0, s, %2;\n\t}"
                 : "=r"(r) : "r"(x), "r"(y));
  } else {
    float f;
    asm volatile("fma.rn.f32 %0, %1, %2, %3;"
                 : "=f"(f) : "f"(__uint_as_float(x)), "f"(__uint_as_float(y)), "f"(1.0f));
    r = __float_as_uint(f);
  }
  return r;
}

// out[i] = xor over k of the chain x_k <- step(x_k, b[i]) iters times, from
// x_k = a[i] + k.
template <int Op>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const u32* a, const u32* b, u32* out, i64 n, int iters) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 y = b[i];
  u32 x[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; k++) x[k] = a[i] + (u32)k;
#pragma unroll 4
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < kAcc; k++) x[k] = step<Op>(x[k], y);
  }
  u32 r = 0;
#pragma unroll
  for (int k = 0; k < kAcc; k++) r ^= x[k];
  out[i] = r;
}

__global__ void __launch_bounds__(32)
    latency_kernel(const u32* x0, const u32* y, u32* out, i64* cycles, int n, int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FrE x, b;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x.v[k] = x0[i * 8 + k];
    b.v[k] = y[i * 8 + k];
  }
  i64 t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; it++) x = zk::mul(x, b);
  x = zk::canon(x);
  i64 t1 = clock64();
#pragma unroll
  for (int k = 0; k < 8; k++) out[i * 8 + k] = x.v[k];
  cycles[i] = t1 - t0;
}

// Thread j (modes 0-2: blockDim.x = 4, one warp; mode 3: lane 0 of warp j of
// 4) reads value j of one buffer, adds 1 to its first word, writes it as
// value j + 1 (mod 4) of the other, then __syncwarp (modes 0-2) or
// __syncthreads over the 4 warps (mode 3, W1's step barrier)
template <int Mode>
__global__ void __launch_bounds__(128) roundtrip_kernel(u32* g, i64* cycles, int iters) {
  constexpr bool Shared = Mode != 0;
  __shared__ __align__(16) u32 s[2 * 4 * 8];
  u32* base = Shared ? s : g + blockIdx.x * 64;
  const int j = Mode == 3 ? threadIdx.x / 32 : threadIdx.x;
  const bool active = Mode != 3 || threadIdx.x % 32 == 0;
  if (Shared && active) {
    for (int k = 0; k < 16; k++) s[j * 16 + k] = g[blockIdx.x * 64 + j * 16 + k];
  }
  __syncthreads();
  i64 t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
    if (active) {
      const uint4* src = reinterpret_cast<const uint4*>(base + (it & 1) * 32 + j * 8);
      uint4 lo = src[0], hi = src[1];
      lo.x += 1u;
      uint4* dst = reinterpret_cast<uint4*>(base + (~it & 1) * 32 + ((j + 1) & 3) * 8);
      dst[0] = lo;
      dst[1] = hi;
      if constexpr (Mode == 2) {
        uint4* gd = reinterpret_cast<uint4*>(g + blockIdx.x * 64 + (~it & 1) * 32 +
                                             ((j + 1) & 3) * 8);
        gd[0] = lo;
        gd[1] = hi;
      }
    }
    if constexpr (Mode == 3) {
      __syncthreads();
    } else {
      __syncwarp(0xfu);
    }
  }
  i64 t1 = clock64();
  if (Shared && active) {
    for (int k = 0; k < 16; k++) g[blockIdx.x * 64 + j * 16 + k] = s[j * 16 + k];
  }
  if (active) cycles[blockIdx.x * 4 + j] = t1 - t0;
}

}  // namespace

extern "C" {

// a, b, out: (n,) int32 words. Returns cudaGetLastError().
int zk_chain(int op, const void* a, const void* b, void* out, long long n, int iters,
             void* stream) {
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  const u32* pa = (const u32*)a;
  const u32* pb = (const u32*)b;
  u32* po = (u32*)out;
  switch (op) {
    case 0: chain_kernel<0><<<grid, kThreads, 0, s>>>(pa, pb, po, n, iters); break;
    case 1: chain_kernel<1><<<grid, kThreads, 0, s>>>(pa, pb, po, n, iters); break;
    case 2: chain_kernel<2><<<grid, kThreads, 0, s>>>(pa, pb, po, n, iters); break;
    case 3: chain_kernel<3><<<grid, kThreads, 0, s>>>(pa, pb, po, n, iters); break;
    case 4: chain_kernel<4><<<grid, kThreads, 0, s>>>(pa, pb, po, n, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x0, y, out: (n, 8) words; cycles: (n,) int64.
int zk_latency(const void* x0, const void* y, void* out, void* cycles, int n, int iters,
               void* stream) {
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + 31) / 32));
  latency_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>((const u32*)x0, (const u32*)y, (u32*)out,
                                                        (i64*)cycles, n, iters);
  return (int)cudaGetLastError();
}

// mode: 0 global, 1 shared, 2 shared and a global store a round, 3 shared
// across 4 warps with a block barrier; g:
// (blocks, 2, 4, 8) words, in place; cycles: (blocks, 4) int64.
int zk_roundtrip(int mode, void* g, void* cycles, int blocks, int iters, void* stream) {
  if (blocks < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: roundtrip_kernel<0><<<blocks, 4, 0, s>>>((u32*)g, (i64*)cycles, iters); break;
    case 1: roundtrip_kernel<1><<<blocks, 4, 0, s>>>((u32*)g, (i64*)cycles, iters); break;
    case 2: roundtrip_kernel<2><<<blocks, 4, 0, s>>>((u32*)g, (i64*)cycles, iters); break;
    case 3: roundtrip_kernel<3><<<blocks, 128, 0, s>>>((u32*)g, (i64*)cycles, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
