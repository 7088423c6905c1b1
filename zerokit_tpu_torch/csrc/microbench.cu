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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef uint32_t u32;
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

}  // extern "C"
