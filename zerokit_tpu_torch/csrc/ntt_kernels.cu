// K4-K5: radix-2 NTT stages over BN254 Fr on the (16, B, n) layout.
//
// K4 ntt_stage<Dir> replaces zerokit_tpu/ff/pallas_ntt.py _run_cross with
//    _make_cross_kernel: one stage at half-size m; DIF (lo+hi, (lo-hi)*w),
//    DIT (lo+w*hi, lo-w*hi).
// K5 ntt_tail<Dir,FuseTable> replaces _run_tail with _make_tail_kernel: all
//    stages m = 1 .. P/2 inside P-point chunks, P = min(n, 512), optionally
//    fused with the pointwise table multiply (the bit-reversed coset table
//    with 1/n) after the DIF stages or before the DIT stages.
//
// What bounds them: one Fr Montgomery product per butterfly (128 32-bit
// multiply-adds) against 96 bytes of traffic, so the stages are compute
// bound at realistic n; the cross stage reads and writes every element once
// per stage, the tail keeps a chunk in shared memory for all of its
// log2(P) stages (16 KB at P = 512) and touches device memory once. K4 runs
// one thread per butterfly; K5 one block per (batch row, chunk) with P/2
// threads, stages separated by __syncthreads; values between stages stay in
// [0, 2p) (bn254.cuh's lazy reduction) and store8 makes them canonical.
// Every power-of-two n >= 2 and
// every B are taken (the TPU path sent n % 1024 != 0 or B % 8 != 0 to XLA).

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kStageThreads = 256;
constexpr int kMaxTail = 512;

template <int Dif>
__device__ __forceinline__ void butterfly(FrE& lo, FrE& hi, const FrE& w) {
  if constexpr (Dif) {
    FrE s = add(lo, hi);
    hi = mul(sub(lo, hi), w);
    lo = s;
  } else {
    FrE t = mul(hi, w);
    hi = sub(lo, t);
    lo = add(lo, t);
  }
}

// x, out: (16, b, n); tw: (16, m) stage twiddles w_m^j.
template <int Dif>
__global__ void __launch_bounds__(kStageThreads)
    ntt_stage_kernel(const int32_t* x, const int32_t* tw, int32_t* out, i64 b, i64 n, i64 m) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  i64 half = n / 2;
  if (t >= b * half) return;
  i64 row = t / half, r = t % half;
  i64 j = r % m;
  i64 lo = (r / m) * 2 * m + j;
  i64 stride = b * n;
  const int32_t* xr = x + row * n;
  int32_t* orow = out + row * n;
  FrE u, v, w;
  load8(u.v, xr + lo, stride);
  load8(v.v, xr + lo + m, stride);
  load8(w.v, tw + j, m);
  butterfly<Dif>(u, v, w);
  store8(orow + lo, stride, u);
  store8(orow + lo + m, stride, v);
}

// x, out: (16, b, n); tail_tw: (16, P) with stage m's twiddles at [m, 2m);
// table: (16, n) or unused. grid (n / P, b), P / 2 threads.
template <int Dif, int Fuse>
__global__ void __launch_bounds__(kMaxTail / 2)
    ntt_tail_kernel(const int32_t* x, const int32_t* tail_tw, const int32_t* table, int32_t* out,
                    i64 b, i64 n, int p) {
  extern __shared__ u32 sm[];  // 8 words per element, sm[k * p + pos]
  i64 row = blockIdx.y;
  i64 base = (i64)blockIdx.x * p;
  i64 stride = b * n;
  const int32_t* xr = x + row * n + base;
  for (int e = threadIdx.x; e < p; e += blockDim.x) {
    FrE v;
    load8(v.v, xr + e, stride);
    if constexpr (Fuse && !Dif) {
      FrE w;
      load8(w.v, table + base + e, n);
      v = mul(v, w);
    }
#pragma unroll
    for (int k = 0; k < 8; k++) sm[k * p + e] = v.v[k];
  }
  __syncthreads();
  int t = threadIdx.x;
  for (int m = Dif ? p / 2 : 1; Dif ? m >= 1 : m < p; m = Dif ? m / 2 : m * 2) {
    int j = t % m;
    int lo = (t / m) * 2 * m + j;
    FrE u, v, w;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      u.v[k] = sm[k * p + lo];
      v.v[k] = sm[k * p + lo + m];
    }
    load8(w.v, tail_tw + m + j, p);
    butterfly<Dif>(u, v, w);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      sm[k * p + lo] = u.v[k];
      sm[k * p + lo + m] = v.v[k];
    }
    __syncthreads();
  }
  int32_t* orow = out + row * n + base;
  for (int e = threadIdx.x; e < p; e += blockDim.x) {
    FrE v;
#pragma unroll
    for (int k = 0; k < 8; k++) v.v[k] = sm[k * p + e];
    if constexpr (Fuse && Dif) {
      FrE w;
      load8(w.v, table + base + e, n);
      v = mul(v, w);
    }
    store8(orow + e, stride, v);
  }
}

template <int Dif, int Fuse>
void launch_tail(const int32_t* x, const int32_t* tw, const int32_t* table, int32_t* out, i64 b,
                 i64 n, int p, cudaStream_t s) {
  dim3 grid((unsigned)(n / p), (unsigned)b);
  size_t smem = (size_t)8 * p * sizeof(u32);
  ntt_tail_kernel<Dif, Fuse><<<grid, p / 2, smem, s>>>(x, tw, table, out, b, n, p);
}

}  // namespace

extern "C" {

// dif: 1 DIF, 0 DIT. x, out: (16, b, n); tw: (16, m).
int zk_ntt_stage(int dif, const void* x, const void* tw, void* out, long long b, long long n,
                 long long m, void* stream) {
  if (n < 2 || m < 1 || 2 * m > n || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  i64 total = b * (n / 2);
  dim3 grid((unsigned)((total + kStageThreads - 1) / kStageThreads));
  const int32_t* px = (const int32_t*)x;
  const int32_t* pt = (const int32_t*)tw;
  int32_t* po = (int32_t*)out;
  if (dif) {
    ntt_stage_kernel<1><<<grid, kStageThreads, 0, s>>>(px, pt, po, b, n, m);
  } else {
    ntt_stage_kernel<0><<<grid, kStageThreads, 0, s>>>(px, pt, po, b, n, m);
  }
  return (int)cudaGetLastError();
}

// p: chunk size (power of two, 2 <= p <= 512, p divides n); table may be null.
int zk_ntt_tail(int dif, const void* x, const void* tail_tw, const void* table, void* out,
                long long b, long long n, long long p, void* stream) {
  if (p < 2 || p > kMaxTail || (p & (p - 1)) || n % p || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* px = (const int32_t*)x;
  const int32_t* pt = (const int32_t*)tail_tw;
  const int32_t* pb = (const int32_t*)table;
  int32_t* po = (int32_t*)out;
  int ip = (int)p;
  if (dif && pb) launch_tail<1, 1>(px, pt, pb, po, b, n, ip, s);
  else if (dif) launch_tail<1, 0>(px, pt, pb, po, b, n, ip, s);
  else if (pb) launch_tail<0, 1>(px, pt, pb, po, b, n, ip, s);
  else launch_tail<0, 0>(px, pt, pb, po, b, n, ip, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
