// K4-K5: radix-2 NTT stages over BN254 Fr on the (16, B, n) layout.
//
// K4 ntt_stage<Dir> replaces zerokit_tpu/ff/pallas_ntt.py _run_cross with
//    _make_cross_kernel: one stage at half-size m; DIF (lo+hi, (lo-hi)*w),
//    DIT (lo+w*hi, lo-w*hi).
// K5 ntt_tail<Dir,FuseTable> replaces _run_tail with _make_tail_kernel: all
//    stages m = 1 .. P/2 inside P-point chunks, P = min(n, chunk) with the
//    chunk up to 2048 (ff/ntt_kernels.py TAIL), optionally fused with the
//    pointwise table multiply (the bit-reversed coset table with 1/n) after
//    the DIF stages or before the DIT stages.
//
// What bounds them: one Fr Montgomery product per butterfly (128 32-bit
// multiply-adds) against 96 bytes of traffic, so the stages are compute
// bound at realistic n; the cross stage reads and writes every element once
// per stage, the tail keeps a chunk on chip for all of its log2(P) stages
// and touches device memory once, so a larger chunk leaves fewer cross
// stages. K4 runs one thread per butterfly. K5 (below) runs radix-8 register
// groups: up to three stages per shared-memory exchange, twiddles staged in
// shared memory once per block, the multiplies by 1 skipped. Values between
// stages stay in [0, 2p) (bn254.cuh's lazy reduction) and every store to
// device memory makes them canonical, so the outputs are the plain version's
// integers. Every power-of-two n >= 2 and every B are taken (the TPU path
// sent n % 1024 != 0 or B % 8 != 0 to XLA).

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kStageThreads = 256;

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

// ---------------------------------------------------------------------------
// K5: the tail as register-blocked radix-4 groups
// ---------------------------------------------------------------------------
//
// A block holds one P-point chunk of one batch row, P / 4 threads, each
// thread kE = 2^kLR = 4 values in registers. The log2(P) stages fall into
// groups: the first (DIT order) runs stages m = 1 .. 2^(r0-1)
// (r0 = log2(P) - 2(G-1), 1 or 2) on the 4 consecutive positions
// 4t .. 4t+3; group i >= 1 runs the two stages m = S, 2S
// (S = 2^(r0 + 2(i-1))) on the positions hi*4S + c*S + low (c < 4;
// t = hi*S + low). Every butterfly of those stages pairs two values of one
// thread, so a group reads its 4 values from shared memory, runs two stages
// with 2 independent products each, writes back and syncs once: half the
// exchanges and barriers of one stage at a time. The first group reads
// device memory and the last writes it (16-byte loads and stores at the 4
// consecutive positions). DIF runs the same groups and stages in reverse.
// Radix-8 groups (8 values a thread, three stages an exchange) were
// measured too: they need more than 128 registers and spill (PERF.md).
//
// Shared memory: the chunk as 8 words a position, word k of position pos at
// data[k * P + swz(pos)]; the swizzle XORs the position's low 5 bits with a
// linear function of bits 5-7 so that every group's accesses are free of
// bank conflicts. Twiddles are staged once
// per block: stages m < 64 as written in tail_tw (small[k * 64 + m + j]);
// stages m >= 64 from the top stage's P / 2 twiddles (w_m^j is the top
// stage's twiddle j * P / (2m)), swizzled (swz_tw) so that the strided reads
// of every stage are conflict-free too. The first group's twiddles are
// compile-time indices: its j = 0 butterflies (all of stage m = 1, half of
// m = 2) multiply by 1 and are skipped: (lo + hi, lo - hi) in both
// directions. 32P + 2 KB (+ 16P for P >= 128) bytes of shared memory:
// 50 KB at P = 1024 (TAIL).

constexpr int kMaxTail = 2048;
constexpr int kLR = 2, kE = 1 << kLR;  // radix-4 groups: two stages per exchange (PERF.md)
constexpr int kSmallTw = 64;  // stages m < kSmallTw read the small table

// pos ^ g(bits 5-7 of pos), g linear: bit 5 -> 01010, bit 6 -> 10101,
// bit 7 -> 11001 (the 8 values packed 5 bits each)
__device__ __forceinline__ int swz(int pos) {
  constexpr unsigned long long kG = (0ull << 0) | (10ull << 5) | (21ull << 10) | (31ull << 15) |
                                    (25ull << 20) | (19ull << 25) | (12ull << 30) | (6ull << 35);
  return pos ^ (int)((kG >> (5 * ((pos >> 5) & 7))) & 31);
}
__device__ __forceinline__ int swz_tw(int i) { return i ^ ((i >> 5) & 15); }

struct Tail {
  u32* data;   // 8 * p words
  u32* small;  // 8 * kSmallTw words
  u32* top;    // 8 * p / 2 words (p >= 128)
  int p, logp;
};

// stage m's twiddle j (m = 2^logm)
__device__ __forceinline__ FrE tail_twiddle(const Tail& s, int m, int logm, int j) {
  FrE w;
  if (m < kSmallTw) {
#pragma unroll
    for (int k = 0; k < 8; k++) w.v[k] = s.small[k * kSmallTw + m + j];
  } else {
    int h = s.p >> 1, i = swz_tw(j << (s.logp - 1 - logm));
#pragma unroll
    for (int k = 0; k < 8; k++) w.v[k] = s.top[k * h + i];
  }
  return w;
}

// the 4 values at positions 4t .. 4t+3 of a (16, .) limb array with limb
// stride `stride`: one 16-byte load a limb for p >= 4; for p < 4 (one
// thread) the values at c >= p are 0 and never stored
__device__ __forceinline__ void load_run(FrE (&e)[kE], const int32_t* g, i64 stride, int t, int p) {
  static_assert(kE == 4, "one int4 a limb");
  if (p >= kE) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      int4 a = *reinterpret_cast<const int4*>(g + (2 * k) * stride + kE * t);
      int4 b = *reinterpret_cast<const int4*>(g + (2 * k + 1) * stride + kE * t);
      e[0].v[k] = (u32)a.x | ((u32)b.x << 16);
      e[1].v[k] = (u32)a.y | ((u32)b.y << 16);
      e[2].v[k] = (u32)a.z | ((u32)b.z << 16);
      e[3].v[k] = (u32)a.w | ((u32)b.w << 16);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kE; c++) {
#pragma unroll
      for (int k = 0; k < 8; k++) e[c].v[k] = 0;
      if (c < p) load8(e[c].v, g + c, stride);
    }
  }
}

// the canonical values, as store8
__device__ __forceinline__ void store_run(int32_t* g, i64 stride, int t, int p,
                                          const FrE (&e)[kE]) {
  if (p >= kE) {
    FrE c[kE];
#pragma unroll
    for (int i = 0; i < kE; i++) c[i] = canon(e[i]);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      *reinterpret_cast<int4*>(g + (2 * k) * stride + kE * t) =
          make_int4((int)(c[0].v[k] & 0xffffu), (int)(c[1].v[k] & 0xffffu),
                    (int)(c[2].v[k] & 0xffffu), (int)(c[3].v[k] & 0xffffu));
      *reinterpret_cast<int4*>(g + (2 * k + 1) * stride + kE * t) =
          make_int4((int)(c[0].v[k] >> 16), (int)(c[1].v[k] >> 16), (int)(c[2].v[k] >> 16),
                    (int)(c[3].v[k] >> 16));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kE; c++)
      if (c < p) store8(g + c, stride, e[c]);
  }
}

// position of element c of thread t in the group of stride S = 2^logs
__device__ __forceinline__ int group_pos(int t, int logs, int c) {
  int low = t & ((1 << logs) - 1);
  return ((t >> logs) << (logs + kLR)) + (c << logs) + low;
}

__device__ __forceinline__ void load_smem(FrE (&e)[kE], const Tail& s, int t, int logs) {
#pragma unroll
  for (int c = 0; c < kE; c++) {
    int q = swz(group_pos(t, logs, c));
#pragma unroll
    for (int k = 0; k < 8; k++) e[c].v[k] = s.data[k * s.p + q];
  }
}

__device__ __forceinline__ void store_smem(const Tail& s, int t, int logs,
                                           const FrE (&e)[kE]) {
#pragma unroll
  for (int c = 0; c < kE; c++) {
    int q = swz(group_pos(t, logs, c));
#pragma unroll
    for (int k = 0; k < 8; k++) s.data[k * s.p + q] = e[c].v[k];
  }
}

// the two stages m = S, 2S of a group i >= 1 (DIT ascending, DIF
// descending): pairs (c, c + 2^q), twiddle j = (c mod 2^q) * S + low
template <int Dif>
__device__ __forceinline__ void group_stages(FrE (&e)[kE], const Tail& s, int t, int logs) {
  int low = t & ((1 << logs) - 1);
#pragma unroll
  for (int qq = 0; qq < kLR; qq++) {
    const int q = Dif ? kLR - 1 - qq : qq, h = 1 << q;
#pragma unroll
    for (int c = 0; c < kE; c++) {
      if (c & h) continue;
      FrE w = tail_twiddle(s, 1 << (logs + q), logs + q, ((c & (h - 1)) << logs) + low);
      butterfly<Dif>(e[c], e[c + h], w);
    }
  }
}

// the first group's r0 stages on positions 4t .. 4t+3 (m = 2^q, j = c mod
// m): the j = 0 butterflies multiply by 1 and run as (lo + hi, lo - hi)
template <int Dif>
__device__ __forceinline__ void first_stages(FrE (&e)[kE], const Tail& s, int r0) {
#pragma unroll
  for (int qq = 0; qq < kLR; qq++) {
    const int q = Dif ? kLR - 1 - qq : qq, h = 1 << q;
    if (q >= r0) continue;
#pragma unroll
    for (int c = 0; c < kE; c++) {
      if (c & h) continue;
      const int j = c & (h - 1);
      if (j == 0) {
        FrE sum = add(e[c], e[c + h]);
        e[c + h] = sub(e[c], e[c + h]);
        e[c] = sum;
      } else {
        butterfly<Dif>(e[c], e[c + h], tail_twiddle(s, h, q, j));
      }
    }
  }
}

// e[c] *= table[c] for the kE positions at tab (limb stride n), one table
// element live at a time
__device__ __forceinline__ void mul_table(FrE (&e)[kE], const int32_t* tab, i64 n, int p) {
#pragma unroll
  for (int c = 0; c < kE; c++) {
    if (c < p) {
      FrE w;
      load8(w.v, tab + c, n);
      e[c] = mul(e[c], w);
    }
  }
}

// x, out: (16, b, n); tail_tw: (16, P) with stage m's twiddles at [m, 2m);
// table: (16, n) or unused. grid (n / P, b), max(P / 4, 1) threads. At most
// 80 registers (no spills): three 256-thread blocks an SM at P = 1024, where
// the DIF variants take 83-84 unbounded and fit two (PERF.md).
template <int Dif, int Fuse>
__global__ void __maxnreg__(80)
    ntt_tail_kernel(const int32_t* x, const int32_t* tail_tw, const int32_t* table, int32_t* out,
                    i64 b, i64 n, int logp) {
  extern __shared__ u32 sm[];
  const int p = 1 << logp, t = threadIdx.x, nt = blockDim.x;
  Tail s{sm, sm + 8 * p, sm + 8 * p + 8 * kSmallTw, p, logp};
  const int groups = (logp + kLR - 1) / kLR, r0 = logp - kLR * (groups - 1);
  const int top_logs = r0 + kLR * (groups - 2);
  i64 row = blockIdx.y, base = (i64)blockIdx.x * p, stride = b * n;
  const int32_t* gx = x + row * n + base;
  int32_t* go = out + row * n + base;
  FrE e[kE];

  // the first group's elements (DIT) or the top group's (DIF), then the
  // twiddles, while those loads are in flight
  if (Dif && groups > 1) {
#pragma unroll
    for (int c = 0; c < kE; c++) load8(e[c].v, gx + group_pos(t, top_logs, c), stride);
  } else {
    load_run(e, gx, stride, t, p);
  }
  for (int i = t; i < p && i < kSmallTw; i += nt) {
    FrE w;
    load8(w.v, tail_tw + i, p);
#pragma unroll
    for (int k = 0; k < 8; k++) s.small[k * kSmallTw + i] = w.v[k];
  }
  if (p >= 2 * kSmallTw) {
    for (int i = t; i < p / 2; i += nt) {
      FrE w;
      load8(w.v, tail_tw + p / 2 + i, p);
      int q = swz_tw(i);
#pragma unroll
      for (int k = 0; k < 8; k++) s.top[k * (p / 2) + q] = w.v[k];
    }
  }
  __syncthreads();

  if constexpr (!Dif) {
    if constexpr (Fuse) mul_table(e, table + base + kE * t, n, p);
    first_stages<0>(e, s, r0);
    int prev = 0;  // the first group's positions 4t + c are group_pos(t, 0, c)
    for (int g = 1; g < groups; g++) {
      int logs = r0 + kLR * (g - 1);
      store_smem(s, t, prev, e);  // the positions this thread last read
      __syncthreads();
      load_smem(e, s, t, logs);
      group_stages<0>(e, s, t, logs);
      prev = logs;
    }
    if (groups == 1) {
      store_run(go, stride, t, p, e);
    } else {
#pragma unroll
      for (int c = 0; c < kE; c++) store8(go + group_pos(t, top_logs, c), stride, e[c]);
    }
  } else {
    for (int g = groups - 1; g >= 1; g--) {
      int logs = r0 + kLR * (g - 1);
      if (g < groups - 1) load_smem(e, s, t, logs);
      group_stages<1>(e, s, t, logs);
      store_smem(s, t, logs, e);
      __syncthreads();
    }
    if (groups > 1) load_smem(e, s, t, 0);
    first_stages<1>(e, s, r0);
    if constexpr (Fuse) mul_table(e, table + base + kE * t, n, p);
    store_run(go, stride, t, p, e);
  }
}

// the kernel's dynamic shared memory at chunk 2^logp, with the attribute
// above 48 KB set once; 0 or the CUDA error
template <int Dif, int Fuse>
int tail_smem(int logp, size_t* smem) {
  static size_t attr_bytes = 48 << 10;  // the default limit of dynamic shared memory
  int p = 1 << logp;
  *smem = sizeof(u32) * (8 * (size_t)p + 8 * kSmallTw + (p >= 2 * kSmallTw ? 4 * p : 0));
  if (*smem > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(ntt_tail_kernel<Dif, Fuse>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)*smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = *smem;
  }
  return 0;
}

int tail_threads(int logp) {
  return logp >= kLR ? 1 << (logp - kLR) : 1;
}

template <int Dif, int Fuse>
int launch_tail(const int32_t* x, const int32_t* tw, const int32_t* table, int32_t* out, i64 b,
                i64 n, int logp, cudaStream_t st) {
  size_t smem;
  if (int err = tail_smem<Dif, Fuse>(logp, &smem)) return err;
  dim3 grid((unsigned)(n >> logp), (unsigned)b);
  ntt_tail_kernel<Dif, Fuse><<<grid, tail_threads(logp), smem, st>>>(x, tw, table, out, b, n,
                                                                     logp);
  return (int)cudaGetLastError();
}

template <int Dif, int Fuse>
int tail_occupancy(int logp, int* blocks) {
  size_t smem;
  if (int err = tail_smem<Dif, Fuse>(logp, &smem)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ntt_tail_kernel<Dif, Fuse>, tail_threads(logp), smem);
}

int log2_chunk(long long p) {
  int logp = 0;
  while ((1LL << logp) < p) logp++;
  return logp;
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

// p: chunk size (power of two, 2 <= p <= 2048, p divides n); table may be
// null. x, out and table 16-byte aligned for p >= 8.
int zk_ntt_tail(int dif, const void* x, const void* tail_tw, const void* table, void* out,
                long long b, long long n, long long p, void* stream) {
  if (p < 2 || p > kMaxTail || (p & (p - 1)) || n % p || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (p >= 8 && (((uintptr_t)x | (uintptr_t)out | (uintptr_t)table) & 15))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  auto px = (const int32_t*)x;
  auto pt = (const int32_t*)tail_tw;
  auto pb = (const int32_t*)table;
  auto po = (int32_t*)out;
  int logp = log2_chunk(p);
  if (dif && pb) return launch_tail<1, 1>(px, pt, pb, po, b, n, logp, s);
  if (dif) return launch_tail<1, 0>(px, pt, pb, po, b, n, logp, s);
  if (pb) return launch_tail<0, 1>(px, pt, pb, po, b, n, logp, s);
  return launch_tail<0, 0>(px, pt, pb, po, b, n, logp, s);
}

// blocks per SM of the tail kernel at chunk p (cudaOccupancy...)
int zk_ntt_tail_occupancy(int dif, int fuse, long long p, int* blocks) {
  if (p < 2 || p > kMaxTail || (p & (p - 1))) return (int)cudaErrorInvalidValue;
  int logp = log2_chunk(p);
  if (dif) return fuse ? tail_occupancy<1, 1>(logp, blocks) : tail_occupancy<1, 0>(logp, blocks);
  return fuse ? tail_occupancy<0, 1>(logp, blocks) : tail_occupancy<0, 0>(logp, blocks);
}

}  // extern "C"
