// K3: the EC prefix scans of the fixed-base MSM pass, on Hopper.
//
// Replaces zerokit_tpu/ff/pallas_field.py _run_scan_kernel_impl with
// _make_scan_kernel (g1/g2 x mixed, excl). The TPU kernel read k-major
// limb rows that a gather had laid out for it and carried each lane's sum
// through a sequential grid axis in VMEM. Here both scans read and write
// AoS point rows: one row of 16*C*coords int32 words per point, word
// (i*C + m)*coords + c holding 16-bit limb i of component m of coordinate
// c, the table-row order of groth16/msm.py. A scan runs over lanes (o, b)
// and steps j; in a dense (outer, k, inner) array the row of lane (o, b)
// at step j is (o*k + j)*inner + b.
//
// ec_scan_gather (fine, "mixed"): one thread per lane runs k mixed adds
//   from the identity. Step j reads table row index[(o*k + j)*inner + b]
//   itself with 16-byte loads (no gathered copy, no transpose) and writes
//   the inclusive prefix as row (o*k + j)*inner + b of a dense output,
//   the layout the MSM's Q_d gather indexes. The order of adds is the
//   sequential scan's, so the output equals it bit for bit.
// ec_scan_excl (coarse, "excl"): T = `chunks` threads per lane, so the
//   dependent chain is about 2k/T + log2(T) adds instead of k:
//     1. thread t sums its chunk, steps [t*k/T, (t+1)*k/T) (floor; a chunk
//        may be empty when T > k): s = x_lo, then s = add(s, x_j) in order;
//        an empty chunk holds the identity;
//     2. a Kogge-Stone scan of the T sums in shared memory: for d = 1, 2,
//        4, ... < T, s_t = add(s_{t-d}, s_t) for t >= d; then the offset
//        of chunk t is s_{t-1} (the identity for t = 0);
//     3. thread t walks its chunk again from its offset: out_j = acc,
//        acc = add(acc, x_j).
//   RCB15 gives another projective representative of the same point when
//   adds are grouped otherwise, so this grouping is fixed by (k, T), and
//   ff/field_kernels.py ec_scan_rows_plain(..., "excl", chunks=T) follows it
//   step for step. The lane's input rows may be strided (x_outer, x_step
//   rows apart): the MSM pass scans the fine output's last row of each block
//   in place.
//
// What bounds them: 32-bit integer multiplies (a G1 add is 11-12
// Montgomery products, a G2 add 39-42, against 80-288 bytes of rows), as
// for K2, on the same field core (bn254.cuh: PTX carry chains, inlined
// products, values in [0, 2p) in registers, canonical at every store and
// at put_point). The fine scan has 10^5 lanes and fills the card; the coarse scan
// has only 512-768 lanes, which is why it splits each lane among T threads
// (its extra adds, about k + T*log2(T) a lane, are the price). The wrapper's
// T (SCAN_CHUNKS) and the fine scan's block size (FINE_THREADS) are the
// best of the sweeps chip_smoke.py prints.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kMaxThreads = 256;  // threads per block of either scan, at most
constexpr int kCoarseMinThreads = 128;

// shared memory holds one point per thread, word q of thread i at q*stride
// + i; put_elem writes the canonical representative (bn254.cuh invariant 2)
__device__ __forceinline__ void put_elem(u32* s, int q, int stride, const FqE& e) {
  FqE c = canon(e);
#pragma unroll
  for (int i = 0; i < 8; i++) s[(q + i) * stride] = c.v[i];
}
__device__ __forceinline__ void put_elem(u32* s, int q, int stride, const Fq2E& e) {
  put_elem(s, q, stride, e.c0);
  put_elem(s, q + 8, stride, e.c1);
}
__device__ __forceinline__ void get_elem(FqE& e, const u32* s, int q, int stride) {
#pragma unroll
  for (int i = 0; i < 8; i++) e.v[i] = s[(q + i) * stride];
}
__device__ __forceinline__ void get_elem(Fq2E& e, const u32* s, int q, int stride) {
  get_elem(e.c0, s, q, stride);
  get_elem(e.c1, s, q + 8, stride);
}

template <class E, int C>
__device__ __forceinline__ void put_point(u32* s, int stride, const Proj<E>& p) {
  put_elem(s, 0, stride, p.x);
  put_elem(s, 8 * C, stride, p.y);
  put_elem(s, 16 * C, stride, p.z);
}
template <class E, int C>
__device__ __forceinline__ Proj<E> get_point(const u32* s, int stride) {
  Proj<E> p;
  get_elem(p.x, s, 0, stride);
  get_elem(p.y, s, 8 * C, stride);
  get_elem(p.z, s, 16 * C, stride);
  return p;
}

template <class E, int C>
__global__ void __launch_bounds__(kMaxThreads)
    ec_scan_gather_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ index,
                          int32_t* __restrict__ out, int k, i64 inner, i64 lanes) {
  constexpr int kIn = 16 * C * 2;
  constexpr int kOut = 16 * C * 3;
  i64 lane = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  i64 o = lane / inner;
  i64 pos = o * k * inner + (lane - o * inner);  // the lane's row at step 0
  Proj<E> acc;
  set_identity(acc);
  int32_t row = __ldg(index + pos);
#pragma unroll 1
  for (int j = 0; j < k; j++, pos += inner) {
    int32_t w[kIn];
    load_row(w, table + (i64)row * kIn);
    if (j + 1 < k) row = __ldg(index + pos + inner);
    acc = rcb_add_mixed(acc, load_aff<E>(w, 1));
    store_point<E, C>(out + pos * kOut, acc);
  }
}

// blockDim.x = chunks * lanes per block; thread (l, t) = l*chunks + t.
template <class E, int C>
__global__ void __launch_bounds__(kMaxThreads)
    ec_scan_excl_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int k,
                        int chunks, i64 inner, i64 lanes, i64 x_outer, i64 x_step) {
  constexpr int kRow = 16 * C * 3;
  extern __shared__ u32 smem[];
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  const int t = tid % chunks;
  const i64 lane = (i64)blockIdx.x * (blockDim.x / chunks) + tid / chunks;
  const bool live = lane < lanes;
  const int lo = (int)((i64)t * k / chunks);
  const int hi = (int)((i64)(t + 1) * k / chunks);
  const i64 o = live ? lane / inner : 0;
  const i64 b = live ? lane - o * inner : 0;
  const int32_t* xl = x + (o * x_outer + b) * kRow;  // step j at xl + j*x_step*kRow
  const i64 xs = x_step * kRow;

  // 1. the chunk's sum
  Proj<E> s;
  if (live && lo < hi) {
    s = load_point<E, C>(xl + lo * xs);
#pragma unroll 1
    for (int j = lo + 1; j < hi; j++) s = rcb_add(s, load_point<E, C>(xl + j * xs));
  } else {
    set_identity(s);
  }
  // 2. inclusive scan of the lane's chunk sums
  put_point<E, C>(smem + tid, stride, s);
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < chunks; d <<= 1) {
    const bool take = live && t >= d;
    Proj<E> prev;
    if (take) prev = get_point<E, C>(smem + tid - d, stride);
    __syncthreads();
    if (take) {
      s = rcb_add(prev, s);
      put_point<E, C>(smem + tid, stride, s);
    }
    __syncthreads();
  }
  if (!live) return;
  // 3. the exclusive prefixes of the chunk, from its offset
  Proj<E> acc;
  if (t == 0) {
    set_identity(acc);
  } else {
    acc = get_point<E, C>(smem + tid - 1, stride);
  }
  int32_t* ol = out + (o * k * inner + b) * kRow;  // step j at ol + j*inner*kRow
#pragma unroll 1
  for (int j = lo; j < hi; j++) {
    store_point<E, C>(ol + j * inner * kRow, acc);
    if (j + 1 < hi) acc = rcb_add(acc, load_point<E, C>(xl + j * xs));
  }
}

inline unsigned blocks_for(i64 n, i64 per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

template <class E, int C>
int launch_gather(const int32_t* table, const int32_t* index, int32_t* out, int k, i64 inner,
                  i64 lanes, int threads, cudaStream_t s) {
  if (threads < 32 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  ec_scan_gather_kernel<E, C><<<blocks_for(lanes, threads), threads, 0, s>>>(
      table, index, out, k, inner, lanes);
  return (int)cudaGetLastError();
}

template <class E, int C>
int launch_excl(const int32_t* x, int32_t* out, int k, int chunks, i64 inner, i64 lanes,
                i64 x_outer, i64 x_step, cudaStream_t s) {
  if (chunks < 1 || chunks > kMaxThreads) return (int)cudaErrorInvalidValue;
  int per_block = chunks >= kCoarseMinThreads ? 1 : kCoarseMinThreads / chunks;
  int threads = per_block * chunks;
  size_t smem = sizeof(u32) * 3 * 8 * C * threads;
  ec_scan_excl_kernel<E, C><<<blocks_for(lanes, per_block), threads, smem, s>>>(
      x, out, k, chunks, inner, lanes, x_outer, x_step);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g2: 0 G1, 1 G2. table: (R, 16*C*2) affine rows; index: (outer, k, inner)
// int32 rows of table; out: (outer, k, inner, 16*C*3); lanes = outer*inner;
// threads: per block, 32-256.
int zk_ec_scan_gather(int g2, const void* table, const void* index, void* out, int k,
                      long long inner, long long lanes, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pt = (const int32_t*)table;
  const int32_t* pi = (const int32_t*)index;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_gather<FqE, 1>(pt, pi, po, k, inner, lanes, threads, s);
  if (g2 == 1) return launch_gather<Fq2E, 2>(pt, pi, po, k, inner, lanes, threads, s);
  return (int)cudaErrorInvalidValue;
}

// x: rows of 16*C*3 words, lane (o, b) step j at row o*x_outer + j*x_step + b
// (16-byte aligned); out: dense (outer, k, inner, 16*C*3); lanes = outer*inner.
int zk_ec_scan_excl(int g2, const void* x, void* out, int k, int chunks, long long inner,
                    long long lanes, long long x_outer, long long x_step, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* px = (const int32_t*)x;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_excl<FqE, 1>(px, po, k, chunks, inner, lanes, x_outer, x_step, s);
  if (g2 == 1) return launch_excl<Fq2E, 2>(px, po, k, chunks, inner, lanes, x_outer, x_step, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
