// K4-K5: radix-2 NTT stages over BN254 Fr on the (16, B, n) layout.
//
// K4 ntt_cross<Dir> replaces zerokit_tpu/ff/pallas_ntt.py _run_cross with
//    _make_cross_kernel (one stage at half-size m >= the tail's chunk): one
//    launch runs a run of r consecutive cross stages, half-sizes S .. 2^(r-1)
//    S, on tiles of the array held in shared memory; DIF (lo+hi, (lo-hi)*w),
//    DIT (lo+w*hi, lo-w*hi). ff/ntt_kernels.cross_runs cuts a pass's cross
//    stages into the fewest runs of at most CROSS_RMAX stages.
// K5 ntt_tail<Dir,FuseTable> replaces _run_tail with _make_tail_kernel: all
//    stages m = 1 .. P/2 inside P-point chunks, P = min(n, chunk) with the
//    chunk up to 2048 (ff/ntt_kernels.py TAIL), optionally fused with the
//    pointwise table multiply (the bit-reversed coset table with 1/n) after
//    the DIF stages or before the DIT stages.
//
// What bounds them: a butterfly is one Fr Montgomery product (264 32-bit
// multiplies) against 256 bytes of the public layout (two 16-limb int32
// values read, two written), so one stage alone is byte bound on the H100
// (~1 multiply a byte against ~5 at its peaks); each stage kept on chip adds
// products and no bytes, and r stages a pass meet the two bounds near r = 5
// (runtime/profiling.kernel_work). Both kernels therefore hold a tile of the array in shared
// memory and run several stages on it between one read and one write of
// device memory: K4 a run of up to CROSS_RMAX stages that pair positions
// S apart, K5 all log2(P) stages inside a P-point chunk. Both run them as
// radix-4 register groups: a thread holds 4 values and runs up to two
// stages on them between shared-memory exchanges, one barrier a group
// (radix-8 groups spilled: PERF.md); twiddles are staged in shared memory
// once a block; loads and stores of device memory go in address order as
// 16-byte accesses. Values between stages stay in [0, 2p) (bn254.cuh's lazy
// reduction) and every store to device memory makes them canonical, so the
// outputs are the plain version's integers. Every power-of-two n >= 4 (n >=
// 2 for K5) and every B up to 65535 are taken (the TPU path sent n % 1024
// != 0 or B % 8 != 0 to XLA).

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

using namespace zk;

namespace {

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

// ---------------------------------------------------------------------------
// Radix-4 register groups over a swizzled shared-memory tile (K4, K5)
// ---------------------------------------------------------------------------
//
// A tile of 2^lt positions: word k of position pos at data[k * 2^lt +
// swz(pos)]. A thread t holds kE = 2^kLR = 4 values. In the layout of bit g
// they are the positions group_pos(t, g, c) = hi * 4 * 2^g + c * 2^g + low
// (c < 4; t = hi * 2^g + low): bits g and g + 1 vary over the thread's
// values, so it runs the stages at those bits (half-sizes 2^g, 2^(g+1))
// alone. Between layouts a thread writes its values back to the positions
// it read and reads the next layout's after one barrier: every thread
// writes only positions it read itself, so one barrier an exchange is
// enough. The layout of bit 0 holds the 4 consecutive positions 4t .. 4t+3,
// which the 16-byte loads and stores of device memory read and write. The
// swizzle XORs the position's low 5 bits with a linear function of bits
// 5-7, so that every layout's accesses, and the tiles' twiddle reads (below),
// are free of bank conflicts (tests/test_torch_ntt_tail.py and
// tests/test_torch_ntt_cross.py check both).

constexpr int kLR = 2, kE = 1 << kLR;  // radix-4 groups: two stages per exchange (PERF.md)

// pos ^ g(bits 5-7 of pos), g linear: bit 5 -> 01010, bit 6 -> 10101,
// bit 7 -> 11001 (the 8 values packed 5 bits each)
__device__ __forceinline__ int swz(int pos) {
  constexpr unsigned long long kG = (0ull << 0) | (10ull << 5) | (21ull << 10) | (31ull << 15) |
                                    (25ull << 20) | (19ull << 25) | (12ull << 30) | (6ull << 35);
  return pos ^ (int)((kG >> (5 * ((pos >> 5) & 7))) & 31);
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

// position of element c of thread t in the layout of bit g
__device__ __forceinline__ int group_pos(int t, int g, int c) {
  int low = t & ((1 << g) - 1);
  return ((t >> g) << (g + kLR)) + (c << g) + low;
}

// data: the tile, p positions
__device__ __forceinline__ void load_smem(FrE (&e)[kE], const u32* data, int p, int t, int g) {
#pragma unroll
  for (int c = 0; c < kE; c++) {
    int q = swz(group_pos(t, g, c));
#pragma unroll
    for (int k = 0; k < 8; k++) e[c].v[k] = data[k * p + q];
  }
}

__device__ __forceinline__ void store_smem(u32* data, int p, int t, int g, const FrE (&e)[kE]) {
#pragma unroll
  for (int c = 0; c < kE; c++) {
    int q = swz(group_pos(t, g, c));
#pragma unroll
    for (int k = 0; k < 8; k++) data[k * p + q] = e[c].v[k];
  }
}

// ---------------------------------------------------------------------------
// K4: a run of cross stages through a shared-memory tile
// ---------------------------------------------------------------------------
//
// The run's stages have half-sizes S, 2S, .., 2^(r-1) S. Write a position
// p = hi * 2^r S + c * S + low (c < 2^r, low < S): every stage of the run
// pairs positions of one column (hi, low), so a block owns C' = min(C, n /
// 2^r) consecutive columns of one batch row, 2^r C' positions, and runs
// all r stages on them: the array crosses device memory once a run, not
// once a stage. Tile positions: where S >= C' the tile is 2^r rows of C'
// consecutive addresses at stride S, local position c * C' + l; where
// S < C' it is one contiguous range of 2^r C' addresses, the local position
// the offset. Either way the run's stages are the tile's stages at local
// bits ls .. ls + r - 1 (ls = log2 min(S, C')), as K5's are in its chunk.
//
// A block of 2^r C' / 4 threads: each thread loads its 4 consecutive local
// positions (a 16-byte load a limb, rows of C' >= 4 addresses), then the
// groups of cross_group run the stages in the layouts of the radix-4
// machinery above (two stages an exchange; for odd r one group runs one
// stage), and a last exchange returns each thread its 4 positions for the
// 16-byte stores. Twiddles: stage m = 2^i S's twiddle j is the top stage's
// twiddle j * 2^(r-1-i) (w_m^j = w_M^(j M / m), M = 2^(r-1) S), so a run
// reads one (16, M) table. The block stages the twiddles its stages need
// once, while its tile's loads are in flight: stage bit b's 2^b (b = ls +
// i) at entry 2^b - 2^ls + j' (j' = the butterfly's lo position mod 2^b,
// whose twiddle is top[j << (r - 1 - i)] with j the global position mod
// m), words 0-3 in tw[entry] and 4-7 in tw[ntw + entry], 16 bytes each: a
// butterfly reads its twiddle with two 16-byte loads from one address. Its
// index is its lo position's low b bits, so each quarter-warp reads
// consecutive entries or one entry (no bank conflicts).
// Its j = 0 butterfly falls in column 0 alone, at no compile-time index,
// so no product by 1 is skipped. 32 (2^r C' + (2^r - 1) min(S, C')) bytes
// of shared memory, at most 128 KB (kMaxCrossTile).

// The defaults, the fastest of the sweep on the H100 (PERF.md; ff/ntt_kernels
// mirrors each constant): tiles of kCrossTile positions, 2^r columns of
// kCrossTile / 2^r within [kMinCrossC, kMaxCrossC] (128 threads a block at
// r = 3-5; rows of fewer than 16 columns, 64 bytes, ran slower), and runs
// of at most kCrossRMax stages.
constexpr int kCrossTile = 512;      // ff/ntt_kernels.CROSS_TILE
constexpr int kCrossRMax = 5;        // ff/ntt_kernels.CROSS_RMAX
constexpr int kMinCrossC = 16;       // ff/ntt_kernels.MIN_CROSS_C
constexpr int kMaxCrossC = 64;       // the most columns a tile (MAX_CROSS_C)
constexpr int kMaxRun = 6;           // the most stages a launch (MAX_CROSS_RUN)
constexpr int kMaxCrossTile = 2048;  // the most positions a tile: 512 threads (MAX_CROSS_TILE)
static_assert(kMinCrossC << kMaxRun <= kMaxCrossTile && kCrossRMax <= kMaxRun,
              "every default tile within the limits");

// the default columns of a run of r stages
int default_cols(int r) {
  int c = kCrossTile >> r;
  return c < kMinCrossC ? kMinCrossC : c > kMaxCrossC ? kMaxCrossC : c;
}

// group gi (DIT order) of a run of r stages at local bits ls .. ls + r - 1
// of a 2^lt-position tile: its layout bit g, and the stages it runs, those
// at bits g + q for q in [qlo, qhi]. Pairs from the lowest bit up; for odd
// r the group of one stage takes the lowest bit (layout ls - 1) or, where
// ls = 0, the highest (layout r - 1, or r - 2 if bit r is outside the tile).
struct Group {
  int g, qlo, qhi;
};

__device__ __forceinline__ Group cross_group(int gi, int r, int ls, int lt) {
  if (!(r & 1)) return {ls + 2 * gi, 0, 1};
  if (ls >= 1) return gi == 0 ? Group{ls - 1, 1, 1} : Group{ls + 2 * gi - 1, 0, 1};
  if (gi < r / 2) return {2 * gi, 0, 1};
  return r < lt ? Group{r - 1, 0, 0} : Group{r - 2, 1, 1};
}

// the group's stages (DIT ascending, DIF descending) on the thread's values
template <int Dif>
__device__ __forceinline__ void cross_stages(FrE (&e)[kE], const uint4* tw, int ntw, int ls,
                                             int t, Group grp) {
  const int low = t & ((1 << grp.g) - 1);
#pragma unroll
  for (int qq = 0; qq < kLR; qq++) {
    const int q = Dif ? kLR - 1 - qq : qq, h = 1 << q;
    if (q < grp.qlo || q > grp.qhi) continue;
    const uint4* wb = tw + (1 << (grp.g + q)) - (1 << ls) + low;
#pragma unroll
    for (int c = 0; c < kE; c++) {
      if (c & h) continue;
      const int k = (c & (h - 1)) << grp.g;  // the lo position's bits between low and bit g + q
      const uint4 lo = wb[k], hi = wb[ntw + k];
      const FrE w{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
      butterfly<Dif>(e[c], e[c + h], w);
    }
  }
}

// the device-memory offset of local position pos: rows of 2^lrow
// consecutive addresses at stride 2^logs
__device__ __forceinline__ i64 tile_offset(int pos, int lrow, int logs) {
  return ((i64)(pos >> lrow) << logs) + (pos & ((1 << lrow) - 1));
}

// x, out: (16, b, n); top: (16, 2^(logs + r - 1)), the top stage's
// twiddles. grid (n / 2^(r + lc), b), 2^(r + lc - 2) threads; C' = 2^lc.
// At most 96 registers: the DIF variant takes 94 (at 80 it spilled 148 B
// and ran 4-10 % slower, PERF.md), the DIT variant 80.
template <int Dif>
__global__ void __maxnreg__(96)
    ntt_cross_kernel(const int32_t* x, const int32_t* top, int32_t* out, i64 b, i64 n, int logs,
                     int r, int lc) {
  extern __shared__ u32 sm[];
  const int t = threadIdx.x, nt = blockDim.x;
  const int lt = r + lc, tile = 1 << lt;
  const int ls = logs < lc ? logs : lc;    // log2 min(S, C')
  const int lrow = logs < lc ? lt : lc;    // log2 of a tile row's consecutive addresses
  const int ntw = (1 << (ls + r)) - (1 << ls);
  u32* data = sm;
  uint4* tw = reinterpret_cast<uint4*>(sm + 8 * tile);
  const i64 q0 = (i64)blockIdx.x << lc;  // the tile's first column
  const i64 low0 = q0 & ((1LL << logs) - 1);
  const i64 base = ((q0 >> logs) << (logs + r)) + low0;
  const i64 row = blockIdx.y, stride = b * n;
  const int32_t* gx = x + row * n + base;
  int32_t* go = out + row * n + base;
  FrE e[kE];

  // the thread's 4 consecutive positions, then the twiddles while those
  // loads are in flight
  if (lrow >= kLR) {
    load_run(e, gx + tile_offset(kE * t, lrow, logs), stride, 0, kE);
  } else {
#pragma unroll
    for (int c = 0; c < kE; c++) load8(e[c].v, gx + tile_offset(kE * t + c, lrow, logs), stride);
  }
  const i64 m_top = 1LL << (logs + r - 1);
  for (int i = t; i < ntw; i += nt) {
    const int bit = 31 - __clz(i + (1 << ls));  // the stage's local bit
    const int k = i + (1 << ls) - (1 << bit);   // its lo positions' low bits
    const i64 j = ((i64)(k >> ls) << logs) + low0 + (k & ((1 << ls) - 1));
    FrE w;
    load8(w.v, top + (j << (r - 1 - (bit - ls))), m_top);
    tw[i] = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
    tw[ntw + i] = make_uint4(w.v[4], w.v[5], w.v[6], w.v[7]);
  }

  const int groups = (r + 1) / 2;
  int prev = 0;  // the layout the thread's values are in: 4t + c
  for (int gg = 0; gg < groups; gg++) {
    const Group grp = cross_group(Dif ? groups - 1 - gg : gg, r, ls, lt);
    if (grp.g != prev) {
      store_smem(data, tile, t, prev, e);
      __syncthreads();
      load_smem(e, data, tile, t, grp.g);
      prev = grp.g;
    } else if (gg == 0) {
      __syncthreads();  // the twiddles
    }
    cross_stages<Dif>(e, tw, ntw, ls, t, grp);
  }
  if (prev != 0) {
    store_smem(data, tile, t, prev, e);
    __syncthreads();
    load_smem(e, data, tile, t, 0);
  }
  if (lrow >= kLR) {
    store_run(go + tile_offset(kE * t, lrow, logs), stride, 0, kE, e);
  } else {
#pragma unroll
    for (int c = 0; c < kE; c++) store8(go + tile_offset(kE * t + c, lrow, logs), stride, e[c]);
  }
}

int log2_of(long long v) {
  int l = 0;
  while ((1LL << l) < v) l++;
  return l;
}

// the launch of a run: lc, the tile's threads and its shared memory, with
// the attribute above 48 KB set once; 0 or the CUDA error
struct CrossLaunch {
  int logs, r, lc, threads;
  size_t smem;
};

template <int Dif>
int cross_launch(long long n, long long s, int r, int c, CrossLaunch* cl) {
  static size_t attr_bytes = 48 << 10;  // the default limit of dynamic shared memory
  int logn = log2_of(n), logs = log2_of(s), lc = log2_of(c);
  if (lc > logn - r) lc = logn - r;  // C' = min(C, n / 2^r)
  int lt = r + lc, ls = logs < lc ? logs : lc;
  if (lt < kLR || (1 << lt) > kMaxCrossTile) return (int)cudaErrorInvalidValue;
  *cl = {logs, r, lc, 1 << (lt - kLR),
         sizeof(u32) * 8 * ((size_t)(1 << lt) + (1 << (ls + r)) - (1 << ls))};
  if (cl->smem > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(ntt_cross_kernel<Dif>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)cl->smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = cl->smem;
  }
  return 0;
}

template <int Dif>
int launch_cross(const int32_t* x, const int32_t* top, int32_t* out, long long b, long long n,
                 long long s, int r, int c, cudaStream_t st) {
  CrossLaunch cl;
  if (int err = cross_launch<Dif>(n, s, r, c, &cl)) return err;
  const int lrow = cl.logs < cl.lc ? cl.lc + r : cl.lc;  // as the kernel's
  if (lrow >= kLR && (((uintptr_t)x | (uintptr_t)out) & 15)) return (int)cudaErrorMisalignedAddress;
  dim3 grid((unsigned)(n >> (r + cl.lc)), (unsigned)b);
  ntt_cross_kernel<Dif><<<grid, cl.threads, cl.smem, st>>>(x, top, out, b, n, cl.logs, r, cl.lc);
  return (int)cudaGetLastError();
}

template <int Dif>
int cross_occupancy(long long n, long long s, int r, int c, int* blocks) {
  CrossLaunch cl;
  if (int err = cross_launch<Dif>(n, s, r, c, &cl)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ntt_cross_kernel<Dif>,
                                                            cl.threads, cl.smem);
}

bool pow2(long long v) { return v >= 1 && !(v & (v - 1)); }

// the arguments zk_ntt_cross takes
bool cross_args_ok(long long b, long long n, long long s, int r, int c) {
  return pow2(n) && n >= 4 && pow2(s) && r >= 1 && r <= kMaxRun && (s << r) <= n && pow2(c) &&
         c <= kMaxCrossC && b >= 1 && b <= 65535;
}

// ---------------------------------------------------------------------------
// K5: the tail as register-blocked radix-4 groups
// ---------------------------------------------------------------------------
//
// A block holds one P-point chunk of one batch row, P / 4 threads, each
// thread kE = 4 values in registers. The log2(P) stages fall into groups:
// the first (DIT order) runs stages m = 1 .. 2^(r0-1) (r0 = log2(P) - 2(G-1),
// 1 or 2) on the 4 consecutive positions 4t .. 4t+3 (the layout of bit 0);
// group i >= 1 runs the two stages m = S, 2S (S = 2^(r0 + 2(i-1))) in the
// layout of bit log2(S). The first group reads device memory and the last
// writes it (16-byte loads and stores at the 4 consecutive positions). DIF
// runs the same groups and stages in reverse, its first group read straight
// from device memory in its layout. Radix-8 groups (8 values a thread,
// three stages an exchange) were measured too: they need more than 128
// registers and spill (PERF.md).
//
// Twiddles are staged once per block: stages m < 64 as written in tail_tw
// (small[k * 64 + m + j]); stages m >= 64 from the top stage's P / 2
// twiddles (w_m^j is the top stage's twiddle j * P / (2m)), swizzled
// (swz_tw) so that the strided reads of every stage are conflict-free too.
// The first group's twiddles are compile-time indices: its j = 0
// butterflies (all of stage m = 1, half of m = 2) multiply by 1 and are
// skipped: (lo + hi, lo - hi) in both directions. 32P + 2 KB (+ 16P for
// P >= 128) bytes of shared memory: 50 KB at P = 1024 (TAIL).

constexpr int kMaxTail = 2048;
constexpr int kSmallTw = 64;  // stages m < kSmallTw read the small table

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
      store_smem(s.data, p, t, prev, e);  // the positions this thread last read
      __syncthreads();
      load_smem(e, s.data, p, t, logs);
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
      if (g < groups - 1) load_smem(e, s.data, p, t, logs);
      group_stages<1>(e, s, t, logs);
      store_smem(s.data, p, t, logs, e);
      __syncthreads();
    }
    if (groups > 1) load_smem(e, s.data, p, t, 0);
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

}  // namespace

extern "C" {

// dif: 1 DIF, 0 DIT. x, out: (16, b, n), 16-byte aligned where a tile row
// holds 4 or more consecutive positions; top: (16, s << (r - 1)), the run's
// top stage twiddles. Runs the stages of half-size s .. s << (r - 1) on
// tiles of c columns (c a power of two <= 64, 0 for default_cols(r); fewer
// where n / 2^r is smaller); the tile, 2^r columns, at most 2048 positions.
int zk_ntt_cross(int dif, const void* x, const void* top, void* out, long long b, long long n,
                 long long s, int r, int c, void* stream) {
  if (c == 0 && r >= 1 && r <= kMaxRun) c = default_cols(r);
  if (!cross_args_ok(b, n, s, r, c)) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto px = (const int32_t*)x;
  auto pt = (const int32_t*)top;
  auto po = (int32_t*)out;
  return dif ? launch_cross<1>(px, pt, po, b, n, s, r, c, st)
             : launch_cross<0>(px, pt, po, b, n, s, r, c, st);
}

// blocks per SM of the cross kernel at that run and tile
int zk_ntt_cross_occupancy(int dif, long long n, long long s, int r, int c, int* blocks) {
  if (c == 0 && r >= 1 && r <= kMaxRun) c = default_cols(r);
  if (!cross_args_ok(1, n, s, r, c)) return (int)cudaErrorInvalidValue;
  return dif ? cross_occupancy<1>(n, s, r, c, blocks) : cross_occupancy<0>(n, s, r, c, blocks);
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
  int logp = log2_of(p);
  if (dif && pb) return launch_tail<1, 1>(px, pt, pb, po, b, n, logp, s);
  if (dif) return launch_tail<1, 0>(px, pt, pb, po, b, n, logp, s);
  if (pb) return launch_tail<0, 1>(px, pt, pb, po, b, n, logp, s);
  return launch_tail<0, 0>(px, pt, pb, po, b, n, logp, s);
}

// blocks per SM of the tail kernel at chunk p (cudaOccupancy...)
int zk_ntt_tail_occupancy(int dif, int fuse, long long p, int* blocks) {
  if (p < 2 || p > kMaxTail || (p & (p - 1))) return (int)cudaErrorInvalidValue;
  int logp = log2_of(p);
  if (dif) return fuse ? tail_occupancy<1, 1>(logp, blocks) : tail_occupancy<1, 0>(logp, blocks);
  return fuse ? tail_occupancy<0, 1>(logp, blocks) : tail_occupancy<0, 0>(logp, blocks);
}

}  // extern "C"
