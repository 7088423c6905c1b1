// P1: the batched Poseidon permutation over BN254 Fr on Hopper.
//
// Replaces zerokit_tpu/hash/poseidon.py _batched_permutation(t) (:132), a
// jitted lax.scan under XLA, not Pallas. The state is [0, inputs...] of
// T = 2..9 lanes; RF full rounds and RP partial rounds each add the round
// constants, raise to x^5 (every lane in a full round, lane 0 in a partial
// one) and mix by the MDS matrix; the output is state[0]. Values are
// Montgomery Fr (radix 2^256) in the package's (16, n) int32 16-bit limbs.
//
// What bounds it: 32-bit multiplies. The work is the Montgomery products,
// ~264 IMADs each, and a hash reads and writes 64 B a lane. So the kernel
// runs the permutation in its cheapest known form, the sparse partial-round
// form (Grassi et al., "Poseidon", Appendix B), built on the host by
// hash/poseidon_kernels.sparse_form:
//   * a partial round is lane 0's x^5, then row 0 of its sparse factor as
//     a T-product dot and s[i] + v_i * s[0] for i >= 1: 2T - 1 products
//     where the dense mix takes T^2 (its dense factors are folded into the
//     last first-half full round's matrix, and its constants but lane 0's
//     carried into the next round's);
//   * round 0's lane 0 is a constant, so its x^5 and its column of the mix
//     are folded into round 1's constants;
//   * the last round's mix is row 0 only.
// That is poseidon_mont_muls(T) products a hash: 588 at T = 3 (828 dense).
// At T <= 4 each mix row of two or more products is summed before one
// Montgomery reduction (bn254.cuh mul_sum): 134,152 32-bit multiplies a
// T = 3 hash where 588 products reduced alone take 155,232. x^5's two
// squarings run as full products (bn254.cuh's sqr is mul(a, a)); the
// bound, runtime/profiling.poseidon_imads, counts them as squarings:
// 125,192.
//
// One thread a hash, the state T x 8 words in registers on bn254.cuh's Fr
// core. Register values lie in [0, 2r), and three of them can pass 2^256
// (r ~ 0.19 * 2^256), so from T = 5 each row sum goes through `add` term
// by term, which brings every partial sum back below 2r; mul_sum's rows
// end in [0, 2r) by one conditional subtraction. The table (RF x T full
// round constants, RP lane-0 constants, M, B, RP x (2T - 1) sparse entries;
// Montgomery, canonical, 8 words each: 12 KB at T = 3, 43 KB at T = 9) is
// staged into shared memory at block start. Every thread of a warp reads
// the same constant: a broadcast.
//
// The launch shape is chosen by the wrapper (hash/poseidon_kernels.
// launch_shape, from n, T and the SM count) and passed in. A tree's upper
// levels hold fewer hashes than the card holds warp schedulers (4 an SM),
// and there a warp's time is one hash's chain of products, ~845 cycles
// each: the products of one thread do not overlap. So there a hash runs
// on G threads (poseidon_group_kernel, G = T rounded up to a power of
// two): thread k holds state lane k, x^5 and row k of a full round's mix
// run on thread k, and a partial round's products are spread over the
// group, the state exchanged by __shfl_sync; the chain falls from 588
// products to 275 product steps at T = 3. Otherwise one thread a hash
// (poseidon_kernel).
//
// Each input is a base pointer with a lane stride and a limb stride, so a
// tree level (16, 2n) is read in place as its own lefts (lane stride 2)
// and rights (offset 1, lane stride 2). The output is made canonical once,
// in store8 (bn254.cuh invariant 2).
//
// T = 2..4 (the protocol's arities) inline every product. From T = 5 a
// full round's products grow as T^2 (up to 81 at T = 9), and inlined they
// would make the build's straight-line code several hundred KB, so those
// widths call one out-of-line product with its operands by value, as the
// Fq2 products do (fq2_part_mul); the round loops are not unrolled at any T.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxInputs = 8;
constexpr size_t kStaticSmem = 48 * 1024;  // no opt-in needed below this

struct PoseidonInputs {
  const int32_t* base[kMaxInputs];
  i64 lane_stride[kMaxInputs];
  i64 limb_stride[kMaxInputs];
};

static __device__ __noinline__ FrE fr_mul_call(FrE a, FrE b) { return mul(a, b); }

template <bool Inline>
__device__ __forceinline__ FrE fr_mul(const FrE& a, const FrE& b) {
  if constexpr (Inline) {
    return mul(a, b);
  } else {
    return fr_mul_call(a, b);
  }
}

// one constant (8 words, 16-byte aligned) from the shared table
__device__ __forceinline__ FrE smem_elem(const u32* s) {
  const uint4* v = reinterpret_cast<const uint4*>(s);
  uint4 lo = v[0], hi = v[1];
  FrE e;
  e.v[0] = lo.x;
  e.v[1] = lo.y;
  e.v[2] = lo.z;
  e.v[3] = lo.w;
  e.v[4] = hi.x;
  e.v[5] = hi.y;
  e.v[6] = hi.z;
  e.v[7] = hi.w;
  return e;
}

template <bool Inline>
__device__ __forceinline__ FrE pow5(const FrE& x) {
  FrE x2 = fr_mul<Inline>(x, x);
  return fr_mul<Inline>(fr_mul<Inline>(x2, x2), x);
}

// row . x for N canonical constants at `row` in the shared table. At T <=
// 4 a row of two or more is one mul_sum, one Montgomery reduction for the
// row (128 N + 136 multiplies where N products take 264 N; bn254.cuh);
// else each product is reduced and the sum taken by add.
template <int T, int N>
__device__ __forceinline__ FrE row_dot(const u32* row, const FrE (&x)[N]) {
  constexpr bool kInline = T <= 4;
  if constexpr (kInline && N >= 2) {
    FrE c[N];
#pragma unroll
    for (int j = 0; j < N; j++) c[j] = smem_elem(row + 8 * j);
    return mul_sum(c, x);
  } else {
    FrE acc = fr_mul<kInline>(smem_elem(row), x[0]);
#pragma unroll
    for (int j = 1; j < N; j++) acc = add(acc, fr_mul<kInline>(smem_elem(row + 8 * j), x[j]));
    return acc;
  }
}

// A full round: ark add and x^5 on every lane, then the mix by m. First:
// round 0, whose lane 0 (a constant) was folded into round 1's constants,
// so lanes 1.. only. Row0: the last round, whose output is row 0 only.
template <int T, bool First, bool Row0>
__device__ __forceinline__ void full_round(FrE (&s)[T], const u32* ark, const u32* m) {
  constexpr bool kInline = T <= 4;
  constexpr int k0 = First ? 1 : 0;
  constexpr int rows = Row0 ? 1 : T;
  FrE x[T - k0];
#pragma unroll
  for (int k = k0; k < T; k++) x[k - k0] = pow5<kInline>(add(s[k], smem_elem(ark + 8 * k)));
#pragma unroll
  for (int r = 0; r < rows; r++) s[r] = row_dot<T, T - k0>(m + 8 * (r * T + k0), x);
}

// A partial round: lane 0's constant and x^5, then the sparse factor: row
// 0 (sp[0..T)) dotted with the state, and column 0 (sp[T..2T-1)) times the
// new s[0] added to lanes 1..
template <int T>
__device__ __forceinline__ void partial_round(FrE (&s)[T], const u32* c0, const u32* sp) {
  constexpr bool kInline = T <= 4;
  FrE x[T];
  x[0] = pow5<kInline>(add(s[0], smem_elem(c0)));
#pragma unroll
  for (int j = 1; j < T; j++) x[j] = s[j];
  s[0] = row_dot<T, T>(sp, x);
#pragma unroll
  for (int i = 1; i < T; i++) {
    s[i] = add(s[i], fr_mul<kInline>(smem_elem(sp + 8 * (T + i - 1)), x[0]));
  }
}

// The table's layout in 32-bit words (poseidon_kernels.table_values):
// full_ark (rf x T), part_ark (rp), mds (T x T), first (T x T), sparse
// (rp x (2T - 1)), 8 words a value.
struct Layout {
  int ark, part, mds, first, sparse, words;
};

__host__ __device__ constexpr Layout layout(int t, int rf, int rp) {
  return {0, 8 * rf * t, 8 * (rf * t + rp), 8 * (rf * t + rp + t * t),
          8 * (rf * t + rp + 2 * t * t), 8 * (rf * t + rp + 2 * t * t + rp * (2 * t - 1))};
}

// the table, copied from global into shared memory by the whole block
__device__ __forceinline__ void stage_table(u32* table, const u32* consts, const Layout& l) {
  for (int w = threadIdx.x; w < l.words / 4; w += blockDim.x) {
    reinterpret_cast<uint4*>(table)[w] = __ldg(reinterpret_cast<const uint4*>(consts) + w);
  }
  __syncthreads();
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
    poseidon_kernel(const u32* __restrict__ consts, PoseidonInputs in, int32_t* __restrict__ out,
                    i64 n, int rf, int rp) {
  extern __shared__ __align__(16) u32 table[];
  const Layout l = layout(T, rf, rp);
  stage_table(table, consts, l);
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FrE s[T];
#pragma unroll
  for (int w = 0; w < 8; w++) s[0].v[w] = 0;
#pragma unroll
  for (int k = 1; k < T; k++) {
    load8(s[k].v, in.base[k - 1] + i * in.lane_stride[k - 1], in.limb_stride[k - 1]);
  }
  const int half = rf / 2;
  const u32 *ark = table + l.ark, *part = table + l.part, *mds = table + l.mds;
  const u32 *first = table + l.first, *sparse = table + l.sparse;
  full_round<T, true, false>(s, ark, mds);  // half >= 2: round 0 mixes by M
#pragma unroll 1
  for (int r = 1; r < half - 1; r++) full_round<T, false, false>(s, ark + r * T * 8, mds);
  full_round<T, false, false>(s, ark + (half - 1) * T * 8, first);
#pragma unroll 1
  for (int k = 0; k < rp; k++) partial_round<T>(s, part + k * 8, sparse + k * (2 * T - 1) * 8);
#pragma unroll 1
  for (int r = half; r < rf - 1; r++) full_round<T, false, false>(s, ark + r * T * 8, mds);
  full_round<T, false, true>(s, ark + (rf - 1) * T * 8, mds);
  store8(out + i, n, s[0]);
}

// ---------------------------------------------------------------------------
// G threads a hash, for calls too small to keep the warp schedulers busy
// ---------------------------------------------------------------------------

// threads a hash: T rounded up to a power of two, so a group is a shuffle
// segment of its warp
__host__ __device__ constexpr int group_of(int t) {
  return t <= 2 ? 2 : t <= 4 ? 4 : t <= 8 ? 8 : 16;
}

// x from thread src of this thread's group of G
template <int G>
__device__ __forceinline__ FrE shfl(const FrE& x, int src) {
  FrE r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = __shfl_sync(0xffffffffu, x.v[w], src, G);
  return r;
}

// A full round on thread k of a group (k clamped to T - 1 in kk: threads
// T..G-1 shadow lane T - 1 and are never read): lane k's constant and x^5,
// then row k of m times the group's x. First: round 0, lane 0's column
// folded into round 1's constants.
template <int T, bool First>
__device__ __forceinline__ void group_full_round(FrE& s, int kk, const u32* ark, const u32* m) {
  constexpr int G = group_of(T);
  constexpr int j0 = First ? 1 : 0;
  FrE x = pow5<(T <= 4)>(add(s, smem_elem(ark + 8 * kk)));
  FrE xs[T - j0];
#pragma unroll
  for (int j = j0; j < T; j++) xs[j - j0] = shfl<G>(x, j);
  s = row_dot<T, T - j0>(m + 8 * (kk * T + j0), xs);
}

// A partial round on thread k: thread 0 squares lane 0 + its constant
// while thread i >= 1 makes row0[i] * s_i, thread 0 ends the x^5, every
// thread multiplies it by its coefficient (row0[0] on thread 0, column 0's
// entry i - 1 on thread i), and thread 0 sums the row.
template <int T>
__device__ __forceinline__ void group_partial_round(FrE& s, int k, int kk, const u32* c0,
                                                    const u32* sp) {
  constexpr bool kInline = T <= 4;
  constexpr int G = group_of(T);
  FrE x = add(s, smem_elem(c0));
  FrE a = k == 0 ? x : smem_elem(sp + 8 * kk);
  FrE b = k == 0 ? x : s;
  FrE p = fr_mul<kInline>(a, b);  // x^2 on thread 0, row0[k] * s_k elsewhere
  FrE x5 = p;
  if (k == 0) x5 = fr_mul<kInline>(fr_mul<kInline>(p, p), x);
  x5 = shfl<G>(x5, 0);
  FrE q = fr_mul<kInline>(smem_elem(k == 0 ? sp : sp + 8 * (T + kk - 1)), x5);
  FrE row = q;
#pragma unroll
  for (int i = 1; i < T; i++) row = add(row, shfl<G>(p, i));
  s = k == 0 ? row : add(s, q);
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
    poseidon_group_kernel(const u32* __restrict__ consts, PoseidonInputs in,
                          int32_t* __restrict__ out, i64 n, int rf, int rp) {
  constexpr int G = group_of(T);
  extern __shared__ __align__(16) u32 table[];
  const Layout l = layout(T, rf, rp);
  stage_table(table, consts, l);
  // every thread runs to the end: the shuffles take the whole warp
  const i64 i = ((i64)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int k = threadIdx.x % G;
  const int kk = k < T ? k : T - 1;
  const bool live = i < n;
  FrE s;
#pragma unroll
  for (int w = 0; w < 8; w++) s.v[w] = 0;
  if (live && k >= 1 && k < T) {
    load8(s.v, in.base[k - 1] + i * in.lane_stride[k - 1], in.limb_stride[k - 1]);
  }
  const int half = rf / 2;
  const u32 *ark = table + l.ark, *part = table + l.part, *mds = table + l.mds;
  const u32 *first = table + l.first, *sparse = table + l.sparse;
  group_full_round<T, true>(s, kk, ark, mds);
#pragma unroll 1
  for (int r = 1; r < rf; r++) {
    if (r == half) {
#pragma unroll 1
      for (int j = 0; j < rp; j++) {
        group_partial_round<T>(s, k, kk, part + j * 8, sparse + j * (2 * T - 1) * 8);
      }
    }
    group_full_round<T, false>(s, kk, ark + r * T * 8, r == half - 1 ? first : mds);
  }
  if (live && k == 0) store8(out + i, n, s);
}

template <int T>
int launch(const PoseidonInputs& in, const u32* consts, int32_t* out, i64 n, int rf, int rp,
           int threads, int g, cudaStream_t s) {
  const size_t smem = (size_t)layout(T, rf, rp).words * sizeof(u32);
  if (smem > kStaticSmem || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (g != 1 && g != group_of(T))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n * g + threads - 1) / threads);
  if (g > 1) {
    poseidon_group_kernel<T><<<blocks, threads, smem, s>>>(consts, in, out, n, rf, rp);
  } else {
    poseidon_kernel<T><<<blocks, threads, smem, s>>>(consts, in, out, n, rf, rp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// t = 2..9; rf (even, >= 4), rp: the round counts of params_for_t(t).
// consts: the device table of poseidon_kernels.table_values(t) (Montgomery,
// 8 little-endian u32 words each, 16-byte aligned). bases, lane_strides,
// limb_strides: host arrays of the t - 1 inputs' device pointers and
// strides in int32 words (limb i of lane j of input k at bases[k] + j *
// lane_strides[k] + i * limb_strides[k]). out: (16, n). threads (a block,
// a multiple of 32 up to 256) and g (threads a hash: 1, or T rounded up to
// a power of two): the launch shape, poseidon_kernels.launch_shape's.
int zk_poseidon(int t, int rf, int rp, const void* consts, const long long* bases,
                const long long* lane_strides, const long long* limb_strides, void* out,
                long long n, int threads, int g, void* stream) {
  if (t < 2 || t > kMaxInputs + 1 || rf < 4 || rf % 2 != 0 || rp <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  PoseidonInputs in = {};
  for (int k = 0; k < t - 1; k++) {
    in.base[k] = (const int32_t*)bases[k];
    in.lane_stride[k] = lane_strides[k];
    in.limb_stride[k] = limb_strides[k];
  }
  const u32* c = (const u32*)consts;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 2: return launch<2>(in, c, o, n, rf, rp, threads, g, s);
    case 3: return launch<3>(in, c, o, n, rf, rp, threads, g, s);
    case 4: return launch<4>(in, c, o, n, rf, rp, threads, g, s);
    case 5: return launch<5>(in, c, o, n, rf, rp, threads, g, s);
    case 6: return launch<6>(in, c, o, n, rf, rp, threads, g, s);
    case 7: return launch<7>(in, c, o, n, rf, rp, threads, g, s);
    case 8: return launch<8>(in, c, o, n, rf, rp, threads, g, s);
    default: return launch<9>(in, c, o, n, rf, rp, threads, g, s);
  }
}

}  // extern "C"
