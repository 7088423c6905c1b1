// P1: the batched Poseidon permutation over BN254 Fr on Hopper.
//
// Replaces zerokit_tpu/hash/poseidon.py _batched_permutation(t) (:132), a
// jitted lax.scan under XLA, not Pallas. The state is [0, inputs...] of
// T = 2..9 lanes; RF full rounds and RP partial rounds each add the round
// constants, raise to x^5 (every lane in a full round, lane 0 in a partial
// one) and mix by the MDS matrix; the output is state[0]. Values are
// Montgomery Fr (radix 2^256) in the package's (16, n) int32 16-bit limbs.
//
// A first design, simple and right: one thread a hash, the state T x 8
// words in registers on bn254.cuh's Fr core. Register values lie in
// [0, 2r), and three of them can pass 2^256 (r ~ 0.19 * 2^256), so each MDS
// row sum goes through `add` term by term, which brings every partial sum
// back below 2r. The (RF + RP) x T round constants and the T x T MDS
// matrix (Montgomery, canonical, 8 words each) are staged from a device
// table into shared memory at block start: 6.5 KB at T = 3, 23 KB at T = 9
// (the eight tables together, ~97 KB, do not fit __constant__'s 64 KB).
// Every thread of a warp reads the same constant: a broadcast.
//
// Each input is a base pointer with a lane stride and a limb stride, so a
// tree level (16, 2n) is read in place as its own lefts (lane stride 2)
// and rights (offset 1, lane stride 2). The output is made canonical once,
// in store8 (bn254.cuh invariant 2).
//
// T = 2..4 (the protocol's arities) inline every product. From T = 5 the
// MDS products of a round grow as T^2 (up to 81 at T = 9), and inlined
// they would make the build's straight-line code several hundred KB, so
// those widths call one out-of-line product with its operands by value,
// as the Fq2 products do (fq2_part_mul); the round loops are not unrolled
// at any T.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInputs = 8;

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

// one round: ark add, sbox (every lane if Full, else lane 0), MDS mix
template <int T, bool Full>
__device__ __forceinline__ void poseidon_round(FrE (&s)[T], const u32* ark, const u32* mds) {
  constexpr bool kInline = T <= 4;
#pragma unroll
  for (int k = 0; k < T; k++) s[k] = add(s[k], smem_elem(ark + 8 * k));
  if constexpr (Full) {
#pragma unroll
    for (int k = 0; k < T; k++) s[k] = pow5<kInline>(s[k]);
  } else {
    s[0] = pow5<kInline>(s[0]);
  }
  FrE acc[T];
#pragma unroll
  for (int r = 0; r < T; r++) {
    acc[r] = fr_mul<kInline>(smem_elem(mds + 8 * (r * T)), s[0]);
#pragma unroll
    for (int c = 1; c < T; c++) {
      acc[r] = add(acc[r], fr_mul<kInline>(smem_elem(mds + 8 * (r * T + c)), s[c]));
    }
  }
#pragma unroll
  for (int r = 0; r < T; r++) s[r] = acc[r];
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    poseidon_kernel(const u32* __restrict__ consts, PoseidonInputs in, int32_t* __restrict__ out,
                    i64 n, int rf, int rp) {
  extern __shared__ __align__(16) u32 table[];
  const int vec = ((rf + rp) * T + T * T) * 2;  // 16-byte words of the table
  for (int w = threadIdx.x; w < vec; w += blockDim.x) {
    reinterpret_cast<uint4*>(table)[w] = __ldg(reinterpret_cast<const uint4*>(consts) + w);
  }
  __syncthreads();
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FrE s[T];
#pragma unroll
  for (int w = 0; w < 8; w++) s[0].v[w] = 0;
#pragma unroll
  for (int k = 1; k < T; k++) {
    load8(s[k].v, in.base[k - 1] + i * in.lane_stride[k - 1], in.limb_stride[k - 1]);
  }
  const u32* mds = table + (rf + rp) * T * 8;
  const int half = rf / 2;
#pragma unroll 1
  for (int r = 0; r < half; r++) poseidon_round<T, true>(s, table + r * T * 8, mds);
#pragma unroll 1
  for (int r = half; r < half + rp; r++) poseidon_round<T, false>(s, table + r * T * 8, mds);
#pragma unroll 1
  for (int r = half + rp; r < rf + rp; r++) poseidon_round<T, true>(s, table + r * T * 8, mds);
  store8(out + i, n, s[0]);
}

template <int T>
int launch(const PoseidonInputs& in, const u32* consts, int32_t* out, i64 n, int rf, int rp,
           cudaStream_t s) {
  size_t smem = (size_t)((rf + rp) * T + T * T) * 8 * sizeof(u32);
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  poseidon_kernel<T><<<blocks, kThreads, smem, s>>>(consts, in, out, n, rf, rp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// t = 2..9; rf (even), rp: the round counts of params_for_t(t). consts: the
// device table of (rf + rp) * t round constants then t * t MDS entries,
// Montgomery, 8 little-endian u32 words each, 16-byte aligned. bases,
// lane_strides, limb_strides: host arrays of the t - 1 inputs' device
// pointers and strides in int32 words (limb i of lane j of input k at
// bases[k] + j * lane_strides[k] + i * limb_strides[k]). out: (16, n).
int zk_poseidon(int t, int rf, int rp, const void* consts, const long long* bases,
                const long long* lane_strides, const long long* limb_strides, void* out,
                long long n, void* stream) {
  if (t < 2 || t > kMaxInputs + 1 || rf <= 0 || rf % 2 != 0 || rp <= 0) {
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
    case 2: return launch<2>(in, c, o, n, rf, rp, s);
    case 3: return launch<3>(in, c, o, n, rf, rp, s);
    case 4: return launch<4>(in, c, o, n, rf, rp, s);
    case 5: return launch<5>(in, c, o, n, rf, rp, s);
    case 6: return launch<6>(in, c, o, n, rf, rp, s);
    case 7: return launch<7>(in, c, o, n, rf, rp, s);
    case 8: return launch<8>(in, c, o, n, rf, rp, s);
    default: return launch<9>(in, c, o, n, rf, rp, s);
  }
}

}  // extern "C"
