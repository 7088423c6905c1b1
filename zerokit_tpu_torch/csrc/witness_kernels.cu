// W1-W2: the witness evaluator on Hopper (circuit/witness_kernels.py).
//
// These are new kernels, not ports of a Pallas kernel: the JAX package
// runs the evaluator as a lax.scan under XLA.
//
// W1 witness_steps<Rich> replaces zerokit_tpu/circuit/witness_eval.py
//    _scan_fn (the scan over one segment's steps, :395-415): ONE launch runs
//    all the steps of a segment. Each step evaluates W = 4 nodes of one
//    level and writes them into its own W-slot window of the slot buffer.
// W2 witness_div replaces _div_apply (:418-423): every Div of one group,
//    a * b^(p-2), inv(0) = 0, one thread per (Div, lane). It runs after its
//    segment's steps, whose values it reads, and before the next segment.
//
// What bounds them: W1 is a chain of ~10.6K dependent steps (depth-20 RLN
// graph) of 2-3 nodes each, a few Fr products a step, so its time is the
// step chain's latency, nearly flat in lanes, and microseconds of bytes and
// products against milliseconds of chain. The design follows from that:
//   * Lanes (proofs) never read each other's values, so a block owns a
//     group of lanes and walks every step of the segment in a loop; no
//     grid-wide sync and no launch per step. One lane is never split over
//     blocks.
//   * Thread mapping: a block is one lane, W = 4 threads, one a node, with
//     a warp barrier (__syncwarp, which orders memory among the lane's
//     threads) after the step's stores. One thread running a lane's W
//     nodes itself, and up to 8 lanes a block, were slower at 16, 64 and
//     256 lanes (PERF.md).
//   * The slot buffer lies lane-major, (lanes, n_slots, 8 words): each
//     operand is one 32-byte load of a lane's own row. A thread issues all
//     loads of its step before its first product, and prefetches the next
//     step's schedule (one 16-byte (op, ia, ib, ic) load per node) meanwhile.
//     Loads are plain ld.global, never the read-only path: a step reads what
//     earlier steps of the same launch stored.
//   * Each thread dispatches on its node's op code; it does not compute all
//     10 or 18 candidates and select, which is the XLA form of the step.
//   * Field core: bn254.cuh's Fr (PTX carry chains, values in [0, 2p)).
//     Its invariant holds: loads are canonical, every store canonicalises,
//     and is_zero and equality read loaded values only. Rich ops go
//     from_mont -> canonical 8x32-bit limb op -> to_mont, as the JAX code
//     does; tests/test_torch_witness_limbs.py models that limb code on
//     Python integers.
// W2 is bound by its exponentiation chain (382 dependent products a thread).

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kW = 4;  // nodes a step (circuit/witness_eval.W), and W1's threads a block
constexpr int kMaxDivThreads = 256;

// op codes of circuit/witness_eval.py
enum : int {
  F_NOP = 0, F_MUL, F_ADD, F_SUB, F_NEG, F_EQ, F_NEQ, F_LAND, F_LOR, F_TERN,
  F_SHR, F_BAND, F_BOR, F_BXOR, F_LT, F_GT, F_LEQ, F_GEQ
};

// 2^256 mod r (one in Montgomery form), 2^512 mod r, (r-1)/2 and r-2
__constant__ u32 kFrOne[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                              0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
__constant__ u32 kFrR2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                             0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
__constant__ u32 kFrHalf[8] = {0xf8000000u, 0xa1f0fac9u, 0x3cdcb848u, 0x9419f424u,
                               0x40c0ac2eu, 0xdc2822dbu, 0x7098d014u, 0x18322739u};
__constant__ u32 kFrPm2[8] = {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                              0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

// a slot's 8 words, 32-byte aligned (the buffer's rows are 8 words)
__device__ __forceinline__ FrE load_slot(const u32* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_slot(u32* p, const FrE& x) {
  FrE c = canon(x);
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(c.v[0], c.v[1], c.v[2], c.v[3]);
  q[1] = make_uint4(c.v[4], c.v[5], c.v[6], c.v[7]);
}

__device__ __forceinline__ FrE constant(const u32 (&k)[8]) {
  FrE r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = k[i];
  return r;
}

__device__ __forceinline__ FrE from_bool(bool f) {
  FrE r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = f ? kFrOne[i] : 0u;
  return r;
}

// canonical inputs only (invariant 3)
__device__ __forceinline__ bool equal(const FrE& a, const FrE& b) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// a < b as 256-bit integers: the borrow of a - b
__device__ __forceinline__ bool lt256(const u32 (&a)[8], const u32 (&b)[8]) {
  u32 d[8];
#pragma unroll
  for (int i = 0; i < 8; i++) d[i] = a[i];
  return sub8(d, b) != 0;
}

// signed a < b on canonical values (graph.rs:456-466): negative above (r-1)/2
__device__ __forceinline__ bool signed_lt(const FrE& a, const FrE& b) {
  u32 half[8];
#pragma unroll
  for (int i = 0; i < 8; i++) half[i] = kFrHalf[i];
  bool a_neg = lt256(half, a.v);
  bool b_neg = lt256(half, b.v);
  return a_neg == b_neg ? lt256(a.v, b.v) : a_neg;
}

// x >> S for a constant S (one stage of the barrel shifter)
template <int S>
__device__ __forceinline__ void shr_const(u32 (&x)[8]) {
  constexpr int off = S / 32, bit = S % 32;
  u32 r[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u32 lo = i + off < 8 ? x[i + off] : 0u;
    u32 hi = i + off + 1 < 8 ? x[i + off + 1] : 0u;
    r[i] = bit ? __funnelshift_r(lo, hi, bit) : lo;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) x[i] = r[i];
}

// a >> b for canonical a, b (graph.rs:328-363): 0 iff b >= 254 as an
// integer, else eight conditional shifts by 2^k on the bits of b's low word
__device__ __forceinline__ void shr_canon(u32 (&x)[8], const u32 (&b)[8]) {
  u32 high = b[1] | b[2] | b[3] | b[4] | b[5] | b[6] | b[7];
  bool big = high != 0 || b[0] >= 254u;
  u32 s = b[0];
  if (s & 1u) shr_const<1>(x);
  if (s & 2u) shr_const<2>(x);
  if (s & 4u) shr_const<4>(x);
  if (s & 8u) shr_const<8>(x);
  if (s & 16u) shr_const<16>(x);
  if (s & 32u) shr_const<32>(x);
  if (s & 64u) shr_const<64>(x);
  if (s & 128u) shr_const<128>(x);
#pragma unroll
  for (int i = 0; i < 8; i++) x[i] = big ? 0u : x[i];
}

// d - r when d > r, else d (graph.rs:365-414; d = r stays r). d < 2^254.
__device__ __forceinline__ void bitwise_fix(u32 (&d)[8]) {
  u32 p[8], e[8];
  load_p<FrTag>(p);
  u32 same = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    e[i] = d[i];
    same |= d[i] ^ p[i];
  }
  bool gt = sub8(e, p) == 0 && same != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) d[i] = gt ? e[i] : d[i];
}

// the rich ops: canonical operands -> result in Montgomery form
__device__ __noinline__ FrE rich_op(int op, FrE a, FrE b) {
  FrE one = {{1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
  FrE ac = canon(mul(a, one));  // from_mont
  FrE bc = canon(mul(b, one));
  FrE d = ac;
  switch (op) {
    case F_SHR: shr_canon(d.v, bc.v); break;
    case F_BAND:
#pragma unroll
      for (int i = 0; i < 8; i++) d.v[i] = ac.v[i] & bc.v[i];
      bitwise_fix(d.v);
      break;
    case F_BOR:
#pragma unroll
      for (int i = 0; i < 8; i++) d.v[i] = ac.v[i] | bc.v[i];
      bitwise_fix(d.v);
      break;
    case F_BXOR:
#pragma unroll
      for (int i = 0; i < 8; i++) d.v[i] = ac.v[i] ^ bc.v[i];
      bitwise_fix(d.v);
      break;
    case F_LT: return from_bool(signed_lt(ac, bc));
    case F_GT: return from_bool(signed_lt(bc, ac));
    case F_LEQ: return from_bool(!signed_lt(bc, ac));
    default: return from_bool(!signed_lt(ac, bc));  // F_GEQ
  }
  return mul(d, constant(kFrR2));  // to_mont
}

// one node: loaded (canonical) operands -> its value in [0, 2p)
template <bool Rich>
__device__ __forceinline__ FrE apply(int op, const FrE& a, const FrE& b, const FrE& c) {
  switch (op) {
    case F_MUL: return mul(a, b);
    case F_ADD: return add(a, b);
    case F_SUB: return sub(a, b);
    case F_NEG: return sub(from_bool(false), a);
    case F_EQ: return from_bool(equal(a, b));
    case F_NEQ: return from_bool(!equal(a, b));
    case F_LAND: return from_bool(!is_zero(a) && !is_zero(b));
    case F_LOR: return from_bool(!is_zero(a) || !is_zero(b));
    case F_TERN: return is_zero(a) ? c : b;
    default: break;
  }
  if constexpr (Rich) return rich_op(op, a, b);
  return a;  // not reached: the wrapper hands a lean segment lean codes only
}

// block = one lane, thread = one node of each step
template <bool Rich>
__global__ void __launch_bounds__(kW)
    witness_steps_kernel(u32* buf, const int4* __restrict__ sched, int steps, i64 write_start,
                         i64 n_slots) {
  u32* base = buf + (i64)blockIdx.x * n_slots * 8;
  u32* out = base + (write_start + threadIdx.x) * 8;
  int4 next = __ldg(sched + threadIdx.x);
  for (int t = 0; t < steps; t++) {
    const int4 node = next;
    FrE a = load_slot(base + (i64)node.y * 8);
    FrE b = load_slot(base + (i64)node.z * 8);
    FrE c = load_slot(base + (i64)node.w * 8);
    if (t + 1 < steps) next = __ldg(sched + (i64)(t + 1) * kW + threadIdx.x);
    if (node.x != F_NOP) store_slot(out + (i64)t * kW * 8, apply<Rich>(node.x, a, b, c));
    __syncwarp((1u << kW) - 1u);  // the step's stores before the next step's loads
  }
}

__device__ __forceinline__ FrE fermat_inv(const FrE& b) {
  FrE r = constant(kFrOne);
#pragma unroll 1
  for (int i = 253; i >= 0; i--) {
    r = sqr(r);
    if ((kFrPm2[i >> 5] >> (i & 31)) & 1u) r = mul(r, b);
  }
  return r;
}

__global__ void __launch_bounds__(kMaxDivThreads)
    witness_div_kernel(u32* buf, const int* __restrict__ ia, const int* __restrict__ ib,
                       const int* __restrict__ out, int n_div, i64 n_slots, int lanes) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (i64)n_div * lanes) return;
  int d = (int)(i % n_div);
  u32* base = buf + (i / n_div) * n_slots * 8;
  FrE a = load_slot(base + (i64)__ldg(ia + d) * 8);
  FrE b = load_slot(base + (i64)__ldg(ib + d) * 8);
  store_slot(base + (i64)__ldg(out + d) * 8, mul(a, fermat_inv(b)));
}

}  // namespace

extern "C" {

// rich: 0 lean, 1 rich segment. buf: (lanes, n_slots, 8) words; sched:
// (steps, 4, 4) int32 (op, ia, ib, ic).
int zk_witness_steps(int rich, void* buf, const void* sched, int steps, long long write_start,
                     long long n_slots, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  u32* pb = (u32*)buf;
  const int4* ps = (const int4*)sched;
  if (rich == 0) {
    witness_steps_kernel<false><<<lanes, kW, 0, s>>>(pb, ps, steps, write_start, n_slots);
  } else {
    witness_steps_kernel<true><<<lanes, kW, 0, s>>>(pb, ps, steps, write_start, n_slots);
  }
  return (int)cudaGetLastError();
}

// buf: (lanes, n_slots, 8) words; ia, ib, out: (n_div,) int32 slots.
int zk_witness_div(void* buf, const void* ia, const void* ib, const void* out, int n_div,
                   long long n_slots, int lanes, int threads, void* stream) {
  if (threads < 32 || threads > kMaxDivThreads) return (int)cudaErrorInvalidValue;
  long long n = (long long)n_div * lanes;
  dim3 grid((unsigned)((n + threads - 1) / threads));
  witness_div_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (u32*)buf, (const int*)ia, (const int*)ib, (const int*)out, n_div, n_slots, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
