// W1-W2: the witness evaluator on Hopper (circuit/witness_kernels.py).
//
// These are new kernels, not ports of a Pallas kernel: the JAX package
// runs the evaluator as a lax.scan under XLA.
//
// W1 witness_steps<Rich> replaces zerokit_tpu/circuit/witness_eval.py
//    _scan_fn (the scan over one segment's steps, :395-415): ONE launch runs
//    all the steps of a segment. Each step evaluates W = 4 nodes of one
//    level, on the slot-file plan of circuit/witness_plan.py.
// W2 witness_div replaces _div_apply (:418-423): every Div of one group,
//    a * b^-1 with inv(0) = 0, one thread per (Div, lane). It runs after its
//    segment's steps, whose values it reads, and before the next segment.
//    The inverse is Bernstein-Yang's constant-time safegcd (below), not the
//    JAX package's Fermat power b^(p-2).
//
// What bounds them: W1 is a chain of ~10.6K dependent steps (depth-20 RLN
// graph) of 2-3 nodes each, a few Fr products a step, so its time is the
// step chain's latency, nearly flat in lanes, and microseconds of bytes and
// products against milliseconds of chain. A step costs a memory round trip
// (store, barrier, load) plus its slowest node. The design follows:
//   * Lanes (proofs) never read each other's values, so a block owns a
//     group of lanes and walks every step of the segment in a loop; no
//     grid-wide sync and no launch per step.
//   * Every operand comes from shared memory (the plan): a block-wide
//     constant table, a per-lane preload area (inputs and the values of
//     earlier segments and W2, copied in at launch start) and a per-lane
//     register file that interval colouring sizes (27 values a lane for
//     the depth-20 graph). Values read outside the launch (signals, W2's
//     operands, later segments) also go to the (lanes, n_slots, 8-word)
//     slot buffer, fire-and-forget; nothing reads them back in the launch.
//     A shared round trip is 77 cycles against 339 through global memory
//     (tools/microbench.measure_latencies, PERF.md).
//   * Thread mapping: 4 warps a block, warp w runs node w of every step for
//     the block's kLanes lanes (one a thread): a warp never diverges over a
//     step's different ops, so a step costs its slowest node, and a block
//     barrier ends each step. (With a lane's 4 threads in one warp, its
//     nodes' ops ran one after another.)
//   * The schedule (16 bytes a node) streams through a shared ring of two
//     halves that cp.async fills one half ahead, off the step chain.
//   * Each thread dispatches on its node's op code; it does not compute all
//     10 or 18 candidates and select, which is the XLA form of the step.
//   * Every Mul, by a constant too, runs bn254.cuh's CIOS `mul` (PTX carry
//     chains, 805 cycles of dependent latency, tools/microbench.py; a Shoup
//     product by a constant measured slower, PERF.md).
//   * Field core: values in registers and in the lanes' file lie in
//     [0, 2p); a store to the slot buffer canonicalises, and equality and
//     the tests of zero canonicalise their operands first. Rich ops go
//     from_mont -> canonical 8x32-bit limb op -> to_mont, as the JAX code
//     does; tests/test_torch_witness_limbs.py models that limb code on
//     Python integers.
// W2 is bound by one thread's inversion chain: 600 divsteps of a few
// dependent integer ops each and 20 limb updates, where Fermat's power was
// 382 dependent CIOS products (PERF.md has both on the H100). A group holds
// too few (Div, lane) pairs to fill the card, so the chain, not the work,
// sets its time; one thread an inversion, since splitting the serial chain
// would only add shuffles.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kW = 4;  // nodes a step (circuit/witness_eval.W), W1's threads a lane
constexpr int kLanes = 2;  // W1's lanes a block (circuit/witness_kernels.LANES_PER_BLOCK)
constexpr int kHalf = kLanes * 4;  // words from a file value's low half to its high half
constexpr int kRingSteps = 64;  // W1's schedule ring (circuit/witness_plan.RING_STEPS)
constexpr int kRingHalf = kRingSteps / 2;
constexpr unsigned kNoReg = 0xffffu;  // circuit/witness_plan.NO_REG
constexpr int kMaxDivThreads = 256;

// op codes of circuit/witness_eval.py
enum : int {
  F_NOP = 0, F_MUL, F_ADD, F_SUB, F_NEG, F_EQ, F_NEQ, F_LAND, F_LOR, F_TERN,
  F_SHR, F_BAND, F_BOR, F_BXOR, F_LT, F_GT, F_LEQ, F_GEQ
};

// 2^256 mod r (one in Montgomery form), 2^512 mod r and (r-1)/2
__constant__ u32 kFrOne[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                              0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
__constant__ u32 kFrR2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                             0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
__constant__ u32 kFrHalf[8] = {0xf8000000u, 0xa1f0fac9u, 0x3cdcb848u, 0x9419f424u,
                               0x40c0ac2eu, 0xdc2822dbu, 0x7098d014u, 0x18322739u};

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

// the rich ops: operands in [0, 2p) -> result in Montgomery form
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

// one node: operands in [0, 2p) -> its value in [0, 2p). The comparisons
// and tests of zero make their operands canonical first (invariant 3 of
// bn254.cuh); the rich ops do in rich_op.
template <bool Rich>
__device__ __forceinline__ FrE apply(int op, const FrE& a, const FrE& b, const FrE& c) {
  switch (op) {  // (Mul and Add: the step loop runs them before this switch)
    case F_SUB: return sub(a, b);
    case F_NEG: return sub(from_bool(false), a);
    case F_EQ: return from_bool(equal(canon(a), canon(b)));
    case F_NEQ: return from_bool(!equal(canon(a), canon(b)));
    case F_LAND: return from_bool(!is_zero(canon(a)) && !is_zero(canon(b)));
    case F_LOR: return from_bool(!is_zero(canon(a)) || !is_zero(canon(b)));
    case F_TERN: return is_zero(canon(a)) ? c : b;
    default: break;
  }
  if constexpr (Rich) return rich_op(op, a, b);
  return a;  // not reached: the wrapper hands a lean segment lean codes only
}

// ---------------------------------------------------------------------------
// W1: the shared-memory slot file (circuit/witness_plan.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// the records of ring chunk h (steps h * kRingHalf ..) into ring half h % 2
__device__ __forceinline__ void fill_ring(int4* ring, const int4* rec, int h, int steps) {
  int first = h * kRingHalf;
  int n = max(0, min(kRingHalf, steps - first)) * kW;
  int4* dst = ring + (h & 1) * kRingHalf * kW;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async16(dst + i, rec + (i64)first * kW + i);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A block holds kLanes lanes and kW warps: warp w runs node w of every step
// for the block's lanes, one lane a thread, so a warp never diverges over a
// step's different ops and a step takes its slowest node, not the sum of
// its nodes' ops. A block barrier ends each step.
// Shared memory (words): the schedule ring, the constant table, then the
// lanes' file, lane-interleaved by 16-byte half: half h of value v of lane
// l at ((2 v + h) kLanes + l) * 4, so a warp's loads of one value hit
// consecutive 16-byte units. A reference r < n_consts names constant r
// (the same address for every lane), else value r - n_consts of the lane's
// file (preload area, then registers). File values lie in [0, 2p), like
// values in registers; constants, preloaded values and the slot buffer
// are canonical.
template <bool Rich>
__global__ void __launch_bounds__(kW * 32)
    witness_steps_kernel(u32* buf, const int4* __restrict__ rec, int steps,
                         const int* __restrict__ preload, int n_pre, int n_regs,
                         const u32* __restrict__ consts, int n_consts, i64 n_slots, int lanes) {
  extern __shared__ __align__(16) u32 smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  u32* sconst = smem + kRingSteps * kW * 4;
  const int node = threadIdx.x / 32, l = threadIdx.x % 32;
  const int lane = blockIdx.x * kLanes + l;
  const bool live = l < kLanes && lane < lanes;
  u32* gbase = buf + (i64)(live ? lane : 0) * n_slots * 8;
  // every thread of a warp runs its node (the branches stay warp-uniform);
  // threads past the block's lanes read lane 0's file and store nothing
  u32* mine = sconst + n_consts * 8 + (l < kLanes ? l : 0) * 4;
  // a reference r >= n_consts: value r - n_consts of the lane's file, at
  // words file0 + r * 2 * kHalf of smem (halves kHalf apart)
  const int file0 = (int)(mine - smem) - n_consts * 2 * kHalf;

  fill_ring(ring, rec, 0, steps);
  const uint4* gc = reinterpret_cast<const uint4*>(consts);
  for (int i = threadIdx.x; i < n_consts * 2; i += blockDim.x)
    reinterpret_cast<uint4*>(sconst)[i] = __ldg(gc + i);
  if (live) {  // warp w copies halves w, w + kW, ... of the lane's preload area
    for (int i = node; i < n_pre * 2; i += kW)
      *reinterpret_cast<uint4*>(mine + i * kHalf) =
          reinterpret_cast<const uint4*>(gbase + (i64)__ldg(preload + i / 2) * 8)[i % 2];
  }
  auto load_ref = [&](u32 ref) -> FrE {
    const bool k = ref < (u32)n_consts;
    const u32* p = k ? sconst + ref * 8 : smem + file0 + ref * 2 * kHalf;
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + (k ? 4 : kHalf));
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  };

  // the first chunk of the schedule, then the next one in flight (an empty
  // group when there is none)
  fill_ring(ring, rec, 1, steps);
  asm volatile("cp.async.wait_group %0;" ::"n"(1) : "memory");
  __syncthreads();

  // Per step, on the chain: operand loads, the node's op, the register
  // write, the barrier. Off it: the next record's load, issued before the
  // op. Chunk h + 1 of the ring is waited for in the step before its first
  // record is read, and chunk h + 2 fetched into chunk h's half once every
  // record of chunk h is read.
  int4 next = ring[node];
#pragma unroll 2  // fewer loop instructions on the step chain
  for (int t = 0; t < steps; t++) {
    const int4 r = next;
    if (t + 1 < steps) next = ring[((t + 1) % kRingSteps) * kW + node];
    if (t % kRingHalf == kRingHalf - 1 && t + 1 + kRingHalf < steps)
      fill_ring(ring, rec, (t + 1) / kRingHalf + 1, steps);
    const int op = r.x & 0xffff;
    if (op != F_NOP) {
      const FrE a = load_ref((u32)r.y & 0xffffu);
      const FrE b = load_ref((u32)r.y >> 16);
      FrE v;
      if (op == F_MUL) {  // the frequent ops before apply's chain of compares and branches
        v = mul(a, b);
      } else if (op == F_ADD) {
        v = add(a, b);
      } else {
        v = apply<Rich>(op, a, b, op == F_TERN ? load_ref((u32)r.z) : a);
      }
      const u32 dst = (u32)r.x >> 16;
      if (live && dst != kNoReg) {
        u32* p = smem + file0 + dst * 2 * kHalf;
        *reinterpret_cast<uint4*>(p) = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
        *reinterpret_cast<uint4*>(p + kHalf) = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
      }
      if (live && r.w >= 0) store_slot(gbase + (i64)r.w * 8, v);
    }
    if (t % kRingHalf == kRingHalf - 2) asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the step's register writes (and a landed chunk) before the next step
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <bool Rich>
int launch_steps(u32* buf, const int4* rec, int steps, const int* preload, int n_pre, int n_regs,
                 const u32* consts, int n_consts, i64 n_slots, int lanes, int bytes,
                 cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(witness_steps_kernel<Rich>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((lanes + kLanes - 1) / kLanes));
  witness_steps_kernel<Rich><<<grid, kW * 32, bytes, s>>>(buf, rec, steps, preload, n_pre, n_regs,
                                                          consts, n_consts, n_slots, lanes);
  return (int)cudaGetLastError();
}

template <bool Rich>
int steps_occupancy(int bytes, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(witness_steps_kernel<Rich>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, witness_steps_kernel<Rich>, kW * 32,
                                                      bytes);
  return (int)e;
}

// ---------------------------------------------------------------------------
// W2: Fr inversion by safegcd, in constant time
// ---------------------------------------------------------------------------
//
// The 32-bit constant-time form of libsecp256k1's secp256k1_modinv32
// (Bernstein and Yang, "Fast constant-time gcd computation and modular
// inversion"; Wuille, "The safegcd implementation in libsecp256k1
// explained"). f, g, d, e are 9 signed-30-bit limbs (limb i holds bits
// 30i .. 30i + 29; limbs 0-7 in [0, 2^30), limb 8 signed). Each of 20
// batches runs 30 half-delta divsteps on the low limbs of f and g alone
// (divsteps30: zeta = -(delta + 1/2), masks and no branch), then applies
// their 2x2 matrix to (f, g) exactly and to (d, e) mod r, both divided by
// 2^30 (update_fg, update_de). 590 divsteps bring g to 0 for any odd
// modulus below 2^256 (r < 2^254), so the fixed 600 need no test of g:
// every thread runs the same instructions whatever its input, as Fermat's
// chain did. g = 0 at the start leaves d = 0, so inv(0) = 0.
// tests/test_torch_witness_div.py runs this code on Python integers.

constexpr int kM30 = 0x3fffffff;  // 2^30 - 1
constexpr int kBatches = 20, kBatchSteps = 30;
constexpr u32 kFrInv30 = 0x10000001u;  // r^-1 mod 2^30
// r in signed-30 limbs
__constant__ int kFrS30[9] = {0x30000001, 0x0f87d64f, 0x1b970914, 0x0cfa121e, 0x01585d28,
                              0x0116da06, 0x1a029b85, 0x139cb84c, 0x00003064};

struct S30 {
  int v[9];
};
struct Trans {  // 2^30 times a batch's matrix [[u, v], [q, r]], entries in [-2^30, 2^30]
  int u, v, q, r;
};

// 8 words (a value below 2^256) -> 9 limbs of 30 bits
__device__ __forceinline__ S30 to_s30(const u32 (&w)[8]) {
  S30 x;
  u64 acc = 0;
  int bits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    if (k < 8) {
      acc |= (u64)w[k++] << bits;
      bits += 32;
    }
    x.v[i] = (int)(acc & kM30);
    acc >>= 30;
    bits -= 30;
  }
  return x;
}

// 9 limbs in [0, 2^30) -> 8 words
__device__ __forceinline__ void from_s30(u32 (&w)[8], const S30& x) {
  u64 acc = 0;
  int bits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    acc |= (u64)(u32)x.v[i] << bits;
    bits += 30;
    if (bits >= 32) {
      w[k++] = (u32)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
}

// 30 divsteps on the low 30 bits of f and g (f odd). The matrix entries
// run as unsigned words: a left shift of a negative value is undefined.
__device__ __forceinline__ int divsteps30(int zeta, u32 f, u32 g, Trans& t) {
  u32 u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < kBatchSteps; i++) {
    u32 c1 = (u32)(zeta >> 31);  // zeta < 0
    u32 c2 = 0u - (g & 1u);  // g odd
    u32 x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;  // zeta < 0 and g odd: swap (f, g) = (g, -f)
    zeta = (zeta ^ (int)c1) - 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = {(int)u, (int)v, (int)q, (int)r};
  return zeta;
}

// (d, e) = (t (d, e) + r (md, me)) / 2^30, md and me chosen so that the low
// 30 bits vanish; d, e stay in (-2r, r)
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t) {
  const int sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int md = (t.u & sd) + (t.v & se);
  int me = (t.q & sd) + (t.r & se);
  i64 cd = (i64)t.u * d.v[0] + (i64)t.v * e.v[0];
  i64 ce = (i64)t.q * d.v[0] + (i64)t.r * e.v[0];
  md -= (int)((kFrInv30 * (u32)cd + (u32)md) & kM30);
  me -= (int)((kFrInv30 * (u32)ce + (u32)me) & kM30);
  cd += (i64)kFrS30[0] * md;
  ce += (i64)kFrS30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (i64)t.u * d.v[i] + (i64)t.v * e.v[i] + (i64)kFrS30[i] * md;
    ce += (i64)t.q * d.v[i] + (i64)t.r * e.v[i] + (i64)kFrS30[i] * me;
    d.v[i - 1] = (int)cd & kM30;
    e.v[i - 1] = (int)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int)cd;
  e.v[8] = (int)ce;
}

// (f, g) = t (f, g) / 2^30, exact
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  i64 cf = (i64)t.u * f.v[0] + (i64)t.v * g.v[0];
  i64 cg = (i64)t.q * f.v[0] + (i64)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (i64)t.u * f.v[i] + (i64)t.v * g.v[i];
    cg += (i64)t.q * f.v[i] + (i64)t.r * g.v[i];
    f.v[i - 1] = (int)cf & kM30;
    g.v[i - 1] = (int)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int)cf;
  g.v[8] = (int)cg;
}

// x in (-2r, r), negated when sign < 0 -> [0, r), limbs in [0, 2^30)
__device__ __forceinline__ void normalize(S30& x, int sign) {
  int add = x.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) x.v[i] += kFrS30[i] & add;
  const int neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) x.v[i] = (x.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    x.v[i + 1] += x.v[i] >> 30;
    x.v[i] &= kM30;
  }
  add = x.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) x.v[i] += kFrS30[i] & add;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    x.v[i + 1] += x.v[i] >> 30;
    x.v[i] &= kM30;
  }
}

// b^-1 R mod r for b = bR canonical (Montgomery form), 0 for b = 0. e
// starts at R^2 mod r, not 1: the updates are linear in (d, e), so d ends
// at R^2 (bR)^-1 = b^-1 R, the inverse in Montgomery form with no product.
__device__ __forceinline__ FrE safegcd_inv(const FrE& b) {
  S30 d = {}, e = to_s30(constant(kFrR2).v), f, g = to_s30(b.v);
#pragma unroll
  for (int i = 0; i < 9; i++) f.v[i] = kFrS30[i];
  int zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int i = 0; i < kBatches; i++) {
    Trans t;
    zeta = divsteps30(zeta, (u32)f.v[0], (u32)g.v[0], t);
    update_de(d, e, t);
    update_fg(f, g, t);
  }
  normalize(d, f.v[8]);  // f = +-1: d = +-b^-1 R
  FrE x;
  from_s30(x.v, d);
  return x;
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
  store_slot(base + (i64)__ldg(out + d) * 8, mul(a, safegcd_inv(b)));
}

}  // namespace

extern "C" {

// rich: 0 lean, 1 rich segment. buf: (lanes, n_slots, 8) words; records:
// (steps, 4, 4) int32 (circuit/witness_plan.py); preload: (n_pre,) slots;
// consts: (n_consts, 8) words; smem_bytes: the block's dynamic shared
// memory (circuit/witness_kernels.steps_smem_bytes). More than the card
// gives is an error: there is no other path.
int zk_witness_steps(int rich, void* buf, const void* records, int steps, const void* preload,
                     int n_pre, int n_regs, const void* consts, int n_consts, long long n_slots,
                     int lanes, int smem_bytes, void* stream) {
  auto f = rich ? launch_steps<true> : launch_steps<false>;
  return f((u32*)buf, (const int4*)records, steps, (const int*)preload, n_pre, n_regs,
           (const u32*)consts, n_consts, n_slots, lanes, smem_bytes, (cudaStream_t)stream);
}

// blocks of W1 an SM holds with smem_bytes of dynamic shared memory a block
int zk_witness_steps_occupancy(int rich, int smem_bytes, int* blocks) {
  return rich ? steps_occupancy<true>(smem_bytes, blocks)
              : steps_occupancy<false>(smem_bytes, blocks);
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
