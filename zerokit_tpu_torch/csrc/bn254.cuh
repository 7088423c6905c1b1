// BN254 Fr / Fq / Fq2 Montgomery arithmetic and the RCB15 group laws as
// __device__ templates, shared by the kernel sources of csrc/.
//
// Counterpart of the row-list arithmetic inside the TPU kernels
// (zerokit_tpu/ff/pallas_field.py RowField, RowFqAdapter, RowFq2Adapter,
// rcb_add / rcb_add_mixed / rcb_double). A field element lives in registers
// as 8 little-endian 32-bit limbs; the tensors in device memory keep the
// package layout of 16-bit limbs in int32 words, and load8/store8 repack.
// Montgomery radix R = 2^256 in both forms, so the integers are the same.
//
// The register-resident core (Hopper):
//   * Carry chains are PTX: the CIOS product's rows are mad.lo.cc /
//     madc.hi.cc chains, add and sub are add.cc/addc and sub.cc/subc
//     chains. The carry flag does not survive from one asm statement to
//     the next, so every chain starts and ends inside one asm statement.
//   * The product splits each row's partial products by limb parity, as
//     the open GPU provers do: even limbs' 64-bit products land on word
//     pairs (j, j+1) of one accumulator, odd limbs' on the other, shifted
//     by a word, so each lo/hi pair of a 32x32 product is one 64-bit
//     multiply-add with carry (IMAD.WIDE) and a row is two chains.
//   * `mul` is __forceinline__, and the G1, Fr and K1 kernels inline every
//     product: ptxas reports no stack frame for them. The Fq products
//     inside Fq2 products go through one out-of-line function with its
//     operands by value (fq2_part_mul), which ptxas also gives no stack
//     frame. Inlined, nvcc 12.8 builds the G2 kernels, but a G2 add becomes
//     ~11K straight-line instructions (~180 KB of code) at 255 registers,
//     and it ran 1.7x slower than out of line on the H100 (PERF.md).
//   * Lazy reduction. Values in registers lie in [0, 2p), not [0, p): with
//     a, b < 2p and 4p < 2^256 (true for Fr and Fq) the CIOS loop ends
//     below 2p, so the product has no final subtraction; add brings a sum
//     below 4p back below 2p, sub adds 2p on a borrow. Field operations
//     are homomorphic mod p, so a value made canonical is the integer the
//     plain version gives.
//
// INVARIANTS. (1) Every value loaded from device memory is canonical
// (< p): the tensors hold canonical limbs. (2) A value is made canonical
// exactly once, before it leaves the thread: store8 (and so store_elem,
// store_proj, store_point) and put_point. (3) is_zero reads canonical
// values only, i.e. loaded inputs (the affine sentinel of rcb_add_mixed);
// a computed value may be p where the plain version holds 0.

#pragma once

#include <cstdint>

namespace zk {

typedef uint32_t u32;
typedef uint64_t u64;
typedef long long i64;

static __constant__ u32 kFrP[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                                   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ u32 kFrP2[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                                    0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
static __constant__ u32 kFqP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ u32 kFqP2[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                                    0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
// R mod q: one in Montgomery form
static __constant__ u32 kFqOne[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// 3 * b of the G2 twist (b = 3 / (9 + u)) in Montgomery form, (c0, c1)
static __constant__ u32 kB3G2[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u, 0xd95d4664u, 0x03873e63u,
     0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u, 0x680401ffu, 0x85dd7297u,
     0xdf39a7e9u, 0x03c52d6au}};

struct FrTag {
  static constexpr u32 NINV0 = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ static __forceinline__ u32 p(int i) { return kFrP[i]; }
  __device__ static __forceinline__ u32 p2(int i) { return kFrP2[i]; }
};
struct FqTag {
  static constexpr u32 NINV0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ static __forceinline__ u32 p(int i) { return kFqP[i]; }
  __device__ static __forceinline__ u32 p2(int i) { return kFqP2[i]; }
};

template <class F>
struct Elem {
  u32 v[8];
};
typedef Elem<FrTag> FrE;
typedef Elem<FqTag> FqE;
struct Fq2E {
  FqE c0, c1;
};

// ---------------------------------------------------------------------------
// 256-bit carry chains (PTX). Each is one asm statement.
// ---------------------------------------------------------------------------

// r += b (mod 2^256)
__device__ __forceinline__ void add8(u32 (&r)[8], const u32 (&b)[8]) {
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// r -= b (mod 2^256); returns 0xffffffff on a borrow, else 0
__device__ __forceinline__ u32 sub8(u32 (&r)[8], const u32 (&b)[8]) {
  u32 borrow;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "=r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return borrow;
}

// One row i >= 1 of the CIOS product, t += a * b_i, on the accumulator
// t = e + 2^32 * o (e holds the even limbs' products, o the odd limbs'
// shifted down a word). The caller passes the previous row's o as e and
// its e as o: that is the previous row's division by 2^32, where e[0] was
// 0 and e[1] joins the new e[0] (first instruction) and e[2..7] become the
// new o[0..5] (the odd chain reads them two words up).
__device__ __forceinline__ void mad_row(u32 (&e)[8], u32 (&o)[8], const u32 (&a)[8], u32 bi) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %8, %17, %24, %10;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %11;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %12;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %13;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %14;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %15;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, 0;\n\t"
      "madc.hi.u32 %15, %23, %24, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(bi));
}

// The row's reduction: m = e[0] * n0', t += m * p, so that e[0] becomes 0.
// The odd chain ends without a carry out: t < 2^288 (below), so o < 2^256
// at every step; the even chain's carry lands on o[7].
__device__ __forceinline__ void redc_row(u32 (&e)[8], u32 (&o)[8], const u32 (&p)[8], u32 ninv0) {
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32 m, %0, %24;\n\t"
      "mad.lo.cc.u32 %8, %17, m, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, m, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, m, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, m, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, m, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, m, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, m, %14;\n\t"
      "madc.hi.u32 %15, %23, m, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, m, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, m, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, m, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, m, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, m, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, m, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, m, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, m, %7;\n\t"
      "addc.u32 %15, %15, 0;\n\t"
      "}"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]),
        "r"(ninv0));
}

// t += a * bi on the accumulator t = e + 2^32 * o within a row, with no
// division by 2^32: the other products of a row that mad_row (or mul's
// row 0) began, for mul_sum. The odd chain ends without a carry out, as in
// redc_row (t < 2^288, see mul_sum); the even chain's carry lands on o[7].
__device__ __forceinline__ void mac_row(u32 (&e)[8], u32 (&o)[8], const u32 (&a)[8], u32 bi) {
  asm("mad.lo.cc.u32 %8, %17, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, %14;\n\t"
      "madc.hi.u32 %15, %23, %24, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(bi));
}

// r = e + o / 2^32 (o[0] is 0): the product's last division by 2^32
__device__ __forceinline__ void merge_row(u32 (&r)[8], const u32 (&o)[8]) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
}

// ---------------------------------------------------------------------------
// Prime-field arithmetic: inputs and outputs in [0, 2p)
// ---------------------------------------------------------------------------

template <class F>
__device__ __forceinline__ void load_p(u32 (&p)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i] = F::p(i);
}
template <class F>
__device__ __forceinline__ void load_p2(u32 (&p)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i] = F::p2(i);
}

// x mod p for x < 2p: the canonical representative
template <class F>
__device__ __forceinline__ Elem<F> canon(const Elem<F>& x) {
  u32 p[8];
  load_p<F>(p);
  Elem<F> d = x;
  u32 borrow = sub8(d.v, p);
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = borrow ? x.v[i] : d.v[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem<F> add(const Elem<F>& a, const Elem<F>& b) {
  u32 p2[8];
  load_p2<F>(p2);
  Elem<F> s = a;
  add8(s.v, b.v);  // < 4p < 2^256
  Elem<F> d = s;
  u32 borrow = sub8(d.v, p2);
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = borrow ? s.v[i] : d.v[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem<F> sub(const Elem<F>& a, const Elem<F>& b) {
  Elem<F> d = a;
  u32 borrow = sub8(d.v, b.v);
  u32 back[8];
#pragma unroll
  for (int i = 0; i < 8; i++) back[i] = F::p2(i) & borrow;
  add8(d.v, back);
  return d;
}

// CIOS Montgomery product a*b/2^256 mod p, in [0, 2p) for a, b < 2p: the
// accumulator t stays below (a + p) * 2^32 < 2^288 before each row's
// division, and ends below 2p since 4p < 2^256. Row 0 needs no additions.
template <class F>
__device__ __forceinline__ Elem<F> mul(const Elem<F>& a, const Elem<F>& b) {
  u32 p[8];
  load_p<F>(p);
  u32 ev[8], od[8];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    ev[j] = a.v[j] * b.v[0];
    ev[j + 1] = __umulhi(a.v[j], b.v[0]);
    od[j] = a.v[j + 1] * b.v[0];
    od[j + 1] = __umulhi(a.v[j + 1], b.v[0]);
  }
  redc_row(ev, od, p, F::NINV0);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    mad_row(od, ev, a.v, b.v[i]);
    redc_row(od, ev, p, F::NINV0);
    if (i + 1 < 8) {
      mad_row(ev, od, a.v, b.v[i + 1]);
      redc_row(ev, od, p, F::NINV0);
    }
  }
  merge_row(ev, od);
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = ev[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem<F> sqr(const Elem<F>& a) {
  return mul(a, a);
}

// A row of N products by constants, sum_k a[k] * b[k] / 2^256 mod p, with
// one reduction for the row: the CIOS loop over the sum, each outer row
// adding every a[k] * b[k]_i (mad_row, then mac_row) before its one
// redc_row, so a row of N products costs 128 N + 136 multiplies where N
// products cost 264 N. The a[k] are canonical (< p) and the b[k] lie in
// [0, 2p); with (N + 1) p < 2^256 (N <= 4 for Fr and Fq) the accumulator
// stays below (sum a + p) 2^32 < 2^288 before each reduction, and the
// result below sum a b / 2^256 + p < (1 + 2N p / 2^256) p: below 1.76p at
// N = 2, below 2.52p at N <= 4, where one conditional subtraction of 2p
// brings it into [0, 2p).
template <class F, int N>
__device__ __forceinline__ Elem<F> mul_sum(const Elem<F> (&a)[N], const Elem<F> (&b)[N]) {
  static_assert(N >= 2 && N <= 4, "mul_sum: (N + 1) p must stay below 2^256");
  u32 p[8], p2[8];
  load_p<F>(p);
  load_p2<F>(p2);
  u32 ev[8], od[8];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    ev[j] = a[0].v[j] * b[0].v[0];
    ev[j + 1] = __umulhi(a[0].v[j], b[0].v[0]);
    od[j] = a[0].v[j + 1] * b[0].v[0];
    od[j + 1] = __umulhi(a[0].v[j + 1], b[0].v[0]);
  }
#pragma unroll
  for (int k = 1; k < N; k++) mac_row(ev, od, a[k].v, b[k].v[0]);
  redc_row(ev, od, p, F::NINV0);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    mad_row(od, ev, a[0].v, b[0].v[i]);
#pragma unroll
    for (int k = 1; k < N; k++) mac_row(od, ev, a[k].v, b[k].v[i]);
    redc_row(od, ev, p, F::NINV0);
    if (i + 1 < 8) {
      mad_row(ev, od, a[0].v, b[0].v[i + 1]);
#pragma unroll
      for (int k = 1; k < N; k++) mac_row(ev, od, a[k].v, b[k].v[i + 1]);
      redc_row(ev, od, p, F::NINV0);
    }
  }
  merge_row(ev, od);
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = ev[i];
#pragma unroll
  for (int s = 2; s < N; s += 2) {
    Elem<F> d = r;
    u32 borrow = sub8(d.v, p2);
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = borrow ? r.v[i] : d.v[i];
  }
  return r;
}

// canonical inputs only (invariant 3)
template <class F>
__device__ __forceinline__ bool is_zero(const Elem<F>& a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

// ---------------------------------------------------------------------------
// Device memory <-> registers. A field element's 16-bit limb i sits at
// base[i * stride]; 32-bit limb k packs limbs 2k and 2k+1. store8 writes the
// canonical representative.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(u32 v[8], const int32_t* base, i64 stride) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    v[k] = (u32)base[(2 * k) * stride] | ((u32)base[(2 * k + 1) * stride] << 16);
  }
}

template <class F>
__device__ __forceinline__ void store8(int32_t* base, i64 stride, const Elem<F>& x) {
  Elem<F> c = canon(x);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    base[(2 * k) * stride] = (int32_t)(c.v[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(c.v[k] >> 16);
  }
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

// the Fq products inside Fq2 products, out of line (see the top)
static __device__ __noinline__ FqE fq2_part_mul(FqE a, FqE b) { return mul(a, b); }

__device__ __forceinline__ Fq2E add(const Fq2E& a, const Fq2E& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2E sub(const Fq2E& a, const Fq2E& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2E mul(const Fq2E& a, const Fq2E& b) {
  FqE t0 = fq2_part_mul(a.c0, b.c0);
  FqE t1 = fq2_part_mul(a.c1, b.c1);
  FqE t2 = fq2_part_mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}
__device__ __forceinline__ Fq2E sqr(const Fq2E& a) {
  FqE c0 = fq2_part_mul(add(a.c0, a.c1), sub(a.c0, a.c1));
  FqE t = fq2_part_mul(a.c0, a.c1);
  return {c0, add(t, t)};
}
__device__ __forceinline__ bool is_zero(const Fq2E& a) { return is_zero(a.c0) && is_zero(a.c1); }

// a * 3b: G1 (b = 3) as 8a + a by additions; G2 as one Fq2 product
__device__ __forceinline__ FqE b3_mul(const FqE& a) {
  FqE d = add(a, a);
  d = add(d, d);
  d = add(d, d);
  return add(d, a);
}
__device__ __forceinline__ Fq2E b3_mul(const Fq2E& a) {
  Fq2E c;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c.c0.v[i] = kB3G2[0][i];
    c.c1.v[i] = kB3G2[1][i];
  }
  return mul(a, c);
}

// ---------------------------------------------------------------------------
// Points. In device memory a point is (16, C, coords) limb-major words at
// one lane: word (i*C + m)*coords + c at offset word * n. An AoS point row
// is the same at n = 1: 16*C*coords consecutive words.
// ---------------------------------------------------------------------------

template <class E>
struct Proj {
  E x, y, z;
};
template <class E>
struct Aff {
  E x, y;
};

__device__ __forceinline__ void load_elem(FqE& e, const int32_t* lane, int coords, int c, i64 n) {
  load8(e.v, lane + c * n, coords * n);
}
__device__ __forceinline__ void load_elem(Fq2E& e, const int32_t* lane, int coords, int c, i64 n) {
  load8(e.c0.v, lane + c * n, 2 * coords * n);
  load8(e.c1.v, lane + (coords + c) * n, 2 * coords * n);
}
__device__ __forceinline__ void store_elem(int32_t* lane, int c, i64 n, const FqE& e) {
  store8(lane + c * n, 3 * n, e);
}
__device__ __forceinline__ void store_elem(int32_t* lane, int c, i64 n, const Fq2E& e) {
  store8(lane + c * n, 6 * n, e.c0);
  store8(lane + (3 + c) * n, 6 * n, e.c1);
}

template <class E>
__device__ __forceinline__ Proj<E> load_proj(const int32_t* lane, i64 n) {
  Proj<E> p;
  load_elem(p.x, lane, 3, 0, n);
  load_elem(p.y, lane, 3, 1, n);
  load_elem(p.z, lane, 3, 2, n);
  return p;
}
template <class E>
__device__ __forceinline__ Aff<E> load_aff(const int32_t* lane, i64 n) {
  Aff<E> p;
  load_elem(p.x, lane, 2, 0, n);
  load_elem(p.y, lane, 2, 1, n);
  return p;
}
template <class E>
__device__ __forceinline__ void store_proj(int32_t* lane, i64 n, const Proj<E>& p) {
  store_elem(lane, 0, n, p.x);
  store_elem(lane, 1, n, p.y);
  store_elem(lane, 2, n, p.z);
}

// A row of W words (16-byte aligned) with 16-byte loads and stores.
template <int W>
__device__ __forceinline__ void load_row(int32_t (&w)[W], const int32_t* row) {
  const int4* src = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int i = 0; i < W / 4; i++) {
    int4 v = __ldg(src + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void store_row(int32_t* row, const int32_t (&w)[W]) {
  int4* dst = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int i = 0; i < W / 4; i++) {
    dst[i] = make_int4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// a projective point as a row of 16*C*3 words (store_proj at stride 1)
template <class E, int C>
__device__ __forceinline__ void store_point(int32_t* row, const Proj<E>& p) {
  int32_t w[16 * C * 3];
  store_proj(w, 1, p);
  store_row(row, w);
}

template <class E, int C>
__device__ __forceinline__ Proj<E> load_point(const int32_t* row) {
  int32_t w[16 * C * 3];
  load_row(w, row);
  return load_proj<E>(w, 1);
}

__device__ __forceinline__ void set_identity(Proj<FqE>& p) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p.x.v[i] = 0;
    p.y.v[i] = kFqOne[i];
    p.z.v[i] = 0;
  }
}
__device__ __forceinline__ void set_identity(Proj<Fq2E>& p) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p.x.c0.v[i] = p.x.c1.v[i] = 0;
    p.y.c0.v[i] = kFqOne[i];
    p.y.c1.v[i] = 0;
    p.z.c0.v[i] = p.z.c1.v[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// RCB15 complete formulas, a = 0 (Renes-Costello-Batina 2015, Alg 7/8/9);
// the same operation sequence as zerokit_tpu/ff/pallas_field.py.
// ---------------------------------------------------------------------------

template <class E>
__device__ __forceinline__ Proj<E> rcb_add(const Proj<E>& p, const Proj<E>& q) {
  E t0 = mul(p.x, q.x);
  E t1 = mul(p.y, q.y);
  E t2 = mul(p.z, q.z);
  E t3 = sub(mul(add(p.x, p.y), add(q.x, q.y)), add(t0, t1));
  E t4 = sub(mul(add(p.y, p.z), add(q.y, q.z)), add(t1, t2));
  E ty = sub(mul(add(p.x, p.z), add(q.x, q.z)), add(t0, t2));
  t0 = add(add(t0, t0), t0);
  t2 = b3_mul(t2);
  E z3 = add(t1, t2);
  t1 = sub(t1, t2);
  ty = b3_mul(ty);
  Proj<E> r;
  r.x = sub(mul(t3, t1), mul(t4, ty));
  r.y = add(mul(t1, z3), mul(ty, t0));
  r.z = add(mul(z3, t4), mul(t0, t3));
  return r;
}

// p + q with q affine; q = (0, 0) is the point at infinity and returns p.
// q is a loaded, canonical input (invariant 3).
template <class E>
__device__ __forceinline__ Proj<E> rcb_add_mixed(const Proj<E>& p, const Aff<E>& q) {
  if (is_zero(q.x) && is_zero(q.y)) return p;
  E t0 = mul(p.x, q.x);
  E t1 = mul(p.y, q.y);
  E t3 = sub(mul(add(p.x, p.y), add(q.x, q.y)), add(t0, t1));
  E t4 = add(mul(q.x, p.z), p.x);
  E t5 = add(mul(q.y, p.z), p.y);
  t0 = add(add(t0, t0), t0);
  E t2 = b3_mul(p.z);
  E z3 = add(t1, t2);
  t1 = sub(t1, t2);
  E ty = b3_mul(t4);
  Proj<E> r;
  r.x = sub(mul(t3, t1), mul(t5, ty));
  r.y = add(mul(t1, z3), mul(ty, t0));
  r.z = add(mul(z3, t5), mul(t0, t3));
  return r;
}

template <class E>
__device__ __forceinline__ Proj<E> rcb_double(const Proj<E>& p) {
  E t0 = sqr(p.y);
  E z3 = add(t0, t0);
  z3 = add(z3, z3);
  z3 = add(z3, z3);
  E t1 = mul(p.y, p.z);
  E t2 = b3_mul(sqr(p.z));
  E x3 = mul(t2, z3);
  E y3 = add(t0, t2);
  z3 = mul(t1, z3);
  t1 = add(t2, t2);
  t2 = add(t1, t2);
  t0 = sub(t0, t2);
  y3 = add(mul(t0, y3), x3);
  t1 = mul(p.x, p.y);
  x3 = mul(t0, t1);
  x3 = add(x3, x3);
  return {x3, y3, z3};
}

}  // namespace zk
