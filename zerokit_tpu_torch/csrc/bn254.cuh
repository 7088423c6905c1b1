// BN254 Fr / Fq / Fq2 Montgomery arithmetic and the RCB15 group laws as
// __device__ templates, shared by field_kernels.cu and ntt_kernels.cu.
//
// Counterpart of the row-list arithmetic inside the TPU kernels
// (zerokit_tpu/ff/pallas_field.py RowField, RowFqAdapter, RowFq2Adapter,
// rcb_add / rcb_add_mixed / rcb_double). A field element lives in registers
// as 8 little-endian 32-bit limbs; the tensors in device memory keep the
// package layout of 16-bit limbs in int32 words, and load8/store8 repack.
// Montgomery radix R = 2^256 in both forms, so the integers are the same.
//
// Every operation returns the canonical representative (< p): the multiply
// is CIOS Montgomery with 32x32->64 products and one final conditional
// subtraction; Fq2 multiplies are Karatsuba with three reductions. Results
// are therefore bit-identical to the plain PyTorch versions.

#pragma once

#include <cstdint>

namespace zk {

typedef uint32_t u32;
typedef uint64_t u64;
typedef long long i64;

static __constant__ u32 kFrP[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                                   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ u32 kFqP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
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
};
struct FqTag {
  static constexpr u32 NINV0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ static __forceinline__ u32 p(int i) { return kFqP[i]; }
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
// Device memory <-> registers. A field element's 16-bit limb i sits at
// base[i * stride]; 32-bit limb k packs limbs 2k and 2k+1.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(u32 v[8], const int32_t* base, i64 stride) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    v[k] = (u32)base[(2 * k) * stride] | ((u32)base[(2 * k + 1) * stride] << 16);
  }
}

__device__ __forceinline__ void store8(int32_t* base, i64 stride, const u32 v[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    base[(2 * k) * stride] = (int32_t)(v[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(v[k] >> 16);
  }
}

// ---------------------------------------------------------------------------
// Prime-field arithmetic (inputs canonical, outputs canonical)
// ---------------------------------------------------------------------------

template <class F>
__device__ __forceinline__ Elem<F> zero_elem() {
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

// x - p if x >= p (x < 2p < 2^255, so no carry bit above limb 7)
template <class F>
__device__ __forceinline__ Elem<F> reduce_once(const Elem<F>& x) {
  Elem<F> d;
  i64 br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    i64 s = (i64)x.v[i] - (i64)F::p(i) + br;
    d.v[i] = (u32)s;
    br = s >> 32;  // 0 or -1
  }
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = br < 0 ? x.v[i] : d.v[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem<F> add(const Elem<F>& a, const Elem<F>& b) {
  Elem<F> t;
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)a.v[i] + b.v[i];
    t.v[i] = (u32)c;
    c >>= 32;
  }
  return reduce_once(t);
}

template <class F>
__device__ __forceinline__ Elem<F> sub(const Elem<F>& a, const Elem<F>& b) {
  Elem<F> d, e;
  i64 br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    i64 s = (i64)a.v[i] - (i64)b.v[i] + br;
    d.v[i] = (u32)s;
    br = s >> 32;
  }
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)d.v[i] + F::p(i);
    e.v[i] = (u32)c;
    c >>= 32;
  }
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = br < 0 ? e.v[i] : d.v[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem<F> neg(const Elem<F>& a) {
  return sub(zero_elem<F>(), a);
}

// CIOS Montgomery product a*b/2^256 mod p. With a, b < p and 4p < 2^256 the
// loop ends below 2p; one conditional subtraction makes it canonical.
// Kept out of line: inlined into the G2 kernels (dozens of products each)
// it made nvcc 12.8 crash (segfault after 34 s on the H100 host); out of
// line the whole library builds in 22 s.
template <class F>
__device__ __noinline__ Elem<F> mul(const Elem<F>& a, const Elem<F>& b) {
  u32 t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a.v[j] * b.v[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (u32)c;
    t[9] = (u32)(c >> 32);
    u32 m = t[0] * F::NINV0;
    c = ((u64)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (u64)m * F::p(j) + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (u32)c;
    t[8] = t[9] + (u32)(c >> 32);
  }
  Elem<F> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return reduce_once(r);
}

template <class F>
__device__ __forceinline__ Elem<F> sqr(const Elem<F>& a) {
  return mul(a, a);
}

template <class F>
__device__ __forceinline__ bool is_zero(const Elem<F>& a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fq2E add(const Fq2E& a, const Fq2E& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2E sub(const Fq2E& a, const Fq2E& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2E mul(const Fq2E& a, const Fq2E& b) {
  FqE t0 = mul(a.c0, b.c0);
  FqE t1 = mul(a.c1, b.c1);
  FqE t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}
__device__ __forceinline__ Fq2E sqr(const Fq2E& a) {
  FqE c0 = mul(add(a.c0, a.c1), sub(a.c0, a.c1));
  FqE t = mul(a.c0, a.c1);
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
// one lane: word (i*C + m)*coords + c at offset word * n.
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
  store8(lane + c * n, 3 * n, e.v);
}
__device__ __forceinline__ void store_elem(int32_t* lane, int c, i64 n, const Fq2E& e) {
  store8(lane + c * n, 6 * n, e.c0.v);
  store8(lane + (3 + c) * n, 6 * n, e.c1.v);
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
