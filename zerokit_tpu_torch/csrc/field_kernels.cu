// K1-K3: Montgomery multiply, EC group laws and EC prefix scans on Hopper.
//
// K1 mont_mul<Field> replaces zerokit_tpu/ff/pallas_field.py
//    _run_elem_kernel with _make_mul_kernel (fr_mul / fq_mul).
// K2 ec_op<Curve,Op> replaces the same _run_elem_kernel with
//    _make_ec_kernel (g1/g2 x add, add_mixed, double).
// K3 ec_scan<Curve,Kind> replaces _run_scan_kernel_impl with
//    _make_scan_kernel (g1/g2 x mixed, excl).
//
// What bounds them: integer multiply throughput. One 256-bit CIOS product
// is 128 32x32->64 multiply-adds; an RCB15 add is 12 of them for G1 and
// 36 for G2, against 96-288 bytes of device traffic per lane, far above
// the H100's byte/op balance. The design is one thread per lane with the
// whole formula in registers, reading the coalesced (16, ..., N) limb rows
// (neighbouring threads, neighbouring words); G2 needs ~100 live words plus
// temporaries, so spills to local memory are accepted for now. K3 carries
// the running point in registers and loops over k inside the thread; that
// loop takes the place of the TPU's sequential grid axis and VMEM carry.
// The coarse scan (k = n/32 steps over ~1k lanes) fills few SMs: correct,
// slow, left for later work.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kEltThreads = 256;
constexpr int kEcThreads = 128;

template <class F>
__global__ void __launch_bounds__(kEltThreads)
    mont_mul_kernel(const int32_t* a, const int32_t* b, int32_t* out, i64 n) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elem<F> x, y;
  load8(x.v, a + i, n);
  load8(y.v, b + i, n);
  Elem<F> r = mul(x, y);
  store8(out + i, n, r.v);
}

// Op: 0 add (q projective), 1 add_mixed (q affine), 2 double (q unused)
template <class E, int Op>
__global__ void __launch_bounds__(kEcThreads)
    ec_op_kernel(const int32_t* p, const int32_t* q, int32_t* out, i64 n) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<E> a = load_proj<E>(p + i, n);
  Proj<E> r;
  if constexpr (Op == 0) {
    r = rcb_add(a, load_proj<E>(q + i, n));
  } else if constexpr (Op == 1) {
    r = rcb_add_mixed(a, load_aff<E>(q + i, n));
  } else {
    r = rcb_double(a);
  }
  store_proj(out + i, n, r);
}

// Kind: 0 inclusive prefixes of affine rows (from the identity),
//       1 exclusive prefixes of projective rows (the carry is stored before
//         the add).
template <class E, int C, int Kind>
__global__ void __launch_bounds__(kEcThreads)
    ec_scan_kernel(const int32_t* x, int32_t* out, i64 k, i64 n) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int in_rows = 16 * C * (Kind == 0 ? 2 : 3);
  constexpr int out_rows = 16 * C * 3;
  Proj<E> acc;
  set_identity(acc);
#pragma unroll 1
  for (i64 j = 0; j < k; j++) {
    const int32_t* xj = x + j * in_rows * n + i;
    int32_t* oj = out + j * out_rows * n + i;
    if constexpr (Kind == 0) {
      acc = rcb_add_mixed(acc, load_aff<E>(xj, n));
      store_proj(oj, n, acc);
    } else {
      store_proj(oj, n, acc);
      acc = rcb_add(acc, load_proj<E>(xj, n));
    }
  }
}

inline unsigned blocks_for(i64 n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class E>
int launch_ec_op(int op, const int32_t* p, const int32_t* q, int32_t* out, i64 n, cudaStream_t s) {
  dim3 grid(blocks_for(n, kEcThreads));
  switch (op) {
    case 0: ec_op_kernel<E, 0><<<grid, kEcThreads, 0, s>>>(p, q, out, n); break;
    case 1: ec_op_kernel<E, 1><<<grid, kEcThreads, 0, s>>>(p, q, out, n); break;
    case 2: ec_op_kernel<E, 2><<<grid, kEcThreads, 0, s>>>(p, q, out, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class E, int C>
int launch_ec_scan(int kind, const int32_t* x, int32_t* out, i64 k, i64 n, cudaStream_t s) {
  dim3 grid(blocks_for(n, kEcThreads));
  switch (kind) {
    case 0: ec_scan_kernel<E, C, 0><<<grid, kEcThreads, 0, s>>>(x, out, k, n); break;
    case 1: ec_scan_kernel<E, C, 1><<<grid, kEcThreads, 0, s>>>(x, out, k, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// field: 0 Fr, 1 Fq. a, b, out: (16, n) int32 16-bit limbs.
int zk_mont_mul(int field, const void* a, const void* b, void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(blocks_for(n, kEltThreads));
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  if (field == 0) {
    mont_mul_kernel<FrTag><<<grid, kEltThreads, 0, s>>>(pa, pb, po, n);
  } else if (field == 1) {
    mont_mul_kernel<FqTag><<<grid, kEltThreads, 0, s>>>(pa, pb, po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g2: 0 G1, 1 G2. op: 0 add, 1 add_mixed, 2 double. p, out: (16, C, 3, n);
// q: (16, C, 3 or 2, n).
int zk_ec_op(int g2, int op, const void* p, const void* q, void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pp = (const int32_t*)p;
  const int32_t* pq = (const int32_t*)q;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_ec_op<FqE>(op, pp, pq, po, n, s);
  if (g2 == 1) return launch_ec_op<Fq2E>(op, pp, pq, po, n, s);
  return (int)cudaErrorInvalidValue;
}

// kind: 0 mixed, 1 excl. x: (k, 16*C*coords, n); out: (k, 16*C*3, n).
int zk_ec_scan(int g2, int kind, const void* x, void* out, long long k, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* px = (const int32_t*)x;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_ec_scan<FqE, 1>(kind, px, po, k, n, s);
  if (g2 == 1) return launch_ec_scan<Fq2E, 2>(kind, px, po, k, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* zk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
