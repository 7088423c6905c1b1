// K1-K2: Montgomery multiply and EC group laws on Hopper (K3, the EC
// prefix scans, is csrc/ec_scan.cu).
//
// K1 mont_mul<Field> replaces zerokit_tpu/ff/pallas_field.py
//    _run_elem_kernel with _make_mul_kernel (fr_mul / fq_mul).
// K2 ec_op<Curve,Op> replaces the same _run_elem_kernel with
//    _make_ec_kernel (g1/g2 x add, add_mixed, double). ec_add_gather<Curve>
//    is K2's add as the MSM pass's Q_d step calls it: per output lane it
//    reads fine row fidx[i] and coarse row cidx[i] (AoS projective rows of
//    16*C*3 words, 16-byte loads) itself, adds them, writes the identity
//    where empty[i], and stores the (16, C, 3, lanes) SoA the bucket sum
//    reads; no gathered copy and no transpose.
//
// What bounds them: integer multiply throughput. One 256-bit CIOS product
// is 128 32x32->64 multiply-adds; an RCB15 add is 12 of them for G1 and
// 42 for G2, against 96-288 bytes of device traffic per lane, far above
// the H100's byte/op balance. The design is one thread per lane with the
// whole formula in registers on the field core of bn254.cuh (PTX carry
// chains, every product inlined, lazy reduction to [0, 2p) with one
// canonicalisation at each store), reading the coalesced (16, ..., N) limb
// rows (neighbouring threads, neighbouring words). The block size is the
// wrapper's (chip_smoke.py sweeps 64/128/256); kMaxThreads bounds it, and
// at <= 256 threads the bound leaves ptxas its full 255 registers, so one
// build serves every swept size.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kEltThreads = 256;
constexpr int kMaxThreads = 256;

template <class F>
__global__ void __launch_bounds__(kEltThreads)
    mont_mul_kernel(const int32_t* a, const int32_t* b, int32_t* out, i64 n) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elem<F> x, y;
  load8(x.v, a + i, n);
  load8(y.v, b + i, n);
  store8(out + i, n, mul(x, y));
}

// Op: 0 add (q projective), 1 add_mixed (q affine), 2 double (q unused)
template <class E, int Op>
__global__ void __launch_bounds__(kMaxThreads)
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

template <class E, int C>
__global__ void __launch_bounds__(kMaxThreads)
    ec_add_gather_kernel(const int32_t* __restrict__ fine, const int32_t* __restrict__ fidx,
                         const int32_t* __restrict__ coarse, const int32_t* __restrict__ cidx,
                         const uint8_t* __restrict__ empty, int32_t* __restrict__ out, i64 n) {
  constexpr int kRow = 16 * C * 3;
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<E> r;
  if (__ldg(empty + i)) {
    set_identity(r);
  } else {
    Proj<E> a = load_point<E, C>(fine + (i64)__ldg(fidx + i) * kRow);
    r = rcb_add(a, load_point<E, C>(coarse + (i64)__ldg(cidx + i) * kRow));
  }
  store_proj(out + i, n, r);
}

inline unsigned blocks_for(i64 n, int threads) { return (unsigned)((n + threads - 1) / threads); }

inline bool bad_threads(int threads) { return threads < 32 || threads > kMaxThreads; }

template <class E>
int launch_ec_op(int op, const int32_t* p, const int32_t* q, int32_t* out, i64 n, int threads,
                 cudaStream_t s) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  dim3 grid(blocks_for(n, threads));
  switch (op) {
    case 0: ec_op_kernel<E, 0><<<grid, threads, 0, s>>>(p, q, out, n); break;
    case 1: ec_op_kernel<E, 1><<<grid, threads, 0, s>>>(p, q, out, n); break;
    case 2: ec_op_kernel<E, 2><<<grid, threads, 0, s>>>(p, q, out, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class E, int C>
int launch_add_gather(const int32_t* fine, const int32_t* fidx, const int32_t* coarse,
                      const int32_t* cidx, const uint8_t* empty, int32_t* out, i64 n, int threads,
                      cudaStream_t s) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  ec_add_gather_kernel<E, C><<<blocks_for(n, threads), threads, 0, s>>>(fine, fidx, coarse, cidx,
                                                                        empty, out, n);
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
// q: (16, C, 3 or 2, n). threads: per block, 32-256.
int zk_ec_op(int g2, int op, const void* p, const void* q, void* out, long long n, int threads,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pp = (const int32_t*)p;
  const int32_t* pq = (const int32_t*)q;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_ec_op<FqE>(op, pp, pq, po, n, threads, s);
  if (g2 == 1) return launch_ec_op<Fq2E>(op, pp, pq, po, n, threads, s);
  return (int)cudaErrorInvalidValue;
}

// g2: 0 G1, 1 G2. fine, coarse: rows of 16*C*3 words (16-byte aligned);
// fidx, cidx: int32 rows of them, empty: uint8 flags, all n lanes;
// out: (16, C, 3, n). threads: per block, 32-256.
int zk_ec_add_gather(int g2, const void* fine, const void* fidx, const void* coarse,
                     const void* cidx, const void* empty, void* out, long long n, int threads,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pf = (const int32_t*)fine;
  const int32_t* pfi = (const int32_t*)fidx;
  const int32_t* pc = (const int32_t*)coarse;
  const int32_t* pci = (const int32_t*)cidx;
  const uint8_t* pe = (const uint8_t*)empty;
  int32_t* po = (int32_t*)out;
  if (g2 == 0) return launch_add_gather<FqE, 1>(pf, pfi, pc, pci, pe, po, n, threads, s);
  if (g2 == 1) return launch_add_gather<Fq2E, 2>(pf, pfi, pc, pci, pe, po, n, threads, s);
  return (int)cudaErrorInvalidValue;
}

const char* zk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
