// K6: Fq Montgomery product with the reduction's two constant multiplies
// on the tensor cores.
//
// Replaces tools/mxu_mont_prototype.py run_mxu_mul with _mxu_mul_kernel,
// which asks whether the TPU's matrix unit can take the reduction's
// multiplies by constants: m = (t mod 2^256) * n' mod 2^256 and m * q,
// each a product of the operand's 32 bytes against a byte Toeplitz table
// of the constant (T[i][k] = byte k-i of the constant; bytes(x) @ T gives
// the byte columns of x * c). Here the tables (n': 32 x 32, q: 32 x 64,
// unsigned bytes, built on the host exactly as _toeplitz_bytes builds them)
// go through mma.sync m16n8k32 u8 x u8 -> s32: every column sum is at most
// 32 * 255^2 < 2^21, so the s32 accumulators are exact.
//
// One warp takes 32 lanes (two m16 tiles). Each thread computes its lane's
// full 512-bit product t = a * b on the CUDA cores (64 32x32->64 products,
// the counterpart of _mul_cols_rows on the VPU) and writes t's low 32
// bytes as a row of the warp's A tile in shared memory. An accumulator
// fragment spreads one lane's columns over the four threads of a quad, so
// the products' column sums go through shared memory too; the lane's own
// thread folds them: the n' columns into m mod 2^256 (its bytes are the A
// tile of the second product), the q columns into t + m * q, whose top half
// is below 2q and takes one conditional subtraction.
//
// What bounds it: device memory, 192 bytes a lane (a, b and the result as
// 16-bit limbs in int32 words) against 128 CUDA-core multiply instructions
// and 6144 tensor-core operations a lane; after memory come the product on
// the CUDA cores and the shared-memory round trips, not the tensor cores.
// It is the simple form: mma.sync, no wgmma, no TMA. The result is the
// canonical a * b / 2^256 mod q, the same integers as K1.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOpStride = 12;   // words per A row (8 used): conflict-free fragment loads
constexpr int kColStride = 65;  // words per column row (64 used): conflict-free row reads

// d += a (16 x 32 u8, row) * b (32 x 8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_u8(int d[4], const u32 a[4], const u32 b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of n-tile nt of a (32, cols) row-major byte table: this
// thread's four consecutive k at rows 4*(lane%4) (+16), column 8*nt + lane/4.
__device__ __forceinline__ void load_b_frag(u32 b[2], const uint8_t* table, int cols, int nt,
                                            int lane) {
  int col = 8 * nt + lane / 4;
  int k0 = 4 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; h++) {
    u32 w = 0;
#pragma unroll
    for (int e = 0; e < 4; e++) w |= (u32)table[(k0 + 16 * h + e) * cols + col] << (8 * e);
    b[h] = w;
  }
}

// cols[row][n] = sum_k op[row][k] * T[k][n] for the warp's 32 rows and the
// table's 8 * NT columns. op: 32 rows of kOpStride words (32 bytes used).
template <int NT>
__device__ __forceinline__ void tile_product(const u32* op, const u32 bfrag[NT][2], int* cols,
                                             int lane) {
  int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; mt++) {
    const u32* r0 = op + (16 * mt + g) * kOpStride;
    const u32* r1 = r0 + 8 * kOpStride;
    u32 a[4] = {r0[tig], r1[tig], r0[4 + tig], r1[4 + tig]};
#pragma unroll
    for (int nt = 0; nt < NT; nt++) {
      int d[4] = {0, 0, 0, 0};
      mma_u8(d, a, bfrag[nt]);
      int* c0 = cols + (16 * mt + g) * kColStride + 8 * nt + 2 * tig;
      int* c1 = c0 + 8 * kColStride;
      c0[0] = d[0];
      c0[1] = d[1];
      c1[0] = d[2];
      c1[1] = d[3];
    }
  }
}

// a, b, out: (16, n) int32 16-bit limbs, Montgomery form, < q.
// t_ninv: (32, 32) and t_q: (32, 64) uint8 Toeplitz tables.
__global__ void __launch_bounds__(kThreads)
    mont_tc_kernel(const int32_t* a, const int32_t* b, const uint8_t* t_ninv,
                   const uint8_t* t_q, int32_t* out, i64 n) {
  __shared__ u32 op_s[kWarps][32 * kOpStride];
  __shared__ int col_s[kWarps][32 * kColStride];
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  u32* op = op_s[warp];
  int* cols = col_s[warp];
  i64 i = ((i64)blockIdx.x * kWarps + warp) * 32 + lane;
  bool live = i < n;  // every thread of the warp stays for mma.sync

  u32 bn[4][2], bq[8][2];
#pragma unroll
  for (int nt = 0; nt < 4; nt++) load_b_frag(bn[nt], t_ninv, 32, nt, lane);
#pragma unroll
  for (int nt = 0; nt < 8; nt++) load_b_frag(bq[nt], t_q, 64, nt, lane);

  // t = a * b, 16 little-endian words, on the CUDA cores
  u32 x[8], y[8], t[16];
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = y[k] = 0;
  if (live) {
    load8(x, a + i, n);
    load8(y, b + i, n);
  }
#pragma unroll
  for (int k = 0; k < 16; k++) t[k] = 0;
#pragma unroll
  for (int r = 0; r < 8; r++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)x[j] * y[r] + t[r + j];
      t[r + j] = (u32)c;
      c >>= 32;
    }
    t[r + 8] = (u32)c;
  }

  // m = (t mod 2^256) * n' mod 2^256
#pragma unroll
  for (int k = 0; k < 8; k++) op[lane * kOpStride + k] = t[k];
  __syncwarp();
  tile_product<4>(op, bn, cols, lane);
  __syncwarp();
  u32 m[8];
  {
    u32 carry = 0;
    const int* c = cols + lane * kColStride;
#pragma unroll
    for (int w = 0; w < 8; w++) {
      u32 word = 0;
#pragma unroll
      for (int e = 0; e < 4; e++) {
        u32 v = (u32)c[4 * w + e] + carry;  // < 2^21 + 2^14
        word |= (v & 0xffu) << (8 * e);
        carry = v >> 8;
      }
      m[w] = word;
    }
  }
  __syncwarp();

  // u = t + m * q; u mod 2^256 = 0 and u / 2^256 < 2q
#pragma unroll
  for (int k = 0; k < 8; k++) op[lane * kOpStride + k] = m[k];
  __syncwarp();
  tile_product<8>(op, bq, cols, lane);
  __syncwarp();
  FqE r;
  {
    const int* c = cols + lane * kColStride;
    u64 acc = 0;
#pragma unroll
    for (int w = 0; w < 16; w++) {
      acc += (u64)t[w] + (u64)(u32)c[4 * w] + ((u64)(u32)c[4 * w + 1] << 8) +
             ((u64)(u32)c[4 * w + 2] << 16) + ((u64)(u32)c[4 * w + 3] << 24);
      if (w >= 8) r.v[w - 8] = (u32)acc;
      acc >>= 32;
    }
  }
  if (live) store8(out + i, n, r);  // r < 2q; store8 makes it canonical
}

}  // namespace

extern "C" {

int zk_mont_mul_tc(const void* a, const void* b, const void* t_ninv, const void* t_q, void* out,
                   long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  i64 per_block = 32 * kWarps;
  dim3 grid((unsigned)((n + per_block - 1) / per_block));
  mont_tc_kernel<<<grid, kThreads, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                           (const uint8_t*)t_ninv, (const uint8_t*)t_q,
                                           (int32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
