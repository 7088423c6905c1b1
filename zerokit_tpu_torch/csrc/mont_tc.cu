// K6: Fq Montgomery product with the reduction's two constant multiplies
// on the tensor cores.
//
// Replaces tools/mxu_mont_prototype.py run_mxu_mul with _mxu_mul_kernel,
// which asks whether the TPU's matrix unit can take the reduction's
// multiplies by constants: m = (t mod 2^256) * n' mod 2^256 and m * q,
// each a product of the operand's 32 bytes against a byte Toeplitz table
// of the constant (T[i][k] = byte k-i of the constant; bytes(x) @ T gives
// the byte columns of x * c). Every column sum is at most 32 * 255^2 < 2^21,
// so u8 x u8 -> s32 tensor-core products are exact.
//
// What bounds it: device memory, 192 bytes a lane (a, b and the result as
// 16-bit limbs in int32 words) against 128 CUDA-core multiply instructions
// and 6144 tensor-core operations a lane. The design keeps the memory pipe
// busy and the rest off its path:
//   * A persistent grid: as many 128-thread blocks as fit on the SMs. Each
//     warp walks its own 32-lane tiles, with no block barrier inside the
//     loop; the next tile's a and b limbs stream into a second shared-memory
//     buffer with cp.async while the current tile computes.
//   * The tables are staged once per block, as 16-byte copies of an image
//     that the host lays out in 8-row x 16-byte core matrices
//     (tc_mont_prototype.smem_image), and each thread loads its mma.sync B
//     fragments from it once.
//   * Each thread computes one lane's 512-bit t = a * b on the CUDA cores
//     and writes t's low 32 bytes as the lane's row of the warp's A tile
//     (32 x 32 bytes); the products run as mma.sync m16n8k32 u8 x u8 -> s32.
//     The warpgroup form, wgmma m64nNk32 on a block's 128-lane tile, gave
//     the same integers and ran 5-8 % slower (PERF.md), so it is not kept.
//   * The fold from the accumulators: a row's columns lie on the 4 threads
//     of a quad, 2 adjacent columns per 8. Each thread turns its columns of
//     each of its 4 rows into an exact partial number (every word takes one
//     column pair's low or high half, so no carries), and the quad
//     reduce-scatters them: two rounds of shuffles and carry-chain adds
//     leave thread j of the quad with the whole sum of row j of its 4 rows.
//     That thread is the one that computed the row's t: it writes m's bytes
//     as the next A row, and adds t to m * q, whose top half is below 2q
//     and takes one conditional subtraction.
// The result is the canonical a * b / 2^256 mod q, the same integers as K1.

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // lanes a tile: one warp's
constexpr int kRowBytes = 32;  // K: the operand's bytes
constexpr int kImgN = 32 * kRowBytes;  // n' image bytes (N = 32)
constexpr int kImgQ = 64 * kRowBytes;  // q image bytes (N = 64)

// byte offset of (row, k) in an image of 8-row x 16-byte core matrices:
// the two K halves of an 8-row group adjacent, the groups 256 B apart;
// tc_mont_prototype.smem_image lays out the same
__device__ __forceinline__ int img_off(int row, int k) {
  return (row >> 3) * 256 + (k >> 4) * 128 + (row & 7) * 16 + (k & 15);
}

// ---------------------------------------------------------------------------
// The products: cols[a][2i + e] = column 8i + 2(lane % 4) + e of the
// thread's row a (a = 0..3) of the warp's A tile against an image of N
// columns
// ---------------------------------------------------------------------------

// the thread's 4 rows in its warp's tile (quad thread j keeps row j after
// the fold): m16 tile a / 2, upper half a % 2
__device__ __forceinline__ int tile_row(int a) {
  int g = (threadIdx.x & 31) >> 2;
  return g + 8 * (a & 1) + 16 * (a >> 1);
}

// d += a (16 x 32 u8, row) * b (32 x 8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the B fragment of n-tile nt: this thread's 4 k at 4*(lane%4) (+16) of
// column 8*nt + lane/4
__device__ __forceinline__ void b_frag(u32 (&b)[2], const uint8_t* img, int nt) {
  int lane = threadIdx.x & 31, col = 8 * nt + lane / 4, k = 4 * (lane & 3);
  b[0] = *reinterpret_cast<const u32*>(img + img_off(col, k));
  b[1] = *reinterpret_cast<const u32*>(img + img_off(col, k + 16));
}

template <int N>
__device__ __forceinline__ void tile_product(int (&cols)[4][N / 4], const uint8_t* a_tile,
                                             const u32 (&bfrag)[N / 8][2]) {
  int tig = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; mt++) {
    int r0 = tile_row(2 * mt), r1 = r0 + 8;
    u32 a[4] = {*reinterpret_cast<const u32*>(a_tile + img_off(r0, 4 * tig)),
                *reinterpret_cast<const u32*>(a_tile + img_off(r1, 4 * tig)),
                *reinterpret_cast<const u32*>(a_tile + img_off(r0, 16 + 4 * tig)),
                *reinterpret_cast<const u32*>(a_tile + img_off(r1, 16 + 4 * tig))};
#pragma unroll
    for (int nt = 0; nt < N / 8; nt++) {
      int d[4] = {0, 0, 0, 0};
      mma_u8(d, a, bfrag[nt]);
#pragma unroll
      for (int h = 0; h < 2; h++)
#pragma unroll
        for (int e = 0; e < 2; e++) cols[2 * mt + h][2 * nt + e] = d[2 * h + e];
    }
  }
}

// ---------------------------------------------------------------------------
// The fold
// ---------------------------------------------------------------------------

// r += b mod 2^512, one carry chain
__device__ __forceinline__ void add16(u32 (&r)[16], const u32 (&b)[16]) {
  asm("add.cc.u32 %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, %23;\n\t"
      "addc.cc.u32 %8, %8, %24;\n\t"
      "addc.cc.u32 %9, %9, %25;\n\t"
      "addc.cc.u32 %10, %10, %26;\n\t"
      "addc.cc.u32 %11, %11, %27;\n\t"
      "addc.cc.u32 %12, %12, %28;\n\t"
      "addc.cc.u32 %13, %13, %29;\n\t"
      "addc.cc.u32 %14, %14, %30;\n\t"
      "addc.u32 %15, %15, %31;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]), "+r"(r[11]), "+r"(r[12]), "+r"(r[13]),
        "+r"(r[14]), "+r"(r[15])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]), "r"(b[12]), "r"(b[13]), "r"(b[14]),
        "r"(b[15]));
}
__device__ __forceinline__ void add_words(u32 (&r)[8], const u32 (&b)[8]) { add8(r, b); }
__device__ __forceinline__ void add_words(u32 (&r)[16], const u32 (&b)[16]) { add16(r, b); }

// The row's column sums c (this thread's 2 columns of each 8: columns
// 8i + 2j + e, j = lane % 4) as an exact W-word number mod 2^(32W): the
// pair of chunk i lands at byte 8i + 2j, i.e. word 2i + j/2 at bit
// 16 (j % 2), below 2^46, its low word at word 2i + j/2 and its high word
// at the next, and no two pairs share a word.
template <int W>
__device__ __forceinline__ void partial(u32 (&p)[W], const int* c, int j) {
  int odd = j >> 1, sh = 16 * (j & 1);
#pragma unroll
  for (int w = 0; w < W; w++) p[w] = 0;
#pragma unroll
  for (int i = 0; i < W / 2; i++) {
    u64 v = ((u64)(u32)c[2 * i] << sh) + ((u64)(u32)c[2 * i + 1] << (sh + 8));
    u32 lo = (u32)v, hi = (u32)(v >> 32);
    // word 2i + odd takes lo, word 2i + odd + 1 takes hi (dropped past W)
    p[2 * i] = odd ? p[2 * i] : lo;
    p[2 * i + 1] = odd ? lo : hi;
    if (2 * i + 2 < W) p[2 * i + 2] = odd ? hi : p[2 * i + 2];
  }
}

// Reduce-scatter over the quad: thread j holds partials of its 4 rows and
// ends with the sum of row j, mod 2^(32W)
template <int W>
__device__ __forceinline__ void quad_fold(u32 (&out)[W], const u32 (&p)[4][W], int j) {
  u32 keep[2][W];
#pragma unroll
  for (int b = 0; b < 2; b++) {  // rows 2b, 2b + 1: keep row 2b + (j & 1)
    u32 give[W];
#pragma unroll
    for (int w = 0; w < W; w++) {
      keep[b][w] = (j & 1) ? p[2 * b + 1][w] : p[2 * b][w];
      give[w] = (j & 1) ? p[2 * b][w] : p[2 * b + 1][w];
      give[w] = __shfl_xor_sync(0xffffffffu, give[w], 1);
    }
    add_words(keep[b], give);
  }
  u32 give[W];
#pragma unroll
  for (int w = 0; w < W; w++) {  // rows 2b + (j & 1): keep b = j >> 1
    out[w] = (j & 2) ? keep[1][w] : keep[0][w];
    give[w] = (j & 2) ? keep[0][w] : keep[1][w];
    give[w] = __shfl_xor_sync(0xffffffffu, give[w], 2);
  }
  add_words(out, give);
}

template <int N>
__device__ __forceinline__ void fold(u32 (&out)[N / 4], const int (&cols)[4][N / 4], int j) {
  u32 p[4][N / 4];
#pragma unroll
  for (int a = 0; a < 4; a++) partial<N / 4>(p[a], cols[a], j);
  quad_fold<N / 4>(out, p, j);
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

// 16-byte (or, for a lane count that is not a multiple of 4, 4-byte) async
// copies of one tile's 16 limb rows of a and b by the warp's 32 threads;
// lanes past n read as 0
__device__ __forceinline__ void stage_tile(u32* dst, const int32_t* a, const int32_t* b, i64 n,
                                           i64 lane0, bool vec) {
  const int lane_id = threadIdx.x & 31;
  if (vec) {
    for (int i = lane_id; i < 2 * 16 * (kTile / 4); i += 32) {  // (array, limb, 4 lanes)
      int arr = i / (16 * kTile / 4), limb = (i / (kTile / 4)) % 16, q = i % (kTile / 4);
      i64 lane = lane0 + 4 * q;
      const int32_t* src = (arr ? b : a) + limb * n + lane;
      int bytes = lane >= n ? 0 : (n - lane >= 4 ? 16 : (int)(n - lane) * 4);
      if (bytes == 0) src = a;
      uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + (arr * 16 + limb) * kTile + 4 * q);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(bytes));
    }
  } else {
    for (int i = lane_id; i < 2 * 16 * kTile; i += 32) {
      int arr = i / (16 * kTile), limb = (i / kTile) % 16, q = i % kTile;
      i64 lane = lane0 + q;
      const int32_t* src = lane < n ? (arr ? b : a) + limb * n + lane : a;
      uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + (arr * 16 + limb) * kTile + q);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                   "r"(lane < n ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a, b, out: (16, n) int32 16-bit limbs, Montgomery form, < q. img_n, img_q:
// the n' and q Toeplitz tables as smem_image lays them out (1024 and 2048
// bytes).
__global__ void __launch_bounds__(kThreads)
    mont_tc_kernel(const int32_t* a, const int32_t* b, const uint8_t* img_n, const uint8_t* img_q,
                   int32_t* out, i64 n) {
  __shared__ __align__(128) uint8_t tab_n[kImgN];
  __shared__ __align__(128) uint8_t tab_q[kImgQ];
  __shared__ __align__(128) uint8_t a_tiles[kWarps][kTile * kRowBytes];
  __shared__ __align__(16) u32 stage[kWarps][2][2 * 16 * kTile];  // two tiles' a and b limbs
  const int t = threadIdx.x, j = t & 3, warp = t / 32;
  uint8_t* a_tile = a_tiles[warp];
  const i64 tiles = (n + kTile - 1) / kTile, step = (i64)gridDim.x * kWarps;
  const bool vec = (n & 3) == 0;

  i64 tile = (i64)blockIdx.x * kWarps + warp;
  if (tile < tiles) stage_tile(stage[warp][0], a, b, n, tile * kTile, vec);
  for (int i = t; i < (kImgN + kImgQ) / 16; i += kThreads) {
    const uint4* src = reinterpret_cast<const uint4*>(i < kImgN / 16 ? img_n : img_q);
    uint4* dst = reinterpret_cast<uint4*>(i < kImgN / 16 ? tab_n : tab_q);
    int k = i < kImgN / 16 ? i : i - kImgN / 16;
    dst[k] = src[k];
  }
  __syncthreads();
  u32 bn[4][2], bq[8][2];  // the B fragments, once per block
#pragma unroll
  for (int nt = 0; nt < 4; nt++) b_frag(bn[nt], tab_n, nt);
#pragma unroll
  for (int nt = 0; nt < 8; nt++) b_frag(bq[nt], tab_q, nt);
  const int row = tile_row(j);  // this thread's lane in every tile

  for (int it = 0; tile < tiles; tile += step, it++) {
    const u32* cur = stage[warp][it & 1];
    i64 next = tile + step;
    if (next < tiles) stage_tile(stage[warp][(it + 1) & 1], a, b, n, next * kTile, vec);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();

    // t = a * b, 16 little-endian words, on the CUDA cores
    u32 x[8], y[8], tw[16];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      x[k] = cur[(2 * k) * kTile + row] | (cur[(2 * k + 1) * kTile + row] << 16);
      y[k] = cur[(16 + 2 * k) * kTile + row] | (cur[(16 + 2 * k + 1) * kTile + row] << 16);
    }
#pragma unroll
    for (int k = 0; k < 16; k++) tw[k] = 0;
#pragma unroll
    for (int r = 0; r < 8; r++) {
      u64 c = 0;
#pragma unroll
      for (int i = 0; i < 8; i++) {
        c += (u64)x[i] * y[r] + tw[r + i];
        tw[r + i] = (u32)c;
        c >>= 32;
      }
      tw[r + 8] = (u32)c;
    }

    // m = (t mod 2^256) * n' mod 2^256
    uint4* arow0 = reinterpret_cast<uint4*>(a_tile + img_off(row, 0));
    uint4* arow1 = reinterpret_cast<uint4*>(a_tile + img_off(row, 16));
    *arow0 = make_uint4(tw[0], tw[1], tw[2], tw[3]);
    *arow1 = make_uint4(tw[4], tw[5], tw[6], tw[7]);
    __syncwarp();
    u32 m[8];
    {
      int cols[4][8];
      tile_product<32>(cols, a_tile, bn);
      fold<32>(m, cols, j);
    }
    __syncwarp();  // every read of the A tile done

    // u = t + m * q; u mod 2^256 = 0 and u / 2^256 < 2q
    *arow0 = make_uint4(m[0], m[1], m[2], m[3]);
    *arow1 = make_uint4(m[4], m[5], m[6], m[7]);
    __syncwarp();
    u32 u[16];
    {
      int cols[4][16];
      tile_product<64>(cols, a_tile, bq);
      fold<64>(u, cols, j);
    }
    add_words(u, tw);
    FqE res;
#pragma unroll
    for (int k = 0; k < 8; k++) res.v[k] = u[8 + k];
    i64 lane = tile * kTile + row;
    if (lane < n) store8(out + lane, n, res);  // res < 2q; store8 makes it canonical
    __syncwarp();  // the buffers are free for the next tile's copies
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mont_tc_kernel, kThreads, 0);
}

}  // namespace

extern "C" {

// a, b, img_n, img_q 16-byte aligned; the images as
// tc_mont_prototype.smem_image lays them out
int zk_mont_mul_tc(const void* a, const void* b, const void* img_n, const void* img_q, void* out,
                   long long n, void* stream) {
  static int grid_max = 0;  // blocks per SM x SMs, read once
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)img_n | (uintptr_t)img_q) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (grid_max == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (int e = blocks_per_sm(&per_sm)) return e;
    grid_max = per_sm * sms;
  }
  i64 blocks = (n + kWarps * kTile - 1) / (kWarps * kTile);
  unsigned grid = (unsigned)(blocks < grid_max ? blocks : grid_max);
  mont_tc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const uint8_t*)img_n, (const uint8_t*)img_q,
      (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// blocks per SM of the kernel (the persistent grid is this x the SMs)
int zk_mont_mul_tc_occupancy(int* blocks) { return blocks_per_sm(blocks); }

}  // extern "C"
