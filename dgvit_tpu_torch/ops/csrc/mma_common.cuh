// Tensor-core helpers of the bf16 kernels that run on the H100's tensor
// cores: K8's attention (attention.cu) and the full-block backward body
// shared by K2b and K6 (block_grad.cu).
//
// * `mma.sync.m16n8k16` on bf16 operands with fp32 accumulators: a
//   product of two bf16 values is exact in fp32, so a tile product
//   differs from an fp32 FMA loop over the same bf16 operands only in the
//   order of its sums.
// * `ldmatrix` (and `.trans`) to read A and B fragments from shared memory.
//   Tiles keep a row stride of (width + 8) bf16 values: 16 bytes past a
//   multiple of 128, so the eight rows of one 8x8 matrix fall on eight
//   different 16-byte bank groups.
// * `cp.async` (16 bytes, cache-global) with its commit and wait, to stage
//   operand tiles from device memory into shared memory.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows
// g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B columns g, rows
// 2t, 2t + 1 and 2t + 8, 2t + 9; the accumulator rows g and g + 8,
// columns 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// the same, or 16 zero bytes where `bytes` is 0 (src is not read then)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// max and sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragment (16 x 16) at (r0, k0) of a row-major [M][K] tile, row stride
// ld (elements)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, s + (size_t)(r0 + l % 16) * ld + k0 + (l / 16) * 8);
}
// A fragment at (r0, k0) of A = S^T, where the tile S is stored [K][M]
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(a, s + (size_t)(k0 + l % 8 + (l / 16) * 8) * ld + r0 +
                   (l / 8 % 2) * 8);
}
// B fragments of the two n8 tiles n0 and n0 + 8 at depth k0, from a tile
// stored [N][K] (b[0], b[1]: tile n0; b[2], b[3]: tile n0 + 8)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, s + (size_t)(n0 + l % 8 + (l / 16) * 8) * ld + k0 +
                 (l / 8 % 2) * 8);
}
// the same from a tile stored [K][N]
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(b, s + (size_t)(k0 + l % 8 + (l / 8 % 2) * 8) * ld + n0 +
                   (l / 16) * 8);
}

// acc[j] += A[r0 : r0 + 16, 0 : K] @ B[0 : K, n0 + 8 j : n0 + 8 j + 8] for
// j < NT (even), one warp. kAT: A is stored transposed ([K][M]); kBNK: B
// is stored [N][K] (else [K][N]). K is a multiple of 16.
template <int NT, bool kAT, bool kBNK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* A,
                                         int lda, int r0, const bf16* B,
                                         int ldb, int n0, int K) {
  static_assert(NT % 2 == 0, "n8 tiles go in pairs");
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    if (kAT)
      load_a_t(a, A, lda, r0, k0);
    else
      load_a(a, A, lda, r0, k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      if (kBNK)
        load_b_nk(b, B, ldb, n0 + 8 * j, k0);
      else
        load_b_kn(b, B, ldb, n0 + 8 * j, k0);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// C = A @ B (M x N, M and N multiples of 16) over the block's warps, in
// items of 16 rows x 16 columns; epi(r, c, v0, v1) gets columns c and
// c + 1 of row r (every r < M, padded rows included).
template <bool kAT, bool kBNK, typename Epi>
__device__ __forceinline__ void block_mma(int M, int N, int K, const bf16* A,
                                          int lda, const bf16* B, int ldb,
                                          Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = M / 16, items = mt * (N / 16);
  for (int it = warp; it < items; it += blockDim.x / 32) {
    const int r0 = it % mt * 16, n0 = it / mt * 16;
    float acc[2][4] = {};
    warp_mma<2, kAT, kBNK>(acc, A, lda, r0, B, ldb, n0, K);
    const int r = r0 + lane / 4, c = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      epi(r, c + 8 * j, acc[j][0], acc[j][1]);
      epi(r + 8, c + 8 * j, acc[j][2], acc[j][3]);
    }
  }
}

// rows x cols bf16 from device memory (row stride gld) into shared memory
// (row stride sld) with 16-byte cp.async; cols, both strides and both
// addresses are multiples of 8 elements. Commits nothing.
__device__ __forceinline__ void stage_rows(bf16* s, int sld, const bf16* g,
                                           size_t gld, int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i % per_row * 8;
    cp_async16(s + (size_t)r * sld + c, g + r * gld + c);
  }
}

// rows x cols bf16 from shared memory to device memory in 16-byte stores;
// the same alignment as stage_rows
__device__ __forceinline__ void store_rows(bf16* g, size_t gld, const bf16* s,
                                           int sld, int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i % per_row * 8;
    *reinterpret_cast<uint4*>(g + r * gld + c) =
        *reinterpret_cast<const uint4*>(s + (size_t)r * sld + c);
  }
}

// zero rows [r0, r1) of a bf16 tile of width `cols` (multiple of 8)
__device__ __forceinline__ void zero_rows(bf16* s, int sld, int r0, int r1,
                                          int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += blockDim.x) {
    const int r = r0 + i / per_row, c = i % per_row * 8;
    *reinterpret_cast<uint4*>(s + (size_t)r * sld + c) = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace
