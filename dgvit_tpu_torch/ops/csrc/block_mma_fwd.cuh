// The bf16 pre-norm block forward on the H100's tensor cores: the body of
// K2f and K3f (block_grad.cu: block_fwd_mma_kernel, cls_fwd_mma_kernel)
// and of K4's and K1's blocks (got_megakernel.cu: trunk_mma_kernel,
// k1_mma_kernel, k1_cluster_kernel) at the flagship widths; K7's
// tensor-core form (attention.cu: attn_section_mma_kernel) runs its
// attention parts (project, attend_head, frag_mma) in a head loop of its
// own.
//
// It computes what `block<bf16>` (block_common.cuh) computes, with the TPU
// body's rounding points (dgvit_tpu/ops/fused_transformer.py
// `_block_body`): LayerNorm statistics in fp32; q, k, v rounded to bf16;
// scores and softmax in fp32, the probabilities rounded to bf16 before
// P.V; o rounded to bf16; the out-projection and its bias added to the
// fp32 stream; tanh GELU in fp32, the hidden values rounded to bf16; the
// MLP sum in fp32. A product on the tensor cores is a bf16
// `mma.sync.m16n8k16` on operands already rounded to bf16, into fp32
// accumulators (mma_common.cuh): it differs from an fp32 FMA loop only in
// the order and the truncation of its sums. Each such chain is at most 80
// deep: the out-projection is summed head by head and the MLP output
// chunk by chunk of 64 hidden columns, each from a zero accumulator, the
// partial sums added in fp32.
//
// Two forms (template flag kFma):
//  * kFma false: every product on the tensor cores, K2f's and K3f's
//    (block_grad.cu) and K1's (got_megakernel.cu). The products take block_bwd_mma's tile
//    order (block_grad.cu) and the LayerNorms layernorm_tile's order.
//  * kFma true, K4's form: the qkv projection, the MLP's first product and
//    P.V on the tensor cores; the scores, the out-projection and the MLP's
//    second product as fp32 fma chains in `block<T>`'s order (the scores
//    and their softmax sum as `attend` takes them; the out-projection one
//    chain over every head; the MLP output in chains of the FMA body's
//    chunk, added to b2 in turn). It was chosen when chip_smoke.py held
//    K4's latent to its plain version under a limit below the spread of
//    exact sums; held to float64 sums since (EXACT_K there), the form
//    with every product on the tensor cores passes as well (PERF.md).
//
// Widths: d = dim_head = 64, n <= 80 rows a frame, mlp a multiple of 64,
// x and the matrix weights 16-byte aligned (the wrappers pick this body
// there: tensor_core_fwd in ops/fused_transformer.py; the launches check
// it). Other widths and fp32 keep `block<T>`.
//
// Layout: a thread block holds kFrames = 2 frames, and each warp owns 16
// rows of one frame (65 rows: 5 warps a frame, 10 a block). A warp keeps
// its rows' fp32 stream, its normed rows (as mma A fragments), its q, its
// o and its MLP output in registers from the block's first product to
// its last (K4: q and o pass through the frame's q tile, the hidden
// values through the warp's fp32 tile, each w2 chunk through one fp32
// tile converted once a block). Shared memory holds what warps
// share: each frame's k and v of the current head, and the weight tiles,
// which cp.async brings in once a block for both frames (the next head's
// wqkv and wout slices while this head runs; the MLP's w1 and w2 chunks in
// a three-stage ring). 142,080 bytes at 65 rows: one thread block of 320
// threads an SM (168 registers), so a batch of 256 frames is 128 blocks,
// one wave on 132 SMs.

#pragma once

#include "block_common.cuh"
#include "mma_common.cuh"

namespace {
namespace mmafwd {

constexpr int D = 64;          // token width and head width
constexpr int HC = 64;         // MLP hidden columns a chunk
constexpr int kMaxRows = 80;   // most rows of a frame
constexpr int kKeyTiles = kMaxRows / 8;
constexpr int kFrames = 2;     // frames a thread block
constexpr int kMaxThreads = 32 * kFrames * kMaxRows / 16;
constexpr int kStages = 3;     // w1/w2 chunks in flight
constexpr int kLd = D + 8;     // row stride of 64-wide bf16 tiles
constexpr int kLdQkv = 3 * D + 8;
constexpr int kLdHid = HC + 4;  // row stride of a warp's fp32 hidden tile
// fp32 w2 chunk for the fp32 sums: thread column group t (= lane % 4)
// holds columns 8 j + 2 t + e (j < 8, e < 2) at kSkew t + 2 j + e, so a
// thread reads its 16 columns as four 16-byte loads, the four groups on
// distinct banks
constexpr int kSkew = 20, kLdW2 = 4 * kSkew;

// warps of a thread block: one for each 16 rows of each frame
__host__ __device__ inline int warps(int n) {
  return kFrames * (round16(n) / 16);
}

// the offset of `bytes` at o, and o moved past them (16-byte aligned)
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = align16(o + bytes);
  return at;
}

// Shared memory for n rows a frame: the attention's tiles, and over them
// the MLP's ring and each warp's hidden tile (K4's fp32 sums); then three
// small tiles of the CLS-only block (K4).
struct Layout {
  size_t k, v, q, wqkv, wout, ring, hid, w2f, cls_h, cls_x1, cls_y, total;
  __host__ __device__ explicit Layout(int n) {
    const size_t np = round16(n),
                 tile = sizeof(bf16) * kFrames * np * kLd,
                 wq = sizeof(bf16) * D * kLdQkv,
                 w64 = sizeof(bf16) * D * kLd;
    size_t o = 0;
    k = take(o, tile);          // every frame's k of one head
    v = take(o, tile);
    q = take(o, tile);          // K4: q, then o, of the head
    wqkv = take(o, 2 * wq);     // two heads' slices
    wout = take(o, 2 * w64);
    const size_t attn = o;
    o = 0;
    ring = take(o, kStages * 2 * w64);  // w1 and w2 chunks
    hid = take(o, sizeof(float) * warps(n) * 16 * kLdHid);
    w2f = take(o, sizeof(float) * HC * kLdW2);
    o = o > attn ? o : attn;
    cls_h = take(o, sizeof(bf16) * 16 * kLd);  // LN2 of the CLS rows
    cls_x1 = take(o, sizeof(float) * kFrames * D);
    cls_y = take(o, sizeof(float) * kFrames * D);
    total = o;
  }
};

// The warp's place: frame fl of the thread block (global frame f, live if
// f < batch) and its first row r0 in that frame.
struct Place {
  int fl, f, r0, np;
  bool live;
  __device__ Place(int n, int batch) {
    const int warp = threadIdx.x / 32, mt = round16(n) / 16;
    fl = warp / mt;
    f = blockIdx.x * kFrames + fl;
    r0 = warp % mt * 16;
    np = round16(n);
    live = f < batch;
  }
};

// Rows of the warp in the accumulator layout of 8 n8 tiles: x[j][e] is
// row r0 + g + 8 (e / 2), column 8 j + 2 t + e % 2 (g = lane / 4,
// t = lane % 4).
using Rows = float[8][4];
// A fragments of the warp's 16 x 64 bf16 rows, one per k-step of 16.
using Frag = uint32_t[4][4];

__device__ __forceinline__ int row_of(int r0, int e) {
  return r0 + threadIdx.x % 32 / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int col_of(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + e % 2;
}

// x (frame base, n rows of D, bf16) into fp32 rows; rows >= n, and every
// row of a frame that does not exist, are zero
__device__ __forceinline__ void read_rows(Rows& x, const bf16* frame,
                                          const Place& p, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_of(p.r0, 2 * h), c = col_of(j, 2 * h);
      float2 v = make_float2(0.f, 0.f);
      if (p.live && r < n)
        v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(frame + r * D + c));
      x[j][2 * h] = v.x;
      x[j][2 * h + 1] = v.y;
    }
}

// the rows < n of a live frame, rounded to bf16, to device memory
__device__ __forceinline__ void write_rows(const Rows& x, bf16* frame,
                                           const Place& p, int n) {
  if (!p.live) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_of(p.r0, 2 * h), c = col_of(j, 2 * h);
      if (r < n)
        *reinterpret_cast<uint32_t*>(frame + r * D + c) =
            pack_bf16(x[j][2 * h], x[j][2 * h + 1]);
    }
}

// accumulator tiles 2 kk and 2 kk + 1 of 16 rows, rounded, as the A
// fragment of k-step kk
__device__ __forceinline__ void to_frag(const float (&acc)[8][4], Frag& a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// acc[j] += A (the warp's 16 x 64, fragments a) @ B[0:64, n0 + 8 j ...],
// B stored [K][N] in shared memory with row stride ldb. The tiles of a
// pair share one ldmatrix; each tile sums its k-steps in order.
template <int NT>
__device__ __forceinline__ void frag_mma(float (&acc)[NT][4], const Frag& a,
                                         const bf16* B, int ldb, int n0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      load_b_kn(b, B, ldb, n0 + 8 * j, 16 * kk);
      mma_bf16(acc[j], a[kk], b[0], b[1]);
      mma_bf16(acc[j + 1], a[kk], b[2], b[3]);
    }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// LayerNorm (eps 1e-5) of the warp's fp32 rows into fp32 rows y (scale
// and bias in T), rows >= n zero. Each row's sums take layernorm_tile's
// order: column c and c + 32 first, then the butterfly over c of warp_sum
// (c ^ 16, ^ 8 in registers, ^ 4, ^ 2 across the quad, ^ 1 in registers).
template <typename T>
__device__ __forceinline__ void norm_rows(const Rows& x, const T* s,
                                          const T* b, int r0, int n,
                                          float (&y)[8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sum = 0.f;
        sum += x[j][2 * h + e];
        sum += x[j + 4][2 * h + e];
        v[j][e] = sum;
      }
    float part[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      part[e] = (v[0][e] + v[2][e]) + (v[1][e] + v[3][e]);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 2);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 1);
    }
    const float m = (part[0] + part[1]) / D;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sq = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float xv = x[j + 4 * q][2 * h + e];
          sq += (xv - m) * (xv - m);
        }
        v[j][e] = sq;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      part[e] = (v[0][e] + v[2][e]) + (v[1][e] + v[3][e]);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 2);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 1);
    }
    const float inv = rsqrtf((part[0] + part[1]) / D + 1e-5f);
    const bool live = row_of(r0, 2 * h) < n;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col_of(j, e);
        const float xv = x[j][2 * h + e];
        y[j][2 * h + e] =
            live ? (xv - m) * inv * tof(s[c]) + tof(b[c]) : 0.f;
      }
  }
}

// the same into bf16 A fragments
__device__ __forceinline__ void norm_frag(const Rows& x, const bf16* s,
                                          const bf16* b, int r0, int n,
                                          Frag& out) {
  float y[8][4];
  norm_rows(x, s, b, r0, n, y);
  to_frag(y, out);
}

// The warp's 16 rows of one projection part, rounded to bf16, into a
// shared tile (row stride kLd) at the rows r0..
__device__ __forceinline__ void put_rows(const float (&acc)[8][4], bf16* s,
                                         int r0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(s + (size_t)row_of(r0, 2 * h) * kLd +
                                   col_of(j, 2 * h)) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
}

// bf16 pair (c, c + 1) of row r of a tile, as floats
__device__ __forceinline__ float2 pair(const bf16* s, int ld, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(s + (size_t)r * ld + c));
}

// The scores of the warp's 16 query rows (q in the frame's q tile) against
// every key, as fp32 fma chains over the head width in order: `attend`'s
// sums (block_common.cuh), in the accumulator layout of head_probs.
__device__ __forceinline__ void scores_fma(float (&s)[kKeyTiles][4],
                                           const bf16* qs, const bf16* ks,
                                           int r0, int np) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int c = 0; c < D; c += 2) {
    const float2 qa = pair(qs, kLd, r0 + g, c), qb = pair(qs, kLd, r0 + g + 8, c);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
      if (8 * j < np) {
        const float2 k0 = pair(ks, kLd, 8 * j + 2 * t, c),
                     k1 = pair(ks, kLd, 8 * j + 2 * t + 1, c);
        s[j][0] = fmaf(qa.y, k0.y, fmaf(qa.x, k0.x, s[j][0]));
        s[j][1] = fmaf(qa.y, k1.y, fmaf(qa.x, k1.x, s[j][1]));
        s[j][2] = fmaf(qb.y, k0.y, fmaf(qb.x, k0.x, s[j][2]));
        s[j][3] = fmaf(qb.y, k1.y, fmaf(qb.x, k1.x, s[j][3]));
      }
  }
}

// The probabilities of those scores (scaled, keys >= n masked), their
// sum taken in `attend`'s order: key lane L sums keys L, L + 32, L + 64,
// then warp_sum's butterfly over L (L ^ 16, ^ 8 in registers, ^ 4, ^ 2
// across the quad, ^ 1 in registers).
__device__ __forceinline__ void softmax_fma_order(float (&s)[kKeyTiles][4],
                                                  int n, float scale) {
  const int t = threadIdx.x % 4;
  const float ninf = __int_as_float(0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + 2 * t + e % 2 < n ? s[j][e] * scale : ninf;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e / 2]);
  float sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lane_sum = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (j + 4 * q < kKeyTiles) lane_sum += s[j + 4 * q][2 * h + e];
        v[j][e] = lane_sum;
      }
    float part[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      part[e] = (v[0][e] + v[2][e]) + (v[1][e] + v[3][e]);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 2);
      part[e] += __shfl_xor_sync(0xffffffffu, part[e], 1);
    }
    sum[h] = part[0] + part[1];
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e / 2];
}

// acc += o (the warp's 16 rows of the head, in the frame's q tile) @ the
// head's rows of wout, as fp32 fma chains over the head width in order:
// head by head, the FMA body's one chain over every head's columns.
__device__ __forceinline__ void out_fma(float (&acc)[8][4], const bf16* os,
                                        const bf16* wo, int r0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  for (int c = 0; c < D; c += 2) {
    const float2 oa = pair(os, kLd, r0 + g, c), ob = pair(os, kLd, r0 + g + 8, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 w0 = pair(wo, kLd, c, 8 * j + 2 * t),
                   w1 = pair(wo, kLd, c + 1, 8 * j + 2 * t);
      acc[j][0] = fmaf(oa.y, w1.x, fmaf(oa.x, w0.x, acc[j][0]));
      acc[j][1] = fmaf(oa.y, w1.y, fmaf(oa.x, w0.y, acc[j][1]));
      acc[j][2] = fmaf(ob.y, w1.x, fmaf(ob.x, w0.x, acc[j][2]));
      acc[j][3] = fmaf(ob.y, w1.y, fmaf(ob.x, w0.y, acc[j][3]));
    }
  }
}

// P.V of the warp's 16 rows: the probabilities rounded to bf16 as A
// fragments, v (the frame's tile) on the tensor cores, into acc
__device__ __forceinline__ void pv_mma(const float (&s)[kKeyTiles][4],
                                       const bf16* vs, int np,
                                       float (&acc)[8][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    if (16 * kk >= np) continue;
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      load_b_kn(b, vs, kLd, 8 * j, 16 * kk);
      mma_bf16(acc[j], pa, b[0], b[1]);
      mma_bf16(acc[j + 1], pa, b[2], b[3]);
    }
  }
}

// The fp32 probabilities of the warp's row r0 (lanes 0-3 hold it) into
// p0[0..n)
__device__ __forceinline__ void save_probs(const float (&s)[kKeyTiles][4],
                                           float* p0, int n) {
  const int lane = threadIdx.x % 32;
  if (lane >= 4) return;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (8 * j + 2 * lane + e < n) p0[8 * j + 2 * lane + e] = s[j][e];
}

// Row r0 of the warp's A fragments (lanes 0-3 hold it) into out[0..D)
__device__ __forceinline__ void save_row0(const Frag& a, float* out) {
  const int lane = threadIdx.x % 32;
  if (lane >= 4) return;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&a[kk][2 * h]));
      out[16 * kk + 8 * h + 2 * lane] = v.x;
      out[16 * kk + 8 * h + 2 * lane + 1] = v.y;
    }
}

// Row r0 of the warp's accumulator tiles into out[0..D), rounded to bf16
// where `round` says
__device__ __forceinline__ void save_row0(const float (&acc)[8][4],
                                          float* out, bool round) {
  const int lane = threadIdx.x % 32;
  if (lane >= 4) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      out[8 * j + 2 * lane + e] = round ? rt<bf16>(acc[j][e]) : acc[j][e];
}

// One head's attention of the warp's 16 query rows (q in fragments)
// against the frame's n keys (k, v in shared memory, np rows): the
// scores, max, exp, sum and quotient of block_bwd_mma's head_probs, the
// probabilities rounded to bf16 for P.V, o rounded to bf16 into
// fragments. kSave and p0 not null: row r0's fp32 probabilities to p0.
template <bool kSave = false>
__device__ __forceinline__ void attend_head(const Frag& q, const bf16* ks,
                                       const bf16* vs, int n, int np,
                                       float scale, Frag& o,
                                       float* p0 = nullptr) {
  const int t = threadIdx.x % 4;
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2)
      if (8 * j < np) {
        uint32_t b[4];
        load_b_nk(b, ks, kLd, 8 * j, 16 * kk);
        mma_bf16(s[j], q[kk], b[0], b[1]);
        mma_bf16(s[j + 1], q[kk], b[2], b[3]);
      }
  const float ninf = __int_as_float(0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + 2 * t + e % 2 < n ? s[j][e] * scale : ninf;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e / 2]);
      sum[e / 2] += s[j][e];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e / 2];
  if constexpr (kSave)
    if (p0 != nullptr) save_probs(s, p0, n);
  float acc[8][4];
  pv_mma(s, vs, np, acc);
  to_frag(acc, o);
}

// The block's 11 weights (fused-transformer order), bf16.
struct Weights {
  const bf16 *an_s, *an_b, *wqkv, *wout, *bout, *fn_s, *fn_b, *w1, *b1, *w2,
      *b2;
  __device__ explicit Weights(const void* const* w)
      : an_s((const bf16*)w[0]), an_b((const bf16*)w[1]),
        wqkv((const bf16*)w[2]), wout((const bf16*)w[3]),
        bout((const bf16*)w[4]), fn_s((const bf16*)w[5]),
        fn_b((const bf16*)w[6]), w1((const bf16*)w[7]),
        b1((const bf16*)w[8]), w2((const bf16*)w[9]),
        b2((const bf16*)w[10]) {}
};

// head hd's q|k|v columns of wqkv and its rows of wout into stage hd % 2
__device__ __forceinline__ void stage_head(unsigned char* smem,
                                           const Layout& L, const Weights& w,
                                           int heads, int hd) {
  const int inner = heads * D;
  bf16* wq = (bf16*)(smem + L.wqkv) + (hd & 1) * D * kLdQkv;
  for (int part = 0; part < 3; ++part)
    stage_rows(wq + part * D, kLdQkv, w.wqkv + part * inner + hd * D,
               3 * inner, D, D);
  stage_rows((bf16*)(smem + L.wout) + (hd & 1) * D * kLd, kLd,
             w.wout + (size_t)hd * D * D, D, D, D);
}

// w1[:, c * HC ...] and w2[c * HC ..., :] into ring stage c % kStages
__device__ __forceinline__ void stage_chunk(unsigned char* smem,
                                            const Layout& L,
                                            const Weights& w, int mlp,
                                            int c) {
  bf16* s = (bf16*)(smem + L.ring) + c % kStages * 2 * D * kLd;
  stage_rows(s, kLd, w.w1 + c * HC, mlp, D, HC);
  stage_rows(s + D * kLd, kLd, w.w2 + (size_t)c * HC * D, D, HC, D);
}

// The MLP's first two chunks in flight. Every thread calls it, after a
// barrier that ends all reads of the attention's tiles.
__device__ __forceinline__ void mlp_begin(unsigned char* smem,
                                          const Layout& L, const Weights& w,
                                          int mlp) {
  stage_chunk(smem, L, w, mlp, 0);
  cp_async_commit();
  if (HC < mlp) {
    stage_chunk(smem, L, w, mlp, 1);
    cp_async_commit();
  }
}

// y += MLP(h2) on the warp's 16 rows without b2: per chunk of HC hidden
// columns, pre = h2 @ w1c + b1 (each pair of n8 tiles summed over d as
// block_bwd_mma sums it) and hid = bf16(gelu(pre)). Tensor cores (kFma
// false): hid goes straight into A fragments and hid @ w2c from a zero
// accumulator is added to y in fp32. fp32 sums (kFma): hid goes to the
// warp's fp32 tile and hid @ w2c runs as fp32 fma chains over the hidden
// columns in order, each chain hc columns long (the FMA body's MLP chunk)
// and added to y when it ends (w2 read from the chunk's fp32 tile). Every
// thread calls it (the ring's copies and barriers); only `active` warps
// compute. kSave and z not null: the fp32 pre-activations of rows g <
// zrows to z + g zld (the CLS-only block's record, ClsSave).
template <bool kFma, bool kSave = false>
__device__ __forceinline__ void mlp_run(unsigned char* smem, const Layout& L,
                                        const Weights& w, int mlp, int hc,
                                        const Frag& h2, float (&y)[8][4],
                                        bool active, float* z = nullptr,
                                        int zld = 0, int zrows = 0) {
  const int nc = mlp / HC, t = threadIdx.x % 4, g = threadIdx.x % 32 / 4;
  float* hs = (float*)(smem + L.hid) + threadIdx.x / 32 * 16 * kLdHid;
  float part[8][4];
  zero(part);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with c - 1
    if (c + 2 < nc) {
      stage_chunk(smem, L, w, mlp, c + 2);
      cp_async_commit();
    }
    const bf16* w1c = (const bf16*)(smem + L.ring) + c % kStages * 2 * D * kLd;
    const bf16* w2c = w1c + D * kLd;
    const float* w2f = (const float*)(smem + L.w2f);
    if (kFma) {  // the chunk's w2 in fp32, columns by thread group
      for (int i = threadIdx.x; i < HC * D / 2; i += blockDim.x) {
        const int k = i / (D / 2), col = i % (D / 2) * 2;
        *reinterpret_cast<float2*>((float*)w2f + k * kLdW2 +
                                   col % 8 / 2 * kSkew + col / 8 * 2) =
            pair(w2c, kLd, k, col);
      }
      __syncthreads();
    }
    if (!active) continue;
    const bf16* b1 = w.b1 + c * HC;
    if (!kFma) zero(part);
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      float pre[2][4] = {};
#pragma unroll
      for (int k2 = 0; k2 < D / 16; ++k2) {
        uint32_t b[4];
        load_b_kn(b, w1c, kLd, 16 * kk, 16 * k2);
        mma_bf16(pre[0], h2[k2], b[0], b[1]);
        mma_bf16(pre[1], h2[k2], b[2], b[3]);
      }
      uint32_t hid[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * kk + 8 * j + 2 * t;
        const float c0 = tof(b1[col]), c1 = tof(b1[col + 1]);
        if constexpr (kSave)
          if (z != nullptr && g < zrows) {
            z[(size_t)g * zld + c * HC + col] = pre[j][0] + c0;
            z[(size_t)g * zld + c * HC + col + 1] = pre[j][1] + c1;
          }
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = rt<bf16>(gelu<bf16>(pre[j][e] + (e % 2 ? c1 : c0)));
        hid[2 * j] = pack_bf16(v[0], v[1]);
        hid[2 * j + 1] = pack_bf16(v[2], v[3]);
        if (kFma) {
          *reinterpret_cast<float2*>(hs + g * kLdHid + col) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(hs + (g + 8) * kLdHid + col) =
              make_float2(v[2], v[3]);
        }
      }
      if (!kFma) {
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t b[4];
          load_b_kn(b, w2c, kLd, 8 * j, 16 * kk);
          mma_bf16(part[j], hid, b[0], b[1]);
          mma_bf16(part[j + 1], hid, b[2], b[3]);
        }
      }
    }
    if (kFma) {
      __syncwarp();  // the warp's hidden tile is whole
      const float* wt = w2f + t * kSkew;
      for (int k = 0; k < HC; ++k) {
        const float ha = hs[g * kLdHid + k], hb = hs[(g + 8) * kLdHid + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wt + k * kLdW2 + 4 * q);
          const float w2v[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // column 8 (2 q + e / 2) + 2 t + e % 2
            const int j = 2 * q + e / 2;
            part[j][e % 2] = fmaf(ha, w2v[e], part[j][e % 2]);
            part[j][2 + e % 2] = fmaf(hb, w2v[e], part[j][2 + e % 2]);
          }
        }
      }
      __syncwarp();  // read before the next chunk overwrites the tile
      if ((c + 1) * HC % hc != 0 && c + 1 < nc) continue;  // chain goes on
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[j][e] += part[j][e];
        if (kFma) part[j][e] = 0.f;
      }
  }
}

// y = b2, the MLP sum's start (the FMA body's acc tile starts there too)
__device__ __forceinline__ void bias_rows(float (&y)[8][4], const bf16* b) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = tof(b[col_of(j, e)]);
}

// q|k|v of head hd for the warp's rows: k and v to the frame's tiles; q,
// when wanted, rounded into fragments (kFma: into the frame's q tile)
template <bool kFma>
__device__ __forceinline__ void project(const Frag& h1, const bf16* wq,
                                        bf16* ks, bf16* vs, bf16* qs, int r0,
                                        bool q_too, Frag& q) {
  float acc[8][4];
  if (q_too) {
    zero(acc);
    frag_mma<8>(acc, h1, wq, kLdQkv, 0);
    if (kFma)
      put_rows(acc, qs, r0);
    else
      to_frag(acc, q);
  }
  zero(acc);
  frag_mma<8>(acc, h1, wq, kLdQkv, D);
  put_rows(acc, ks, r0);
  zero(acc);
  frag_mma<8>(acc, h1, wq, kLdQkv, 2 * D);
  put_rows(acc, vs, r0);
}

// One full pre-norm block on the warp's rows: x holds the fp32 stream on
// entry and the block's output (unrounded) on return. With cls_only (the
// last block of K4) k and v use every row, but q, attention and the
// out-projection run only in the warps that hold row 0, and x of those
// warps ends at x1 (the caller runs the CLS rows' MLP). kFma: the scores,
// the out-projection and the MLP's second product as fp32 fma chains in
// the FMA body's order (see the top of this file). kSave, cls_only and a
// record base in sv: the warp of row 0 writes its live frame's q, fp32
// probabilities and o (ClsSave; cls_mlp writes the rest). Every thread of
// the block calls it.
template <bool kFma, bool kSave = false>
__device__ __forceinline__ void block_fwd(const Dims& m, const void* const* wp,
                                          int n, const Place& p, Rows& x,
                                          unsigned char* smem,
                                          const Layout& L, bool cls_only,
                                          const ClsSave& sv = ClsSave()) {
  const Weights w(wp);
  const int heads = m.heads;
  float* rec = nullptr;
  if constexpr (kSave)
    if (cls_only && p.r0 == 0 && p.live && sv.base != nullptr)
      rec = sv.at(p.f);
  bf16* ks = (bf16*)(smem + L.k) + (size_t)p.fl * p.np * kLd;
  bf16* vs = (bf16*)(smem + L.v) + (size_t)p.fl * p.np * kLd;
  bf16* qs = (bf16*)(smem + L.q) + (size_t)p.fl * p.np * kLd;
  const bool queries = !cls_only || p.r0 == 0;
  __syncthreads();  // the previous block's readers of the ring are done
  stage_head(smem, L, w, heads, 0);
  cp_async_commit();
  Frag h1;
  norm_frag(x, w.an_s, w.an_b, p.r0, n, h1);
  float x1[8][4];
  zero(x1);
  for (int hd = 0; hd < heads; ++hd) {
    cp_async_wait<0>();
    __syncthreads();  // head hd's weights landed; the last head's k, v read
    if (hd + 1 < heads) {
      stage_head(smem, L, w, heads, hd + 1);
      cp_async_commit();
    }
    const bf16* wq = (const bf16*)(smem + L.wqkv) + (hd & 1) * D * kLdQkv;
    const bf16* wo = (const bf16*)(smem + L.wout) + (hd & 1) * D * kLd;
    Frag q;
    project<kFma>(h1, wq, ks, vs, qs, p.r0, queries, q);
    __syncthreads();  // the frame's k and v of this head are in place
    if (!queries) continue;
    if (kFma) {
      float s[kKeyTiles][4];
      if constexpr (kSave)
        if (rec != nullptr)
          for (int c = 2 * (threadIdx.x % 32); c < D; c += 64) {
            const float2 qv = pair(qs, kLd, 0, c);
            rec[hd * D + c] = qv.x;
            rec[hd * D + c + 1] = qv.y;
          }
      scores_fma(s, qs, ks, p.r0, p.np);
      softmax_fma_order(s, n, m.scale);
      if constexpr (kSave)
        if (rec != nullptr) save_probs(s, rec + sv.p + hd * n, n);
      float acc[8][4];
      pv_mma(s, vs, p.np, acc);
      if constexpr (kSave)
        if (rec != nullptr) save_row0(acc, rec + sv.o + hd * D, true);
      __syncwarp();  // every lane's q read
      put_rows(acc, qs, p.r0);
      __syncwarp();  // o whole in the tile
      out_fma(x1, qs, wo, p.r0);  // one chain over the heads
      continue;
    }
    Frag o;
    if constexpr (kSave) {
      if (rec != nullptr) save_row0(q, rec + hd * D);
      attend_head<true>(q, ks, vs, n, p.np, m.scale, o,
                        rec != nullptr ? rec + sv.p + hd * n : nullptr);
      if (rec != nullptr) save_row0(o, rec + sv.o + hd * D);
    } else {
      attend_head(q, ks, vs, n, p.np, m.scale, o);
    }
    float acc[8][4];
    zero(acc);
    frag_mma<8>(acc, o, wo, kLd, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x1[j][e] += acc[j][e];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[j][e] = x[j][e] + (x1[j][e] + tof(w.bout[col_of(j, e)]));
  __syncthreads();  // every read of the attention's tiles is done
  mlp_begin(smem, L, w, m.mlp);
  if (cls_only) return;
  Frag h2;
  norm_frag(x, w.fn_s, w.fn_b, p.r0, n, h2);
  float y[8][4];
  bias_rows(y, w.b2);
  mlp_run<kFma>(smem, L, w, m.mlp, m.hc, h2, y, true);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] += y[j][e];
}

// The CLS-only block's MLP after block_fwd(cls_only): the warps of row 0
// put LN2 of their frame's CLS row (row fl of the cls_h tile, whose other
// rows are zero) and x1 of it (cls_x1[fl]) in shared memory; warp 0 runs
// the MLP on that tile and leaves b2 + MLP of each CLS row in cls_y.
// kSave and a record base in sv: each live frame's x1, h2 and fp32
// pre-activations to its record (ClsSave).
template <bool kFma, bool kSave = false>
__device__ __forceinline__ void cls_mlp(const Dims& m, const void* const* wp,
                                        int n, const Place& p, const Rows& x,
                                        unsigned char* smem, const Layout& L,
                                        const ClsSave& sv = ClsSave(),
                                        int batch = 0) {
  const Weights w(wp);
  bf16* hs = (bf16*)(smem + L.cls_h);
  float* x1s = (float*)(smem + L.cls_x1) + p.fl * D;
  const int lane = threadIdx.x % 32;
  if (p.r0 == 0) {
    Frag h2;
    norm_frag(x, w.fn_s, w.fn_b, p.r0, n, h2);
    if constexpr (kSave)
      if (sv.base != nullptr && p.live) {
        save_row0(h2, sv.at(p.f) + sv.h2);
        save_row0(x, sv.at(p.f) + sv.x1, false);
      }
    if (lane < 4) {  // row 0: g = 0, the first and third register of each
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 16 * kk + 2 * lane;
        *reinterpret_cast<uint32_t*>(hs + p.fl * kLd + c) = h2[kk][0];
        *reinterpret_cast<uint32_t*>(hs + p.fl * kLd + c + 8) = h2[kk][2];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x1s[col_of(j, 0)] = x[j][0];
        x1s[col_of(j, 1)] = x[j][1];
      }
    }
  }
  __syncthreads();
  const bool active = threadIdx.x < 32;
  Frag h2;
  if (active)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(h2[kk], hs, kLd, 0, 16 * kk);
  float y[8][4];
  bias_rows(y, w.b2);
  if constexpr (kSave) {
    const int f0 = blockIdx.x * kFrames;
    mlp_run<kFma, true>(smem, L, w, m.mlp, m.hc, h2, y, active,
                        sv.base != nullptr ? sv.at(f0) + sv.z : nullptr,
                        sv.stride, batch - f0 < kFrames ? batch - f0
                                                        : kFrames);
  } else {
    mlp_run<kFma>(smem, L, w, m.mlp, m.hc, h2, y, active);
  }
  if (active && lane / 4 < kFrames) {
    float* ys = (float*)(smem + L.cls_y) + lane / 4 * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ys[col_of(j, 0)] = y[j][0];
      ys[col_of(j, 1)] = y[j][1];
    }
  }
  __syncthreads();
}

// The stream rounded to bf16 between blocks; rows >= n back to zero
__device__ __forceinline__ void round_rows(Rows& x, int r0, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[j][e] = row_of(r0, e) < n ? rt<bf16>(x[j][e]) : 0.f;
}

// Whether the body takes these widths and pointers.
__host__ inline bool takes(int n, const Dims& m, const void* const* aligned,
                           int count) {
  uintptr_t any = 0;
  for (int i = 0; i < count; ++i) any |= (uintptr_t)aligned[i];
  return m.d == D && m.dh == D && n >= 1 && n <= kMaxRows &&
         m.mlp % HC == 0 && any % 16 == 0;
}

// Launch over ceil(batch / kFrames) thread blocks of warps(n) warps with
// `bytes` of dynamic shared memory (Layout(n).total for the body alone).
// Returns a cudaError_t.
template <typename Kernel, typename... KArgs>
int launch_fwd(Kernel kernel, int n, int batch, size_t bytes,
               cudaStream_t stream, const KArgs&... args) {
  size_t limit = 0;
  const int err = smem_opt_in(kernel, &limit);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return cudaErrorInvalidValue;
  kernel<<<(batch + kFrames - 1) / kFrames, 32 * warps(n), bytes, stream>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace mmafwd
}  // namespace
