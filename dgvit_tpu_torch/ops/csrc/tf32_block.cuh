// The fp32 pre-norm block over a thread-block cluster, every product on
// the tensor cores (tf32_mma.cuh; see below): the block body of K1's and
// K4's fp32 cluster forms (got_megakernel.cu: k1_cluster_fp32_kernel,
// k4_cluster_fp32_kernel) and of K2's and K3's fp32 forms at the flagship
// widths (block_grad.cu: block_fwd_cluster_fp32_kernel and the recompute
// of block_bwd_cluster_fp32_kernel; cls_attend_cluster_fp32_kernel and
// the recompute of cls_bwd_cluster_fp32_kernel), which include this one
// body so that a backward recomputes the forward that ran, bit for bit.
//
// One frame a cluster of kRanks CTAs on neighbouring SMs (the bf16
// cluster's partition, got_megakernel.cu namespace cl): rank r takes head
// r (its q|k|v slice of wqkv, its attention, its out-projection partial)
// and the MLP hidden columns [r mlp / 4, (r + 1) mlp / 4).
//  * Every CTA holds the frame's fp32 stream (16 rows a warp, in
//    registers, the accumulator layout) and computes the LayerNorms
//    itself (mmafwd::norm_rows' order). A warp's normed rows, its q, its
//    probabilities, its o and its GELU values go straight from
//    accumulator tiles into A fragments (tf32::frag), so no activation of
//    a row passes through shared memory but k and v, which every warp
//    reads.
//  * Weights are fp32 tiles staged by 16-byte cp.async: the head's wqkv
//    and wout slices once a block (while LN1 runs), the MLP's w1 and w2
//    chunks of 64 hidden columns in a two-stage ring. A rank reads 320 KB
//    of weights a block, all from L2.
//  * The head partials and the MLP partials go through distributed shared
//    memory: each rank writes its fp32 partial into its own shared memory;
//    after cluster.sync() every rank reads the kRanks partials through
//    map_shared_rank and adds them in rank order, so every rank holds the
//    same fp32 stream: x + (o wout + bout), then x1 + (b2 + the MLP's
//    partials).
// fp32 has no rounding point between the products, so the function is
// the plain version's; the sums go in another order, which a policy sets
// (Fast, Exact below). The MLP's products are 3xTF32, which leaves at
// most about 2^-21 of each product. K2f and K2b (Exact) split the
// attention's operands (q|k|v, the scores, P.V, the out-projection)
// exactly into three TF32 parts, six products where 3xTF32 takes three
// (tf32::A3), as exact as fp32's, and sum each 8-deep step of every
// product from zero before adding it in fp32 (tf32::mma_add), so no sum
// drifts with the tensor cores' truncation. K1 (Fast) takes 3xTF32
// throughout, accumulated on the tensor cores.
//
// The body comes in two halves, `attend` (LN1 to LN2: x becomes x1, h2
// the normed rows; its first part, `project`, LN1 and the head's q, k and
// v) and `mlp` (the MLP and its exchange), which `block` runs in turn.
// Each takes a Save, whose hooks see the intermediates as the body
// computes them (h1, q, the probabilities, o, x1 and h2, the GELU
// values); NoSave sees nothing. K2's backward (block_grad.cu) runs
// `attend` itself and the MLP's forward products with its own reverse
// pass, K3's runs `project` (its CLS row's forward comes from the
// records); a measurement (the fp32 probe) runs `block` and writes what
// its hooks see.
//
// Widths: d = dim_head = 64, 4 heads, at most 80 rows a frame, mlp a
// multiple of 4 x 64, fp32 tensors 16-byte aligned (the launches check
// them; ops/smem.py mirrors the layouts).

#pragma once

#include <cooperative_groups.h>

#include "block_common.cuh"
#include "block_mma_fwd.cuh"
#include "tf32_mma.cuh"

namespace {
namespace cl32 {

namespace cg = cooperative_groups;
constexpr int kRanks = 4;
constexpr int kPart = 8 * 4 * 32;  // a warp's 16 x 64 fp32 partial
constexpr int D = mmafwd::D;
using mmafwd::HC;                          // MLP hidden columns a chunk
constexpr int kEmbCols = D / kRanks;       // K1's embedding columns a rank
// Row strides (floats): the k tile is read as pairs (2t, 2t + 1) of row g
// (8 mod 32); weight tiles [in][out], the v tile and the pe_w slice as
// single values of rows 2t and 2t + 1 at column g (4 mod 32)
constexpr int kLdK = D + 8, kLdW = D + 4, kLdPe = kEmbCols + 4;

// A CTA's shared memory in K1's fp32 cluster form (and, with pd = 0, in
// K2f's): one head's k and v of every row, its q|k|v and wout slices, and
// over them the MLP's ring and K1's pe_w slice; then the two partial
// tiles, K1's embedding columns and the CLS row.
struct Layout {
  size_t k, v, wq, wo, ring, pe, part_a, part_m, emb, cls, total;
  __host__ __device__ Layout(int n, int pd) {
    using mmafwd::take;
    const size_t np = round16(n), w64 = sizeof(float) * D * kLdW;
    size_t o = 0;
    k = take(o, sizeof(float) * np * kLdK);  // the head's k, v of every row
    v = take(o, sizeof(float) * np * kLdW);
    wq = take(o, 3 * w64);                   // q|k|v slices, [in][out] each
    wo = take(o, w64);
    const size_t attn = o;
    o = 0;
    ring = take(o, 2 * 2 * w64);  // w1, w2 chunks, two stages
    const size_t mlp = o;
    o = 0;
    pe = take(o, sizeof(float) * pd * kLdPe);  // the rank's pe_w columns
    o = o > attn ? o : attn;
    o = o > mlp ? o : mlp;
    const size_t part = sizeof(float) * (np / 16) * kPart;
    part_a = take(o, part);  // the out-projection partials
    part_m = take(o, part);  // the MLP partials
    emb = take(o, sizeof(float) * np * kEmbCols);  // the rank's columns
    cls = take(o, sizeof(float) * D);              // the CLS row
    total = o;
  }
};

// the warp's 16 rows from a (rows, 64) fp32 frame (row stride ld), rows
// >= n zero
__device__ __forceinline__ void read_rows(float (&v)[8][4], const float* m,
                                          int ld, int r0, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mmafwd::row_of(r0, 2 * h);
      float2 x = make_float2(0.f, 0.f);
      if (r < n)
        x = *reinterpret_cast<const float2*>(m + (size_t)r * ld +
                                             mmafwd::col_of(j, 0));
      v[j][2 * h] = x.x;
      v[j][2 * h + 1] = x.y;
    }
}

// a warp's partial (accumulator layout) into its slot of a partial tile
__device__ __forceinline__ void put_part(const float (&acc)[8][4],
                                         float* tile) {
  float* s = tile + threadIdx.x / 32 * kPart + threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[(4 * j + e) * 32] = acc[j][e];
}

// acc += each rank's partial of this warp, in rank order
__device__ __forceinline__ void add_parts(cg::cluster_group& cluster,
                                          float* tile, float (&acc)[8][4]) {
  const int at = threadIdx.x / 32 * kPart + threadIdx.x % 32;
#pragma unroll
  for (int rk = 0; rk < kRanks; ++rk) {
    const float* s = cluster.map_shared_rank(tile, rk) + at;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += s[(4 * j + e) * 32];
  }
}

// rows x cols fp32 from device memory (row stride gld) into shared memory
// (row stride sld) by 16-byte cp.async; cols, both strides and both
// addresses multiples of 4 floats. Commits nothing.
__device__ __forceinline__ void stage(float* s, int sld, const float* g,
                                      size_t gld, int rows, int cols) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i % per_row * 4;
    cp_async16(s + (size_t)r * sld + c, g + r * gld + c);
  }
}

// How a body sums its products. Attn: the split of the attention's
// operands (q|k|v, the scores, P.V and the out-projection; the MLP's are
// always tf32::A). kStep: each 8-deep step summed from zero and added in
// fp32 (tf32::mma_add), or accumulated on the tensor cores (tf32::mma3).
// K1's fp32 cluster form takes Fast: 3xTF32 accumulated on the tensor
// cores, which its latent check passes. K2f and K2b take Exact: the
// attention's operands split exactly into three TF32 parts and every step
// summed from zero. A backward's gradients magnify what a forward's
// latent does not (K2b's fp32 check failed at B = 8 with Fast's sums).
struct Fast {
  using Attn = tf32::A;
  static constexpr bool kStep = false;
};
struct Exact {
  using Attn = tf32::A3;
  static constexpr bool kStep = true;
};

// c += a b as policy P sums it
template <typename P, typename F>
__device__ __forceinline__ void prod(float (&c)[4], const F& a, float b0,
                                     float b1) {
  if constexpr (P::kStep)
    tf32::mma_add(c, a, b0, b1);
  else
    tf32::mma3(c, a, b0, b1);
}

// acc[j] += a (the warp's 16 rows x 64, accumulator layout) @ W[0:64,
// 8 j ...] for j < 8, W a [64][kLdW] tile in shared memory; F the split
// of each step's A fragment (tf32::A, 3xTF32; tf32::A3, the exact split)
template <typename P, typename F>
__device__ __forceinline__ void rows_mma(float (&acc)[8][4],
                                         const float (&a)[8][4],
                                         const float* w) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    F af;
    tf32::frag(af, a[kk]);
    const float* w0 = w + (8 * kk + 2 * t) * kLdW + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      prod<P>(acc[j], af, w0[8 * j], w0[kLdW + 8 * j]);
  }
}

using mmafwd::zero;

// The warp's 16 query rows of one head: the scores q k^T over np keys
// (keys >= n masked), then the exact softmax in fp32 (max, exp, sum, p =
// e / sum), in the accumulator layout (key tile j, entry e: row g + 8 (e /
// 2), key 8 j + 2 t + e % 2).
template <typename P>
__device__ __forceinline__ void probs(float (&s)[mmafwd::kKeyTiles][4],
                                      const float (&q)[8][4], const float* ks,
                                      int n, int np, float scale) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < mmafwd::kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    typename P::Attn af;
    tf32::frag(af, q[kk]);
#pragma unroll
    for (int j = 0; j < mmafwd::kKeyTiles; ++j)
      if (8 * j < np) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (size_t)(8 * j + g) * kLdK + 8 * kk + 2 * t);
        prod<P>(s[j], af, kv.x, kv.y);
      }
  }
  const float ninf = __int_as_float(0xff800000);
  float mx0 = ninf, mx1 = ninf;
#pragma unroll
  for (int j = 0; j < mmafwd::kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + 2 * t + (e & 1) < n ? s[j][e] * scale : ninf;
      if (e < 2)
        mx0 = fmaxf(mx0, s[j][e]);
      else
        mx1 = fmaxf(mx1, s[j][e]);
    }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < mmafwd::kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - (e < 2 ? mx0 : mx1));
      if (e < 2)
        sum0 += s[j][e];
      else
        sum1 += s[j][e];
    }
  sum0 = quad_sum(sum0);
  sum1 = quad_sum(sum1);
#pragma unroll
  for (int j = 0; j < mmafwd::kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / (e < 2 ? sum0 : sum1);
}

// The hooks of a body that keeps nothing (K1, K2f). A Save's hooks are
// called by every warp that computes the value, with the warp's rows in
// the accumulator layout: h1 (LN1's output), q (the head's queries), p
// (the head's probabilities, probs' layout), o (the head's attention
// output), x1h2 (x1 = x + attention, and LN2's output), hid (the GELU
// values of hidden columns [col0, col0 + 64)).
struct NoSave {
  __device__ __forceinline__ void h1(const float (&)[8][4]) {}
  __device__ __forceinline__ void q(const float (&)[8][4]) {}
  __device__ __forceinline__ void p(const float (&)[mmafwd::kKeyTiles][4]) {}
  __device__ __forceinline__ void o(const float (&)[8][4]) {}
  __device__ __forceinline__ void x1h2(const float (&)[8][4],
                                       const float (&)[8][4]) {}
  __device__ __forceinline__ void hid(const float (&)[8][4], int) {}
};

// y += the MLP on h2 over hidden chunks [c0, c0 + nc) of HC columns: the
// chunk's GELU values (the erf form) straight from z's accumulator tiles
// into A fragments; the w1 and w2 chunks pass through a two-stage ring.
// Every thread calls it; only `active` warps compute.
template <typename P, typename Save>
__device__ __forceinline__ void mlp_part(unsigned char* smem, const Layout& L,
                                         const float* w1, const float* b1,
                                         const float* w2, int mlp, int c0,
                                         int nc, const float (&h2)[8][4],
                                         float (&y)[8][4], bool active,
                                         Save& save) {
  float* ring = (float*)(smem + L.ring);
  auto fetch = [&](int i) {
    float* s = ring + (i & 1) * 2 * D * kLdW;
    stage(s, kLdW, w1 + (c0 + i) * HC, mlp, D, HC);
    stage(s + D * kLdW, kLdW, w2 + (size_t)(c0 + i) * HC * D, D, HC, D);
    cp_async_commit();
  };
  fetch(0);
  for (int i = 0; i < nc; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i landed; every warp is done with i - 1
    if (i + 1 < nc) fetch(i + 1);
    if (!active) continue;
    const float* w1c = ring + (i & 1) * 2 * D * kLdW;
    const float* b1c = b1 + (c0 + i) * HC;
    float z[8][4];
    zero(z);
    rows_mma<P, tf32::A>(z, h2, w1c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        z[j][e] = gelu<float>(z[j][e] + b1c[mmafwd::col_of(j, e)]);
    save.hid(z, (c0 + i) * HC);
    rows_mma<P, tf32::A>(y, z, w1c + D * kLdW);
  }
}

// LN1 of the warp's rows and the head's projections: q of the warp's rows
// (into q, when `queries`), k and v of every row (into L.k and L.v). x is
// the fp32 stream (read only). Every thread of the CTA calls it; on
// return the head's k and v of every row are in place. K3b's fp32 cluster
// form (block_grad.cu) runs it alone, so its k and v are the forward's.
template <typename P, typename Save>
__device__ __forceinline__ void project(const Dims& m, const void* const* wp,
                                        int n, int rank, int r0,
                                        const mmafwd::Rows& x,
                                        float (&q)[8][4], unsigned char* smem,
                                        const Layout& L, bool queries,
                                        Save& save) {
  const float* an_s = (const float*)wp[0];
  const float* an_b = (const float*)wp[1];
  const float* wqkv = (const float*)wp[2];
  const float* wout = (const float*)wp[3];
  const int inner = m.heads * D;
  float* ks = (float*)(smem + L.k);
  float* vs = (float*)(smem + L.v);
  float* wq = (float*)(smem + L.wq);
  __syncthreads();  // the previous block's readers of these tiles are done
  for (int part = 0; part < 3; ++part)
    stage(wq + part * D * kLdW, kLdW, wqkv + part * inner + rank * D,
          3 * inner, D, D);
  stage((float*)(smem + L.wo), kLdW, wout + (size_t)rank * D * D, D, D, D);
  cp_async_commit();
  float h[8][4];
  mmafwd::norm_rows(x, an_s, an_b, r0, n, h);
  save.h1(h);
  cp_async_wait<0>();
  __syncthreads();  // the head's weights landed
  // q (kept in registers), k and v of every row (to the tiles)
  for (int part = queries ? 0 : 1; part < 3; ++part) {
    float acc[8][4];
    zero(acc);
    rows_mma<P, typename P::Attn>(acc, h, wq + part * D * kLdW);
    if (part == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[j][e] = acc[j][e];
      save.q(q);
      continue;
    }
    float* tile = part == 1 ? ks : vs;
    const int ld = part == 1 ? kLdK : kLdW;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            tile + (size_t)mmafwd::row_of(r0, 2 * hh) * ld +
            mmafwd::col_of(j, 0)) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
  __syncthreads();  // the head's k and v of every row are in place
}

// The first half of a pre-norm block of the cluster's frame on the warp's
// rows: x holds the fp32 stream on entry and x1 = x + (o wout + bout) on
// return, h2 its LayerNorm (rows >= n zero); the head's k and v of every
// row stay in L.k and L.v. With cls_only only the warp of row 0 runs q,
// attention and the out-projection (x1 and h2 are then its only). Every
// thread of every CTA of the cluster calls it.
template <typename P, typename Save>
__device__ __forceinline__ void attend(cg::cluster_group& cluster,
                                       const Dims& m, const void* const* wp,
                                       int n, int rank, int r0,
                                       mmafwd::Rows& x, float (&h2)[8][4],
                                       unsigned char* smem, const Layout& L,
                                       bool cls_only, Save& save) {
  const float* bout = (const float*)wp[4];
  const float* fn_s = (const float*)wp[5];
  const float* fn_b = (const float*)wp[6];
  const int np = round16(n);
  const float* ks = (const float*)(smem + L.k);
  const float* vs = (const float*)(smem + L.v);
  const float* wo = (const float*)(smem + L.wo);
  const bool queries = !cls_only || r0 == 0;
  float q[8][4];
  project<P>(m, wp, n, rank, r0, x, q, smem, L, queries, save);
  if (queries) {
    const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
    float s[mmafwd::kKeyTiles][4];
    probs<P>(s, q, ks, n, np, m.scale);
    save.p(s);
    // o = p v, then the head's out-projection partial o @ wout[r 64 ...]
    float o[8][4];
    zero(o);
#pragma unroll
    for (int kk = 0; kk < mmafwd::kKeyTiles; ++kk) {
      if (8 * kk >= np) continue;
      typename P::Attn pa;
      tf32::frag(pa, s[kk]);
      const float* v0 = vs + (size_t)(8 * kk + 2 * t) * kLdW + g;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        prod<P>(o[j], pa, v0[8 * j], v0[kLdW + 8 * j]);
    }
    save.o(o);
    float acc[8][4];
    zero(acc);
    rows_mma<P, typename P::Attn>(acc, o, wo);
    put_part(acc, (float*)(smem + L.part_a));
  }
  cluster.sync();  // every rank's head partial is in place
  if (queries) {
    float x1[8][4];
    zero(x1);
    add_parts(cluster, (float*)(smem + L.part_a), x1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = x[j][e] + (x1[j][e] + bout[mmafwd::col_of(j, e)]);
    mmafwd::norm_rows(x, fn_s, fn_b, r0, n, h2);
    save.x1h2(x, h2);
  }
}

// The second half: the MLP's quarter of this rank on h2, the partials
// exchanged; x (x1 on entry) becomes the block's output, rows >= n zero.
// Every thread of every CTA of the cluster calls it.
template <typename P, typename Save>
__device__ __forceinline__ void mlp(cg::cluster_group& cluster,
                                    const Dims& m, const void* const* wp,
                                    int n, int rank, int r0, mmafwd::Rows& x,
                                    const float (&h2)[8][4],
                                    unsigned char* smem, const Layout& L,
                                    bool cls_only, Save& save) {
  const float* w1 = (const float*)wp[7];
  const float* b1 = (const float*)wp[8];
  const float* w2 = (const float*)wp[9];
  const float* b2 = (const float*)wp[10];
  const bool queries = !cls_only || r0 == 0;
  const int quarter = m.mlp / kRanks;
  float y[8][4];
  zero(y);
  mlp_part<P>(smem, L, w1, b1, w2, m.mlp, rank * quarter / HC, quarter / HC, h2,
           y, queries, save);
  if (queries) put_part(y, (float*)(smem + L.part_m));
  cluster.sync();  // every rank's MLP partial is in place
  if (queries) {
    float v[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = b2[mmafwd::col_of(j, e)];
    add_parts(cluster, (float*)(smem + L.part_m), v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = mmafwd::row_of(r0, e) < n ? x[j][e] + v[j][e] : 0.f;
  }
}

// One pre-norm block of the cluster's frame on the warp's rows: x holds
// the fp32 stream on entry and the block's output on return (rows >= n
// zero). With cls_only only the warp of row 0 runs q, attention, the
// out-projection and the MLP, and only its row 0 is the block's output.
// Every thread of every CTA of the cluster calls it.
template <typename P, typename Save = NoSave>
__device__ __forceinline__ void block(cg::cluster_group& cluster,
                                      const Dims& m, const void* const* wp,
                                      int n, int rank, int r0,
                                      mmafwd::Rows& x, unsigned char* smem,
                                      const Layout& L, bool cls_only,
                                      Save save = Save()) {
  float h2[8][4];
  attend<P>(cluster, m, wp, n, rank, r0, x, h2, smem, L, cls_only, save);
  mlp<P>(cluster, m, wp, n, rank, r0, x, h2, smem, L, cls_only, save);
}

// A launch of `kernel` over batch clusters of kRanks CTAs of round16(n) /
// 16 warps, `bytes` of dynamic shared memory each, with cudaLaunchKernelEx
// and the cluster dimension attribute. Returns a cudaError_t (a cluster
// the device cannot schedule fails to launch).
template <typename Kernel, typename... Ts>
int launch(Kernel kernel, int n, int batch, size_t bytes, cudaStream_t s,
           Ts... args) {
  size_t limit = 0;
  cudaError_t err = (cudaError_t)smem_opt_in(kernel, &limit);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks * batch, 1, 1);
  cfg.blockDim = dim3(32 * (round16(n) / 16), 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cl32
}  // namespace
