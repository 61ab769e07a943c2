// Whole-trunk GoT forwards: K1 (embed + trunk) and K4 (trunk of an
// already embedded stream).
//
// K1 replaces dgvit_tpu/ops/got_megakernel.py::_mega_kernel (the Pallas
// TPU kernel behind got_forward_fused). Per frame it computes
//   patch-embed matmul + bias -> goal token prepended -> + positional
//   embedding -> depth-1 full pre-norm blocks -> a final block for the CLS
//   (goal) row only -> final RMS or Layer norm.
// K4 replaces _blocks_kernel (blocks_cls_forward_fused): the same trunk
// from the blocks on, for forwards whose embedding and emb-dropout ran
// outside the kernel. When autograd records, every body of K4 also writes
// the streams between its blocks (Args::xs, Args::cls) and its CLS
// block's intermediates (Args::sv, ClsSave in block_common.cuh), which K6
// (the whole-trunk backward, block_grad.cu) differentiates in place of a
// forward of its own.
// Numerics are the TPU kernels' (block_common.cuh); the residual stream
// is rounded to the compute dtype T after every block.
//
// What bounds it on an H100: at the flagship width a frame costs about
// 150 MFLOP over its 65 tokens and reads 41 KB of bf16 patches (K4: 8 KB
// of stream), so the work is compute-bound from a few dozen frames up and
// latency-bound at one frame: one SM running a frame's four blocks one
// product after another.
//
// Design of trunk_kernel (fp32 past K1's cluster bound, fp32 and bf16 off
// the flagship widths or past 80 rows; K4 in fp32 when autograd records
// and off the flagship widths): one thread block of 256 threads per
// frame. The fp32 residual stream, the normed
// activations, one head's q/k/v rows, the attention output and one MLP
// hidden chunk all live in dynamic shared memory (about 100 KB in bf16,
// 165 KB in fp32), so no activation touches device memory between the
// input read and the (64,) latent write. Weights are read from device
// memory, where the whole parameter set (2.7 MB in bf16) stays in the 50
// MB L2. Matrix products are plain fp32 FMA loops with a register tile of
// 8 rows per thread, which reuses each weight element eight times; padded
// token rows (65 -> 72 on the TPU) are never computed. So a frame holds
// at most 147 tokens in bf16 and 89 in fp32 at the flagship widths
// (got_forward_smem exports the bytes; ops/smem.py routes longer frames
// to the composed blocks).
//
// The bf16 kernels at the flagship widths run the blocks on
// block_mma_fwd.cuh's body (mma_trunk below, shared by K4 and K1), two
// frames a thread block, each warp holding 16 rows of the stream in
// registers through all four blocks, the CLS block's k/v projection over
// every row on the tensor cores as well, and its MLP on one 16-row tile of
// the frames' CLS rows (one warp):
//  * trunk_mma_kernel<true> (K4; tensor_core_fwd in
//    ops/fused_transformer.py): the body's K4 form, the qkv projection,
//    the MLP's first product and P.V on the tensor cores and the scores,
//    the out-projection and the MLP's second product as the FMA body's
//    fp32 chains;
//  * k1_mma_kernel (K1 past 90 frames on an H100; k1_form_for in
//    ops/got_megakernel.py): every product on the tensor cores, after an
//    embedding prologue on the tensor cores (embed_rows);
//  * k1_cluster_kernel (K1 up to 90 frames on an H100): one frame
//    over a cluster of 4 CTAs, one head and a quarter of the MLP a CTA,
//    the partial sums exchanged through distributed shared memory (see
//    namespace cl below). It puts 4 SMs on each frame of a small batch.
// In fp32 at the flagship widths up to the same bound, K1 is
// k1_cluster_fp32_kernel (namespace cl32): that partition with every
// product on the tensor cores as 3xTF32 (tf32_mma.cuh); K4's fp32
// forwards that write no streams are k4_cluster_fp32_kernel, the same
// kernel from the blocks on (k4_form_for in ops/got_megakernel.py).
#include <cooperative_groups.h>

#include "block_common.cuh"
#include "block_mma_fwd.cuh"
#include "tf32_block.cuh"

namespace {

constexpr int kMaxDepth = 16;
constexpr int kMaxPtrs = 5 + 11 * kMaxDepth + 3;

struct Args {
  // K1: patches, goal, pe_w, pe_b, pos, 11 per block, fn_s, fn_b, out
  // K4: x, 11 per block, fn_s, fn_b, out
  const void* p[kMaxPtrs];
  // K4 when autograd records (else null): each full block's rounded
  // output, (depth - 1, B, n, d), and the rounded pre-norm CLS row, (B, d),
  // in T: the streams K6 differentiates
  void* xs;
  void* cls;
  ClsSave sv;  // and the CLS block's records (null base: none)
  int n, n_patch, pd, depth, final_norm;
  Dims m;
};

// One frame per thread block. K1 (kEmbed) embeds the frame's patches and
// goal token; K4 loads its embedded stream. Then depth-1 full blocks, the
// CLS-only last block and the final norm, written out inline: keeping the
// block loop in the kernel body (not in a shared device function) is worth
// ~15% of K1's time on an H100 (nvcc's code for the block loop differs).
template <typename T, bool kEmbed>
__global__ void __launch_bounds__(kThreads)
    trunk_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = a.m.d, f = blockIdx.x;
  const Smem<T> L(n, d, a.m.heads, a.m.dh, a.m.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  float* acc = (float*)(smem_raw + L.acc);
  float* prob = (float*)(smem_raw + L.prob);
  T* h = (T*)(smem_raw + L.h);
  T* scratch = (T*)(smem_raw + L.scratch);
  constexpr int kBlocks = kEmbed ? 5 : 1;   // index of block 0's weights
  const float* fn_s = (const float*)a.p[kBlocks + 11 * a.depth];
  const float* fn_b = (const float*)a.p[kBlocks + 1 + 11 * a.depth];
  T* out = (T*)a.p[kBlocks + 2 + 11 * a.depth] + (size_t)f * d;

  if (kEmbed) {
    const T* patches = (const T*)a.p[0] + (size_t)f * a.n_patch * a.pd;
    const T* goal = (const T*)a.p[1] + (size_t)f * d;
    const T* pe_w = (const T*)a.p[2];
    const T* pe_b = (const T*)a.p[3];
    const T* pos = (const T*)a.p[4];
    // T(T(patches @ pe_w + pe_b) + pos) rows 1.., T(goal + pos) row 0
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      x32[c] = rt<T>(tof(goal[c]) + tof(pos[c]));
    matmul(patches, a.pd, a.n_patch, pe_w, d, a.pd, d, Ident(),
           [=](int r, int c, float v) {
             const float e = rt<T>(v + tof(pe_b[c]));
             x32[(size_t)(r + 1) * d + c] =
                 rt<T>(e + tof(pos[(size_t)(r + 1) * d + c]));
           });
  } else {
    const T* x = (const T*)a.p[0] + (size_t)f * n * d;
    for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  }
  __syncthreads();

  for (int i = 0; i < a.depth; ++i) {
    const bool last = i == a.depth - 1;
    block<T, !kEmbed>(a.m, a.p + kBlocks + 11 * i, n, last, x32, acc, prob,
                      h, scratch,
                      last && a.sv.base != nullptr ? a.sv.at(f) : nullptr,
                      a.sv);
    // the residual stream round-trips the compute dtype between blocks
    const int rows = last ? 1 : n;
    for (int j = threadIdx.x; j < rows * d; j += blockDim.x)
      x32[j] = rt<T>(x32[j]);
    if constexpr (!kEmbed) {
      if (a.xs != nullptr) {  // K4's streams, as this thread rounded them
        T* s = last ? (T*)a.cls + (size_t)f * d
                    : (T*)a.xs + ((size_t)i * gridDim.x + f) * n * d;
        for (int j = threadIdx.x; j < rows * d; j += blockDim.x)
          s[j] = fromf<T>(x32[j]);
      }
    }
    __syncthreads();
  }

  // final norm of the CLS row (warp 0)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < d; c += 32) {
      sum += x32[c];
      sq += x32[c] * x32[c];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if (a.final_norm == 0) {
      const float norm = fmaxf(sqrtf(sq), 1e-12f);
      const float sd = sqrtf((float)d);
      for (int c = lane; c < d; c += 32)
        out[c] = fromf<T>(x32[c] / norm * sd * fn_s[c]);
    } else {
      const float m = sum / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) v += (x32[c] - m) * (x32[c] - m);
      const float inv = rsqrtf(warp_sum(v) / d + 1e-5f);
      for (int c = lane; c < d; c += 32)
        out[c] = fromf<T>((x32[c] - m) * inv * fn_s[c] + fn_b[c]);
    }
  }
}

// The final RMS or Layer norm of one rounded fp32 CLS row x32 (64 values
// in shared memory) into row f of out (in T), by one warp. tail: fn_s,
// fn_b, out.
template <typename T = bf16>
__device__ __forceinline__ void final_norm_row(const float* x32,
                                               const void* const* tail,
                                               int final_norm, int f) {
  const int d = mmafwd::D, lane = threadIdx.x % 32;
  const float* fn_s = (const float*)tail[0];
  const float* fn_b = (const float*)tail[1];
  T* out = (T*)tail[2] + (size_t)f * d;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    sum += x32[c];
    sq += x32[c] * x32[c];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  if (final_norm == 0) {
    const float norm = fmaxf(sqrtf(sq), 1e-12f);
    const float sd = sqrtf((float)d);
    for (int c = lane; c < d; c += 32)
      out[c] = fromf<T>(x32[c] / norm * sd * fn_s[c]);
  } else {
    const float m0 = sum / d;
    float v = 0.f;
    for (int c = lane; c < d; c += 32) v += (x32[c] - m0) * (x32[c] - m0);
    const float inv = rsqrtf(warp_sum(v) / d + 1e-5f);
    for (int c = lane; c < d; c += 32)
      out[c] = fromf<T>((x32[c] - m0) * inv * fn_s[c] + fn_b[c]);
  }
}

// The depth-1 full blocks, the CLS-only block and the final norm on
// block_mma_fwd.cuh's body (kFma: its K4 form), for the rows in x: two
// frames a thread block and 16 rows a warp, the stream in registers
// throughout and rounded to bf16 between blocks. w: block 0's weights,
// then 11 per block, fn_s, fn_b and out. xs and cls, unless null, and with
// kSave the CLS block's records in sv: what K6 reads (Args). K4 and K1
// share it.
template <bool kFma, bool kSave = false>
__device__ __forceinline__ void mma_trunk(const Dims& m, const void* const* w,
                                          int n, int depth, int final_norm,
                                          int batch, const mmafwd::Place& p,
                                          mmafwd::Rows& x,
                                          unsigned char* smem_raw,
                                          const mmafwd::Layout& L, bf16* xs,
                                          bf16* cls,
                                          const ClsSave& sv = ClsSave()) {
  const int d = mmafwd::D;
  zero_rows((bf16*)(smem_raw + L.cls_h), mmafwd::kLd, 0, 16, d);
  for (int i = 0; i + 1 < depth; ++i) {
    mmafwd::block_fwd<kFma>(m, w + 11 * i, n, p, x, smem_raw, L, false);
    mmafwd::round_rows(x, p.r0, n);
    if (xs != nullptr)
      mmafwd::write_rows(x, xs + ((size_t)i * batch + p.f) * n * d, p, n);
  }
  const void* const* last = w + 11 * (depth - 1);
  mmafwd::block_fwd<kFma, kSave>(m, last, n, p, x, smem_raw, L, true, sv);
  mmafwd::cls_mlp<kFma, kSave>(m, last, n, p, x, smem_raw, L, sv, batch);

  // the CLS row x1 + (b2 + MLP), rounded to bf16, then the final norm
  // (warp fl for frame fl)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * mmafwd::kFrames + warp;
  if (warp >= mmafwd::kFrames || f >= batch) return;
  float* x32 = (float*)(smem_raw + L.cls_x1) + warp * d;
  const float* y = (const float*)(smem_raw + L.cls_y) + warp * d;
  for (int c = lane; c < d; c += 32) {
    x32[c] = rt<bf16>(x32[c] + y[c]);
    if (cls != nullptr) cls[(size_t)f * d + c] = fromf<bf16>(x32[c]);
  }
  __syncwarp();
  final_norm_row(x32, w + 11 * depth, final_norm, f);
}

// K4 on the tensor cores (bf16, the flagship widths): the embedded stream
// into the warps' rows, then mma_trunk; kFma: in the body's K4 form (K4's
// route), else every product on the tensor cores (as K1 takes it; K4's
// route does not launch it).
template <bool kFma>
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    trunk_mma_kernel(const __grid_constant__ Args a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const mmafwd::Layout L(a.n);
  const mmafwd::Place p(a.n, batch);
  mmafwd::Rows x;
  mmafwd::read_rows(x, (const bf16*)a.p[0] + (size_t)p.f * a.n * mmafwd::D,
                    p, a.n);
  mma_trunk<kFma, true>(a.m, a.p + 1, a.n, a.depth, a.final_norm, batch, p,
                        x, smem_raw, L, (bf16*)a.xs, (bf16*)a.cls, a.sv);
}

// K1's embedding on the tensor cores, into the warp's rows of the stream
// (rows >= n and frames past the batch zero): row 0 is T(goal + pos[0]);
// row r >= 1 is T(T(patches[r - 1] @ pe_w + pe_b) + pos[r]), the product
// an mma over pd / 16 k-steps in order, its A fragments read from device
// memory (each patch row is read once) and pe_w staged once a thread
// block by cp.async at the front of shared memory (k1_smem sizes it).
// Every thread calls it; it ends on a barrier.
__device__ __forceinline__ void embed_rows(const Args& a, const mmafwd::Place& p,
                                           mmafwd::Rows& x, unsigned char* smem) {
  constexpr int D = mmafwd::D, kLd = mmafwd::kLd;
  const int n = a.n, pd = a.pd, lane = threadIdx.x % 32;
  bf16* w = (bf16*)smem;
  stage_rows(w, kLd, (const bf16*)a.p[2], D, pd, D);
  cp_async_commit();
  const bf16* patches = (const bf16*)a.p[0] + (size_t)p.f * a.n_patch * pd;
  const int ra = p.r0 + lane / 4, rb = ra + 8, t = lane % 4;
  const bool la = p.live && ra >= 1 && ra < n,
             lb = p.live && rb >= 1 && rb < n;
  const uint32_t* pa = (const uint32_t*)(patches + (size_t)(ra - 1) * pd);
  const uint32_t* pb = (const uint32_t*)(patches + (size_t)(rb - 1) * pd);
  float acc[8][4];
  mmafwd::zero(acc);
  cp_async_wait<0>();
  __syncthreads();  // pe_w in place
  for (int kk = 0; kk < pd / 16; ++kk) {
    const int c = (16 * kk + 2 * t) / 2;  // in 32-bit words
    const uint32_t af[4] = {la ? __ldg(pa + c) : 0u, lb ? __ldg(pb + c) : 0u,
                            la ? __ldg(pa + c + 4) : 0u,
                            lb ? __ldg(pb + c + 4) : 0u};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      load_b_kn(b, w, kLd, 8 * j, 16 * kk);
      mma_bf16(acc[j], af, b[0], b[1]);
      mma_bf16(acc[j + 1], af, b[2], b[3]);
    }
  }
  const bf16* goal = (const bf16*)a.p[1] + (size_t)p.f * D;
  const bf16* pe_b = (const bf16*)a.p[3];
  const bf16* pos = (const bf16*)a.p[4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mmafwd::row_of(p.r0, e), c = mmafwd::col_of(j, e);
      float v = 0.f;
      if (p.live && r == 0)
        v = rt<bf16>(tof(goal[c]) + tof(pos[c]));
      else if (p.live && r < n)
        v = rt<bf16>(rt<bf16>(acc[j][e] + tof(pe_b[c])) +
                     tof(pos[(size_t)r * D + c]));
      x[j][e] = v;
    }
  __syncthreads();  // every warp is done with pe_w
}

// K1 on the tensor cores (bf16, the flagship widths): embed_rows, then
// mma_trunk with every product on the tensor cores.
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    k1_mma_kernel(const __grid_constant__ Args a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const mmafwd::Layout L(a.n);
  const mmafwd::Place p(a.n, batch);
  mmafwd::Rows x;
  embed_rows(a, p, x, smem_raw);
  mma_trunk<false>(a.m, a.p + 5, a.n, a.depth, a.final_norm, batch, p, x,
                   smem_raw, L, nullptr, nullptr);
}

// ---------------------------------------------------------------------
// K1 over a thread-block cluster (bf16, the flagship widths, 4 heads):
// one frame a cluster of kRanks CTAs on neighbouring SMs, for batches
// that leave SMs idle in the two-frames-a-block form. Every CTA holds the
// whole frame's stream (16 rows a warp, in registers) and computes the
// LayerNorms itself; rank r computes head r (its q|k|v slice of wqkv, its
// attention and its out-projection partial) and the MLP hidden columns
// [r mlp / 4, (r + 1) mlp / 4) (its w1 and w2 slices). Each rank writes its
// fp32 partial into its own shared memory; after cluster.sync() every
// rank reads the kRanks partials through map_shared_rank and adds them in
// rank order, so every rank holds the same fp32 stream, rounded at the
// same points. The out-projection is summed in head order from zero, as
// the single-CTA body (k1_mma_kernel) sums it, so that sum is the same bit
// for bit; the MLP output is b2 + y_0 + ... + y_3 (y_r a rank's chunks
// summed in order), another association than the single body's b2 +
// chunk by chunk.

namespace cl {

namespace cg = cooperative_groups;
using cl32::add_parts;
using cl32::kPart;
using cl32::kRanks;
using cl32::put_part;

struct Layout {
  size_t k, v, wq, wo, ring, part_a, part_m, cls, total;
  __host__ __device__ Layout(int n, int pd) {
    using mmafwd::D;
    using mmafwd::kLd;
    const size_t np = round16(n), tile = sizeof(bf16) * np * kLd,
                 w64 = sizeof(bf16) * D * kLd;
    size_t o = 0;
    k = mmafwd::take(o, tile);  // the head's k and v of every row
    v = mmafwd::take(o, tile);
    wq = mmafwd::take(o, sizeof(bf16) * D * mmafwd::kLdQkv);
    wo = mmafwd::take(o, w64);
    const size_t attn = o;
    o = 0;
    ring = mmafwd::take(o, mmafwd::kStages * 2 * w64);  // w1, w2 chunks
    const size_t embed = align16(sizeof(bf16) * pd * kLd);  // pe_w first
    o = o > attn ? o : attn;
    o = o > embed ? o : embed;
    const size_t part = sizeof(float) * (np / 16) * kPart;
    part_a = mmafwd::take(o, part);  // the out-projection partials
    part_m = mmafwd::take(o, part);  // the MLP partials
    cls = mmafwd::take(o, sizeof(float) * D);  // the CLS row, rounded
    total = o;
  }
};

// y (zeroed by the caller) += the MLP on h2 over hidden chunks [c0, c0 +
// nc) of HC columns, each chunk from a zero accumulator as mlp_run<false>
// sums it; the chunks pass through a kStages ring. Every thread calls it;
// only `active` warps compute.
__device__ __forceinline__ void mlp_part(unsigned char* smem, const Layout& L,
                                         const mmafwd::Weights& w, int mlp,
                                         int c0, int nc,
                                         const mmafwd::Frag& h2,
                                         float (&y)[8][4], bool active) {
  using mmafwd::D;
  using mmafwd::HC;
  using mmafwd::kLd;
  constexpr int kStages = mmafwd::kStages;
  const int t = threadIdx.x % 4;
  auto stage = [&](int i) {
    bf16* s = (bf16*)(smem + L.ring) + i % kStages * 2 * D * kLd;
    stage_rows(s, kLd, w.w1 + (c0 + i) * HC, mlp, D, HC);
    stage_rows(s + D * kLd, kLd, w.w2 + (size_t)(c0 + i) * HC * D, D, HC, D);
    cp_async_commit();
  };
  stage(0);
  if (nc > 1) stage(1);
  for (int i = 0; i < nc; ++i) {
    if (i + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk i landed; every warp is done with i - 1
    if (i + 2 < nc) stage(i + 2);
    if (!active) continue;
    const bf16* w1c = (const bf16*)(smem + L.ring) + i % kStages * 2 * D * kLd;
    const bf16* w2c = w1c + D * kLd;
    const bf16* b1 = w.b1 + (c0 + i) * HC;
    float part[8][4];
    mmafwd::zero(part);
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
        const float c0f = tof(b1[col]), c1f = tof(b1[col + 1]);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = rt<bf16>(gelu<bf16>(pre[j][e] + (e % 2 ? c1f : c0f)));
        hid[2 * j] = pack_bf16(v[0], v[1]);
        hid[2 * j + 1] = pack_bf16(v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        load_b_kn(b, w2c, kLd, 8 * j, 16 * kk);
        mma_bf16(part[j], hid, b[0], b[1]);
        mma_bf16(part[j + 1], hid, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += part[j][e];
  }
}

// One pre-norm block of the cluster's frame on the warp's rows: x holds
// the fp32 stream on entry and the block's output (unrounded) on return.
// With cls_only only the warp of row 0 runs q, attention, the
// out-projection and the MLP, and only its row 0 is the block's output.
// Every thread of every CTA of the cluster calls it.
__device__ __forceinline__ void block(cg::cluster_group& cluster,
                                      const Dims& m, const void* const* wp,
                                      int n, int rank, int r0,
                                      mmafwd::Rows& x, unsigned char* smem,
                                      const Layout& L, bool cls_only) {
  using mmafwd::D;
  using mmafwd::kLd;
  const mmafwd::Weights w(wp);
  const int inner = m.heads * D, np = round16(n);
  bf16* ks = (bf16*)(smem + L.k);
  bf16* vs = (bf16*)(smem + L.v);
  bf16* wq = (bf16*)(smem + L.wq);
  bf16* wo = (bf16*)(smem + L.wo);
  const bool queries = !cls_only || r0 == 0;
  __syncthreads();  // the previous block's readers of the tiles are done
  for (int part = 0; part < 3; ++part)
    stage_rows(wq + part * D, mmafwd::kLdQkv, w.wqkv + part * inner + rank * D,
               3 * inner, D, D);
  stage_rows(wo, kLd, w.wout + (size_t)rank * D * D, D, D, D);
  cp_async_commit();
  mmafwd::Frag h1;
  mmafwd::norm_frag(x, w.an_s, w.an_b, r0, n, h1);
  cp_async_wait<0>();
  __syncthreads();  // the head's weights landed
  mmafwd::Frag q;
  mmafwd::project<false>(h1, wq, ks, vs, nullptr, r0, queries, q);
  __syncthreads();  // the head's k and v of every row are in place
  float acc[8][4];
  mmafwd::zero(acc);
  if (queries) {
    mmafwd::Frag o;
    mmafwd::attend_head(q, ks, vs, n, np, m.scale, o);
    mmafwd::frag_mma<8>(acc, o, wo, kLd, 0);
    put_part(acc, (float*)(smem + L.part_a));
  }
  cluster.sync();  // every rank's head partial is in place
  if (queries) {
    float x1[8][4];
    mmafwd::zero(x1);
    add_parts(cluster, (float*)(smem + L.part_a), x1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = x[j][e] + (x1[j][e] + tof(w.bout[mmafwd::col_of(j, e)]));
  }
  const int quarter = m.mlp / kRanks;
  mmafwd::Frag h2;
  if (queries) mmafwd::norm_frag(x, w.fn_s, w.fn_b, r0, n, h2);
  float y[8][4];
  mmafwd::zero(y);
  mlp_part(smem, L, w, m.mlp, rank * quarter / mmafwd::HC,
           quarter / mmafwd::HC, h2, y, queries);
  if (queries) put_part(y, (float*)(smem + L.part_m));
  cluster.sync();  // every rank's MLP partial is in place
  if (queries) {
    float v[8][4];
    mmafwd::bias_rows(v, w.b2);
    add_parts(cluster, (float*)(smem + L.part_m), v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] += v[j][e];
  }
}

}  // namespace cl

// K1 over a cluster of cl::kRanks CTAs a frame: embed_rows on every rank,
// the blocks (the stream rounded to bf16 between them), the CLS block,
// and the final norm of the rounded CLS row on rank 0.
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    k1_cluster_kernel(const __grid_constant__ Args a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl::cg::cluster_group cluster = cl::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank();
  const cl::Layout L(n, a.pd);
  mmafwd::Place p(n, batch);
  p.fl = 0;
  p.f = blockIdx.x / cl::kRanks;
  p.r0 = threadIdx.x / 32 * 16;
  p.live = p.f < batch;
  mmafwd::Rows x;
  embed_rows(a, p, x, smem_raw);
  const void* const* w = a.p + 5;
  for (int i = 0; i < a.depth; ++i) {
    const bool last = i + 1 == a.depth;
    cl::block(cluster, a.m, w + 11 * i, n, rank, p.r0, x, smem_raw, L, last);
    if (!last) mmafwd::round_rows(x, p.r0, n);
  }
  if (rank == 0 && threadIdx.x < 4) {  // row 0: lanes 0-3, registers 0, 1
    float* row = (float*)(smem_raw + L.cls);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[mmafwd::col_of(j, e)] = rt<bf16>(x[j][e]);
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x < 32)
    final_norm_row((const float*)(smem_raw + L.cls), w + 11 * a.depth,
                   a.final_norm, p.f);
  cluster.sync();  // no rank leaves while another reads its partials
}

// ---------------------------------------------------------------------
// K1 in fp32 over a thread-block cluster (the flagship widths, 4 heads):
// k1_cluster_kernel's partition with every product on the tensor cores
// as 3xTF32 accumulated there (cl32::Fast), on the fp32 cluster block
// body of tf32_block.cuh (namespace cl32, which K2's fp32 forms share
// with their own sums, cl32::Exact). It
// replaces trunk_kernel<float, true> at these widths while the batch
// leaves SMs idle (k1_form_for in ops/got_megakernel.py): the FMA kernel
// runs a frame on one SM, one product after another. The embedding (64
// patches x pd -> 64) is split
// too: rank r computes columns [16 r, 16 r + 16) of every row (patches
// read from device memory, its pe_w slice staged), adds pe_b and pos,
// and every rank gathers the four slices of its rows through distributed
// shared memory. A rank reads 1.3 MB of weights a frame, all from L2.
// chip_smoke.py holds it to F32_TOL.

namespace cl32 {

// The embedding of the cluster's frame f into the warp's rows x (rows >= n
// zero): row 0 is goal + pos[0]; row r >= 1 is (patches[r - 1] @ pe_w +
// pe_b) + pos[r]. This rank forms columns [16 rank, 16 rank + 16) of every
// row into its emb tile; after cluster.sync() every rank reads the four
// slices of its rows. Every thread of every CTA calls it.
__device__ __forceinline__ void embed(cg::cluster_group& cluster,
                                      const Args& a, int f, int rank,
                                      int r0, mmafwd::Rows& x,
                                      unsigned char* smem, const Layout& L) {
  const int n = a.n, pd = a.pd, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
  float* pe = (float*)(smem + L.pe);
  stage(pe, kLdPe, (const float*)a.p[2] + rank * kEmbCols, D, pd, kEmbCols);
  cp_async_commit();
  const float* patches = (const float*)a.p[0] + (size_t)f * a.n_patch * pd;
  const int ra = r0 + g, rb = ra + 8;
  const bool la = ra >= 1 && ra < n, lb = rb >= 1 && rb < n;
  const float* pa = patches + (size_t)(ra - 1) * pd + 2 * t;
  const float* pb = patches + (size_t)(rb - 1) * pd + 2 * t;
  float acc[2][4] = {};
  cp_async_wait<0>();
  __syncthreads();  // the pe_w slice landed
  for (int k0 = 0; k0 < pd; k0 += 8) {
    const float2 va = la ? __ldg(reinterpret_cast<const float2*>(pa + k0))
                         : make_float2(0.f, 0.f);
    const float2 vb = lb ? __ldg(reinterpret_cast<const float2*>(pb + k0))
                         : make_float2(0.f, 0.f);
    tf32::A af;
    tf32::frag(af, va.x, vb.x, va.y, vb.y);
    const float* w0 = pe + (k0 + 2 * t) * kLdPe + g;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      prod<Fast>(acc[j], af, w0[8 * j], w0[kLdPe + 8 * j]);
  }
  const float* goal = (const float*)a.p[1] + (size_t)f * D;
  const float* pe_b = (const float*)a.p[3];
  const float* pos = (const float*)a.p[4];
  float* emb = (float*)(smem + L.emb);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mmafwd::row_of(r0, e), cl = 8 * j + 2 * t + (e & 1),
                c = rank * kEmbCols + cl;
      float v = 0.f;
      if (r == 0)
        v = goal[c] + pos[c];
      else if (r < n)
        v = (acc[j][e] + pe_b[c]) + pos[(size_t)r * D + c];
      emb[r * kEmbCols + cl] = v;
    }
  cluster.sync();  // every rank's columns are in place
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = mmafwd::col_of(j, e);
      const float* src = cluster.map_shared_rank(emb, c / kEmbCols);
      x[j][e] = src[mmafwd::row_of(r0, e) * kEmbCols + c % kEmbCols];
    }
}

}  // namespace cl32

// K1 in fp32 over a cluster of cl32::kRanks CTAs a frame: the split
// embedding, the blocks, the CLS block, and the final norm of the CLS row
// on rank 0.
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    k1_cluster_fp32_kernel(const __grid_constant__ Args a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank();
  const cl32::Layout L(n, a.pd);
  const int f = blockIdx.x / cl32::kRanks, r0 = threadIdx.x / 32 * 16;
  mmafwd::Rows x;
  cl32::embed(cluster, a, f, rank, r0, x, smem_raw, L);
  const void* const* w = a.p + 5;
  for (int i = 0; i < a.depth; ++i)
    cl32::block<cl32::Fast>(cluster, a.m, w + 11 * i, n, rank, r0, x,
                            smem_raw, L, i + 1 == a.depth);
  if (rank == 0 && threadIdx.x < 4) {  // row 0: lanes 0-3, registers 0, 1
    float* row = (float*)(smem_raw + L.cls);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) row[mmafwd::col_of(j, e)] = x[j][e];
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x < 32)
    final_norm_row<float>((const float*)(smem_raw + L.cls), w + 11 * a.depth,
                          a.final_norm, f);
  cluster.sync();  // no rank leaves while another reads its tiles
}

// K4 in fp32 over a cluster of cl32::kRanks CTAs a frame:
// k1_cluster_fp32_kernel from the blocks on. Each warp reads its 16 rows
// of the frame's embedded fp32 stream from device memory (the frame read
// once, 16.6 KB at 65 rows), then the blocks on the same body, the CLS
// block, and the final norm of the CLS row on rank 0. It sums as K2f does
// (cl32::Exact): with K1's 3xTF32 accumulated on the tensor cores
// (cl32::Fast), which round toward zero as they add, the latent drifted
// 5x further from float64 sums than the FMA body's, as far as a tanh GELU
// in every block (chip_smoke.py's phase 5 in chip_draws.py's draws of
// seeds 7-11 on an H100). It writes no streams: a forward that autograd
// records takes the FMA trunk_kernel, whose streams K6's FMA bodies
// differentiate.
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    k4_cluster_fp32_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank();
  const cl32::Layout L(n, 0);
  const int f = blockIdx.x / cl32::kRanks, r0 = threadIdx.x / 32 * 16;
  mmafwd::Rows x;
  cl32::read_rows(x, (const float*)a.p[0] + (size_t)f * n * cl32::D, cl32::D,
                  r0, n);
  const void* const* w = a.p + 1;
  for (int i = 0; i < a.depth; ++i)
    cl32::block<cl32::Exact>(cluster, a.m, w + 11 * i, n, rank, r0, x,
                             smem_raw, L, i + 1 == a.depth);
  if (rank == 0 && threadIdx.x < 4) {  // row 0: lanes 0-3, registers 0, 1
    float* row = (float*)(smem_raw + L.cls);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) row[mmafwd::col_of(j, e)] = x[j][e];
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x < 32)
    final_norm_row<float>((const float*)(smem_raw + L.cls), w + 11 * a.depth,
                          a.final_norm, f);
  cluster.sync();  // no rank leaves while another reads its tiles
}

// Bytes of K1's launch in form `form` (0 the FMA trunk_kernel, 1
// k1_mma_kernel, 2 a CTA of k1_cluster_kernel, 3 a CTA of
// k1_cluster_fp32_kernel) for n rows and patches of pd values.
size_t k1_bytes(int dtype, int n, int pd, const Dims& m, int form) {
  if (form == 0)
    return dtype == 1 ? Smem<__nv_bfloat16>(n, m.d, m.heads, m.dh, m.hc).total
                      : Smem<float>(n, m.d, m.heads, m.dh, m.hc).total;
  if (form == 2) return cl::Layout(n, pd).total;
  if (form == 3) return cl32::Layout(n, pd).total;
  const size_t body = mmafwd::Layout(n).total,
               pe_w = align16(sizeof(bf16) * pd * mmafwd::kLd);
  return body > pe_w ? body : pe_w;
}

template <typename T>
int launch(bool embed, const Args& a, int batch, cudaStream_t stream) {
  const Smem<T> L(a.n, a.m.d, a.m.heads, a.m.dh, a.m.hc);
  return embed ? launch_smem(trunk_kernel<T, true>, batch, L.total, stream, a)
               : launch_smem(trunk_kernel<T, false>, batch, L.total, stream,
                             a);
}

Args make_args(const void* const* ptrs, int n_ptrs, int n, int d, int heads,
               int dim_head, int mlp, int depth, int final_norm,
               float scale) {
  Args a;
  for (int i = 0; i < n_ptrs; ++i) a.p[i] = ptrs[i];
  a.xs = a.cls = nullptr;
  a.n = n;
  a.depth = depth;
  a.final_norm = final_norm;
  a.m.d = d;
  a.m.heads = heads;
  a.m.dh = dim_head;
  a.m.mlp = mlp;
  a.m.hc = mlp < 256 ? mlp : 256;
  a.m.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// K1. dtype: 0 = fp32, 1 = bf16 compute. ptrs: patches (B, n_patch, pd),
// goal (B, d), pe_w (pd, d), pe_b (d), pos (n_patch+1, d), 11 per block in
// the fused-transformer order, fn_s (d) fp32, fn_b (d) fp32, out (B, d).
// final_norm: 0 = rms, 1 = layer. form: 0 the FMA trunk_kernel (any
// width); 1 k1_mma_kernel, two frames a thread block; 2 k1_cluster_kernel,
// one frame a cluster of 4 CTAs; 3 k1_cluster_fp32_kernel, the same
// partition in fp32. Forms 1 to 3 take d = dim_head = 64, n <= 80, mlp a
// multiple of 64 and 16-byte aligned patches and matrix weights; forms 1
// and 2 bf16 and pd a multiple of 16; form 2 also 4 heads and mlp a
// multiple of 256; form 3 fp32, 4 heads, mlp a multiple of 256, pd a
// multiple of 8 whose staged pe_w slice fits under the rest of its
// layout (cudaErrorInvalidValue else). Returns a cudaError_t (0 =
// launched).
int got_forward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                       int batch, int n_patch, int pd, int d, int heads,
                       int dim_head, int mlp, int depth, int final_norm,
                       float scale, void* stream, int form) {
  if (depth < 1 || depth > kMaxDepth || n_ptrs != 8 + 11 * depth ||
      batch < 1 || form < 0 || form > 3)
    return cudaErrorInvalidValue;
  Args a = make_args(ptrs, n_ptrs, n_patch + 1, d, heads, dim_head, mlp,
                     depth, final_norm, scale);
  a.n_patch = n_patch;
  a.pd = pd;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0)
    return dtype == 1 ? launch<__nv_bfloat16>(true, a, batch, s)
                      : launch<float>(true, a, batch, s);
  const int mats[4] = {2, 3, 7, 9};  // wqkv, wout, w1, w2
  const void* aligned[2 + 4 * kMaxDepth];
  aligned[0] = a.p[0];
  aligned[1] = a.p[2];
  for (int i = 0; i < depth; ++i)
    for (int j = 0; j < 4; ++j)
      aligned[2 + 4 * i + j] = a.p[5 + 11 * i + mats[j]];
  if (!mmafwd::takes(a.n, a.m, aligned, 2 + 4 * depth))
    return cudaErrorInvalidValue;
  const size_t bytes = k1_bytes(dtype, a.n, pd, a.m, form);
  if (form == 3) {
    if (dtype != 0 || pd % 8 != 0 || heads != cl::kRanks ||
        mlp % (cl::kRanks * cl32::HC) != 0 ||
        bytes > k1_bytes(dtype, a.n, 0, a.m, form))
      return cudaErrorInvalidValue;
    return cl32::launch(k1_cluster_fp32_kernel, a.n, batch, bytes, s, a,
                        batch);
  }
  if (dtype != 1 || pd % 16 != 0 ||
      (form == 2 && (heads != cl::kRanks ||
                     mlp % (cl::kRanks * mmafwd::HC) != 0)))
    return cudaErrorInvalidValue;
  if (form == 2)
    return cl32::launch(k1_cluster_kernel, a.n, batch, bytes, s, a, batch);
  return mmafwd::launch_fwd(k1_mma_kernel, a.n, batch, bytes, s, a, batch);
}

// Bytes of dynamic shared memory a block of K1 asks for in `form` (as
// got_forward_launch) at these shapes.
size_t k1_smem(int dtype, int n, int pd, int d, int heads, int dim_head,
               int mlp, int form) {
  Dims m;
  m.d = d;
  m.heads = heads;
  m.dh = dim_head;
  m.mlp = mlp;
  m.hc = mlp < 256 ? mlp : 256;
  return k1_bytes(dtype, n, pd, m, form);
}

// Bytes of dynamic shared memory of K1 (mma = 0) or K4 for these shapes;
// mma = 1 (or 2): K4 on the tensor-core body; 3: a CTA of K4's fp32
// cluster form.
size_t got_forward_smem(int dtype, int n, int d, int heads, int dim_head,
                        int mlp, int mma) {
  if (mma == 3) return cl32::Layout(n, 0).total;
  if (mma) return mmafwd::Layout(n).total;
  const int hc = mlp < 256 ? mlp : 256;
  return dtype == 1 ? Smem<__nv_bfloat16>(n, d, heads, dim_head, hc).total
                    : Smem<float>(n, d, heads, dim_head, hc).total;
}

// K4. ptrs: x (B, n, d) embedded stream, 11 per block, fn_s (d) fp32,
// fn_b (d) fp32, out (B, d). Other arguments as got_forward_launch. mma =
// 1 runs the bf16 tensor-core body in its K4 form (K4's route), mma = 2 the
// same body with every product on the tensor cores (no route takes it; for
// measurement); both take bf16, d = dim_head = 64, n <= 80, mlp a multiple
// of 64 and 16-byte aligned x and matrix weights (cudaErrorInvalidValue
// else); mma = 3 k4_cluster_fp32_kernel, one frame over a cluster of 4
// CTAs, which takes fp32 at those widths with 4 heads, mlp a multiple of
// 256 and null streams (cudaErrorInvalidValue else); mma = 0 the FMA
// body, any width. xs, cls and saved: all null, or the streams the bodies
// but the fp32 cluster's then write: each full block's rounded output
// (depth - 1, B, n, d) and the rounded CLS row before the final norm (B,
// d), in the compute dtype, and the CLS block's records (B, ClsSave
// stride) fp32, which K6 (trunk_backward_launch) differentiates.
int blocks_forward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, int depth, int final_norm, float scale,
                          void* stream, int mma, void* xs, void* cls,
                          void* saved) {
  if (depth < 1 || depth > kMaxDepth || n_ptrs != 4 + 11 * depth ||
      batch < 1 || n < 1 || (xs == nullptr) != (cls == nullptr) ||
      (xs == nullptr) != (saved == nullptr))
    return cudaErrorInvalidValue;
  Args a = make_args(ptrs, n_ptrs, n, d, heads, dim_head, mlp, depth,
                     final_norm, scale);
  a.xs = xs;
  a.cls = cls;
  a.sv = ClsSave((float*)saved, n, d, heads, dim_head, mlp);
  cudaStream_t s = (cudaStream_t)stream;
  if (mma < 0 || mma > 3) return cudaErrorInvalidValue;
  if (mma) {
    const int mats[4] = {2, 3, 7, 9};  // wqkv, wout, w1, w2
    const void* aligned[1 + 4 * kMaxDepth];
    aligned[0] = a.p[0];
    for (int i = 0; i < depth; ++i)
      for (int j = 0; j < 4; ++j)
        aligned[1 + 4 * i + j] = a.p[1 + 11 * i + mats[j]];
    if (!mmafwd::takes(n, a.m, aligned, 1 + 4 * depth))
      return cudaErrorInvalidValue;
    if (mma == 3) {
      if (dtype != 0 || heads != cl32::kRanks ||
          mlp % (cl32::kRanks * cl32::HC) != 0 || xs != nullptr)
        return cudaErrorInvalidValue;
      return cl32::launch(k4_cluster_fp32_kernel, n, batch,
                          cl32::Layout(n, 0).total, s, a);
    }
    if (dtype != 1) return cudaErrorInvalidValue;
    return mma == 1 ? mmafwd::launch_fwd(trunk_mma_kernel<true>, n, batch,
                                         mmafwd::Layout(n).total, s, a, batch)
                    : mmafwd::launch_fwd(trunk_mma_kernel<false>, n, batch,
                                         mmafwd::Layout(n).total, s, a,
                                         batch);
  }
  return dtype == 1 ? launch<__nv_bfloat16>(false, a, batch, s)
                    : launch<float>(false, a, batch, s);
}

const char* got_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
