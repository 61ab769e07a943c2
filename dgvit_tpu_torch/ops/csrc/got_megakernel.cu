// Whole-trunk GoT forwards: K1 (embed + trunk) and K4 (trunk of an
// already embedded stream), two instantiations of one CUDA kernel.
//
// K1 replaces dgvit_tpu/ops/got_megakernel.py::_mega_kernel (the Pallas
// TPU kernel behind got_forward_fused). Per frame it computes
//   patch-embed matmul + bias -> goal token prepended -> + positional
//   embedding -> depth-1 full pre-norm blocks -> a final block for the CLS
//   (goal) row only -> final RMS or Layer norm.
// K4 replaces _blocks_kernel (blocks_cls_forward_fused): the same trunk
// from the blocks on, for the no-grad forwards whose embedding and
// emb-dropout ran outside the kernel.
// Numerics are the TPU kernels' (block_common.cuh); the residual stream
// is rounded to the compute dtype T after every block.
//
// What bounds it on an H100: at the flagship width a frame costs about
// 150 MFLOP over its 65 tokens and reads 41 KB of bf16 patches (K4: 8 KB
// of stream), so the work is compute-bound from a few dozen frames up and
// launch/latency-bound at one frame, where a single thread block runs the
// whole trunk serially.
//
// Design of trunk_kernel (K1; K4 in fp32 and off the flagship widths): one
// thread block of 256 threads per frame. The fp32 residual stream, the
// normed activations, one head's q/k/v rows, the attention output and one
// MLP hidden chunk all live in dynamic shared memory (about 100 KB in
// bf16, 165 KB in fp32), so no activation touches device memory between
// the input read and the (64,) latent write. Weights are read from device
// memory, where the whole parameter set (2.7 MB in bf16) stays in the 50
// MB L2. Matrix products are plain fp32 FMA loops with a register tile of
// 8 rows per thread, which reuses each weight element eight times; padded
// token rows (65 -> 72 on the TPU) are never computed. So a frame holds
// at most 147 tokens in bf16 and 89 in fp32 at the flagship widths
// (got_forward_smem exports the bytes; ops/smem.py routes longer frames
// to the composed blocks).
//
// trunk_mma_kernel (the bf16 K4 at the flagship widths, tensor_core_fwd in
// ops/fused_transformer.py) runs the blocks on block_mma_fwd.cuh's body in
// its K4 form (the qkv projection, the MLP's first product and P.V on the
// tensor cores; the scores, the out-projection and the MLP's second
// product as the FMA body's fp32 chains): two frames a thread block, each
// warp holding 16 rows of the stream in registers through all four
// blocks, the CLS block's k/v projection over every row on the tensor
// cores as well, and its MLP on one 16-row tile of the frames' CLS rows
// (one warp). K1 keeps trunk_kernel.

#include "block_common.cuh"
#include "block_mma_fwd.cuh"

namespace {

constexpr int kMaxDepth = 16;
constexpr int kMaxPtrs = 5 + 11 * kMaxDepth + 3;

struct Args {
  // K1: patches, goal, pe_w, pe_b, pos, 11 per block, fn_s, fn_b, out
  // K4: x, 11 per block, fn_s, fn_b, out
  const void* p[kMaxPtrs];
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
    block<T>(a.m, a.p + kBlocks + 11 * i, n, last, x32, acc, prob, h,
             scratch);
    // the residual stream round-trips the compute dtype between blocks
    const int rows = last ? 1 : n;
    for (int j = threadIdx.x; j < rows * d; j += blockDim.x)
      x32[j] = rt<T>(x32[j]);
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

// K4 on the tensor cores (bf16, the flagship widths): the depth-1 full
// blocks and the CLS-only block on block_mma_fwd.cuh's body (its K4
// form), two frames a thread block and 16 rows a warp, the stream in
// registers throughout and rounded to bf16 between blocks; then the final
// norm of each CLS row.
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    trunk_mma_kernel(const __grid_constant__ Args a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = mmafwd::D, depth = a.depth;
  const mmafwd::Layout L(n);
  const mmafwd::Place p(n, batch);
  mmafwd::Rows x;
  mmafwd::read_rows(x, (const bf16*)a.p[0] + (size_t)p.f * n * d, p, n);
  zero_rows((bf16*)(smem_raw + L.cls_h), mmafwd::kLd, 0, 16, d);
  for (int i = 0; i + 1 < depth; ++i) {
    mmafwd::block_fwd<true>(a.m, a.p + 1 + 11 * i, n, p, x, smem_raw, L,
                            false);
    mmafwd::round_rows(x, p.r0, n);
  }
  const void* const* last = a.p + 1 + 11 * (depth - 1);
  mmafwd::block_fwd<true>(a.m, last, n, p, x, smem_raw, L, true);
  mmafwd::cls_mlp<true>(a.m, last, n, p, x, smem_raw, L);

  // the CLS row x1 + (b2 + MLP), rounded to bf16, then the final norm
  // (warp fl for frame fl)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * mmafwd::kFrames + warp;
  if (warp >= mmafwd::kFrames || f >= batch) return;
  const float* fn_s = (const float*)a.p[1 + 11 * depth];
  const float* fn_b = (const float*)a.p[2 + 11 * depth];
  bf16* out = (bf16*)a.p[3 + 11 * depth] + (size_t)f * d;
  float* x32 = (float*)(smem_raw + L.cls_x1) + warp * d;
  const float* y = (const float*)(smem_raw + L.cls_y) + warp * d;
  for (int c = lane; c < d; c += 32) x32[c] = rt<bf16>(x32[c] + y[c]);
  __syncwarp();
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
      out[c] = fromf<bf16>(x32[c] / norm * sd * fn_s[c]);
  } else {
    const float m = sum / d;
    float v = 0.f;
    for (int c = lane; c < d; c += 32) v += (x32[c] - m) * (x32[c] - m);
    const float inv = rsqrtf(warp_sum(v) / d + 1e-5f);
    for (int c = lane; c < d; c += 32)
      out[c] = fromf<bf16>((x32[c] - m) * inv * fn_s[c] + fn_b[c]);
  }
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
// final_norm: 0 = rms, 1 = layer. Returns a cudaError_t (0 = launched).
int got_forward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                       int batch, int n_patch, int pd, int d, int heads,
                       int dim_head, int mlp, int depth, int final_norm,
                       float scale, void* stream) {
  if (depth < 1 || depth > kMaxDepth || n_ptrs != 8 + 11 * depth ||
      batch < 1)
    return cudaErrorInvalidValue;
  Args a = make_args(ptrs, n_ptrs, n_patch + 1, d, heads, dim_head, mlp,
                     depth, final_norm, scale);
  a.n_patch = n_patch;
  a.pd = pd;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<__nv_bfloat16>(true, a, batch, s)
                    : launch<float>(true, a, batch, s);
}

// Bytes of dynamic shared memory of K1 (mma = 0) or K4 for these shapes;
// mma = 1: K4 on the tensor-core body.
size_t got_forward_smem(int dtype, int n, int d, int heads, int dim_head,
                        int mlp, int mma) {
  if (mma) return mmafwd::Layout(n).total;
  const int hc = mlp < 256 ? mlp : 256;
  return dtype == 1 ? Smem<__nv_bfloat16>(n, d, heads, dim_head, hc).total
                    : Smem<float>(n, d, heads, dim_head, hc).total;
}

// K4. ptrs: x (B, n, d) embedded stream, 11 per block, fn_s (d) fp32,
// fn_b (d) fp32, out (B, d). Other arguments as got_forward_launch. mma =
// 1 runs the bf16 tensor-core body, which takes bf16, d = dim_head = 64,
// n <= 80, mlp a multiple of 64 and 16-byte aligned x and matrix weights
// (cudaErrorInvalidValue else); mma = 0 the FMA body, any width.
int blocks_forward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, int depth, int final_norm, float scale,
                          void* stream, int mma) {
  if (depth < 1 || depth > kMaxDepth || n_ptrs != 4 + 11 * depth ||
      batch < 1 || n < 1)
    return cudaErrorInvalidValue;
  Args a = make_args(ptrs, n_ptrs, n, d, heads, dim_head, mlp, depth,
                     final_norm, scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (mma) {
    const int mats[4] = {2, 3, 7, 9};  // wqkv, wout, w1, w2
    const void* aligned[1 + 4 * kMaxDepth];
    aligned[0] = a.p[0];
    for (int i = 0; i < depth; ++i)
      for (int j = 0; j < 4; ++j)
        aligned[1 + 4 * i + j] = a.p[1 + 11 * i + mats[j]];
    if (dtype != 1 || !mmafwd::takes(n, a.m, aligned, 1 + 4 * depth))
      return cudaErrorInvalidValue;
    return mmafwd::launch_fwd(trunk_mma_kernel, n, batch, s, a, batch);
  }
  return dtype == 1 ? launch<__nv_bfloat16>(false, a, batch, s)
                    : launch<float>(false, a, batch, s);
}

const char* got_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
