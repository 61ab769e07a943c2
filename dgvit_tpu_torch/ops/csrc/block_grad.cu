// Kernels of the gradient-bearing GoT trunk: forward and backward of a
// full pre-norm block (K2) and of the CLS-only final block (K3), and the
// backward of the whole trunk in one per-frame pass (K6).
//
// Replaces, in dgvit_tpu/ops:
//   K2f fused_transformer.py::_fused_block_fwd_impl (_block_kernel)
//   K2b fused_transformer.py::_fused_block_bwd_impl (_block_bwd_kernel,
//       body _block_bwd_body)
//   K3f cls_block.py::_cls_fwd_impl (_cls_fwd_kernel)
//   K3b cls_block.py::_cls_bwd_impl (_cls_bwd_kernel, body _cls_bwd_body)
//   K6  trunk_train.py::trunk_bwd_impl (_trunk_bwd_kernel)
//
// Forward: K2f and K3f off the flagship widths and in fp32 run one thread
// block per frame on `block` (block_common.cuh) with the frame's fp32
// stream in shared memory, as K1's FMA kernel does, and write the block's
// output (K2f: every row; K3f: the CLS row) in the compute dtype T. In
// bf16 at the flagship widths (tensor_core_fwd in
// ops/fused_transformer.py) K2f runs block_fwd_mma_kernel and K3f
// cls_fwd_mma_kernel: the tensor-core body of block_mma_fwd.cuh, two
// frames a thread block (K3f: its CLS-only block, as K4 and K1 end). In
// fp32 at the flagship widths with 4 heads (fp32_cluster_fwd) K2f runs
// block_fwd_cluster_fp32_kernel and K2b's pass
// block_bwd_cluster_fp32_kernel: one frame over a cluster of 4 CTAs on
// tf32_block.cuh's 3xTF32 body, K1's fp32 cluster form's (see the
// section "the fp32 forms at the flagship widths" below); K3f and K3b's
// pass run the CLS-only block's row-heavy half the same way and its
// CLS rows' MLP as one product over the batch (the section "K3's fp32
// forms at the flagship widths").
//
// Backward, two passes:
//  1. one thread block per frame recomputes the forward, then runs the
//     reverse pass of `_block_bwd_body` / `_cls_bwd_body` by hand with its
//     rounding points: dy, dpre, g1, do and dqkv are rounded to T before
//     their products, ds after the scale, dv uses the rounded p and ds the
//     unrounded one, the GELU derivative follows the compute dtype. It
//     writes dx, the operands of the four weight-gradient products (h1,
//     dqkv, o, g1, h2, dpre, hid, in T) and its own row sums for the seven
//     vector gradients (fp32).
//  2. the weight gradients summed over every frame: each matrix gradient
//     A^T B over all B*n rows (B rows for the CLS-only operands of K3) is a
//     tiled product split over fixed row segments (on the tensor cores in
//     bf16: wgrad_mma_kernel), each written to its own fp32 partial, then
//     the partials are summed in segment order; each
//     vector gradient sums the frames' row sums in frame order. Both
//     orders are fixed by the shapes, so a gradient is the same from run
//     to run (no atomics). The sums are cast to T at the end, as the TPU
//     kernel casts its fp32 accumulators to the weight dtype.
// The recompute of pass 1 is bit-identical to the forward kernel (same
// products in the same order) for fp32 and for the bf16 FMA bodies; fp32
// at the flagship widths runs the first half of tf32_block.cuh's body
// both ways (chip_smoke.py phase 13b finds K2b's h1, o, h2 and hid equal
// to K2f's on every frame). At the flagship widths the bf16 full block
// runs on the tensor cores both ways, K2f on block_mma_fwd.cuh's body and K2b's recompute in
// block_bwd_mma, with the same bf16 operands, rounding points and tile
// order (chip_smoke.py phase 13b finds K2b's intermediates equal to K2f's
// on every frame). The CLS-only block's backward recomputes only k and v
// of every row (the same products as K3f's), and reads the CLS row's q,
// probabilities, o, x1, h2 and MLP pre-activations from the record its
// forward wrote (ClsSave: K3f, or the last block of every body of K4), so
// it differentiates the CLS row that forward computed, whichever body
// summed it. The body before that repair, which recomputes the CLS row
// as single-row fp32 chains (their sums differ in order from the
// tensor-core forward's and flip a bf16 rounding of q, o, h2 or hid on
// some frames), is kept only in the measurement kernels
// cls_bwd_recompute_kernel and trunk_bwd_recompute_kernel, launched when
// no record is passed, which no route does.
// The TPU pads 65 rows to 72 and masks the padded keys; padded rows carry
// zero gradient there, so computing the 65 real rows is exact.
//
// K6 is the backward of the whole-trunk forward K4 (got_megakernel.cu).
// The TPU kernel sums its weight gradients across a sequential grid; here
// blocks run in no order, so it takes the two passes above: one thread
// block per frame runs the final norm's backward, then the CLS block's and
// the full blocks' per-frame passes in reverse (the bodies of K3b and K2b,
// each dx written in T and read back as the next dy); then every block's
// weight products as above. Its output is K3b and K2b chained. It runs no
// forward: the block inputs and the CLS row are the streams K4 wrote when
// autograd recorded (rounded to T at every block boundary, as K4 rounds
// them), so K6 differentiates the forward that ran, whichever body K4
// took. The TPU kernel recomputes them with its forward's own body, which
// gives the same values there. The TPU kernel's smaller MLP chunk is its
// memory budget, not part of the function: every block here keeps K2b's
// chunk.
//
// What bounds it on an H100: a frame of the full-block backward costs
// about 3x the forward's 47 MFLOP at the flagship width, and the weight
// products 11 GFLOP over 256 frames. At the flagship widths the bf16
// full-block backward body runs its products on the tensor cores
// (block_bwd_mma, below; other widths keep the FMA body): q, k, v
// and do of a head stay in shared memory, weight tiles arrive by
// cp.async, and only the weight products' operands go to the workspace.
// The CLS-only backward body (K3b, and K6's last block) does the same for
// its two products over every row, the k/v recompute and dk|dv wkv^T
// (cls_bwd_mma), and reads the CLS row's forward from its record; its
// single-row backward chains stay on the CUDA cores. The
// bf16 K2f at those widths runs on the tensor cores too
// (block_fwd_mma_kernel), as does K3f (cls_fwd_mma_kernel), and so do the
// bf16 weight products (wgrad_mma_kernel, bound by the bytes of their
// operands). The fp32 full block at the flagship widths runs on the
// tensor cores as 3xTF32 over a cluster of 4 CTAs a frame; the other fp32
// bodies and the fp32 weight products are FMA work on fp32 CUDA cores.
//
// A frame lives in one thread block's shared memory, so each body holds
// frames up to a length (at the flagship widths: the FMA forward 147
// tokens in bf16, 89 in fp32; the backward 110): block_forward_smem,
// block_backward_smem and trunk_backward_smem export the bytes, which
// ops/smem.py mirrors, and the model's routes send longer frames to the
// composed blocks.

#include <type_traits>

#include "block_common.cuh"
#include "block_mma_fwd.cuh"
#include "mma_common.cuh"
#include "tf32_block.cuh"

namespace {

constexpr int kSlots = 11;  // per-frame operand buffers of the backward
constexpr int kTile = 64;   // weight-gradient output tile (K x N)
constexpr int kChunk = 16;  // rows staged in shared memory per step
constexpr int kTargetCtas = 264;
constexpr int kMaxTrunkDepth = 8;  // K6: its arguments hold every block's

struct FwdArgs {
  const void* x;
  const void* w[11];
  void* out;
  ClsSave sv;  // K3f when autograd records: the CLS row's record, else null
  int n;
  Dims m;
};

struct BwdArgs {
  const void* x;
  const void* dy;
  const void* w[11];
  void* dx;
  // slots: 0 h1, 1 qkv (each head's q|k|v side by side; K3: kv), 2 o,
  // 3 h2, 4 hid, 5 dpre, 6 g1, 7 do, 8 dqkv (wqkv's column order; K3: dkv),
  // 9 q (K3), 10 dq (K3); rows of one frame each
  void* s[kSlots];
  float* vec;  // (B, 6 d + mlp): an_s, an_b, bout, fn_s, fn_b, b2, b1 sums
  // K3b and K6's last block: the CLS row's record its forward wrote
  // (ClsSave), read in place of the CLS row's single-row chains. Null only
  // in a measurement of fault k (chip_smoke.py): the body then recomputes
  // them, as it did before, and writes k|v to slot 1.
  ClsSave sv;
  int n;
  Dims m;
};

template <typename T> __device__ __forceinline__ float gelu_grad(float z) {
  if (sizeof(T) == 2) {
    const float z2 = z * z;
    const float inner = 0.7978845608028654f * (z + 0.044715f * z * z2);
    const float t = tanhf(inner);
    const float dinner = 0.7978845608028654f * (1.f + 3.f * 0.044715f * z2);
    return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * dinner;
  }
  const float phi = 0.5f * (1.f + erf32(z * 0.7071067811865476f));
  return phi + z * 0.3989422804014327f * expf(-0.5f * z * z);
}

// Backward of LayerNorm over R rows, given the fp32 grad dh of its output:
// epi(r, c, dx) per element; the scale and bias grads of these rows,
// summed over rows in order, go to gs[c] and gb[c].
template <typename T, typename Epi>
__device__ void ln_bwd(const float* x, const float* mean, const float* rstd,
                       const float* dh, int R, int d, const T* s, float* gs,
                       float* gb, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x + (size_t)r * d;
    const float* dr = dh + (size_t)r * d;
    const float m = mean[r], rs = rstd[r];
    float sd = 0.f, sdx = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (xr[c] - m) * rs;
      const float dxh = dr[c] * tof(s[c]);
      sd += dxh;
      sdx += dxh * xhat;
    }
    const float md = warp_sum(sd) / d, mdx = warp_sum(sdx) / d;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (xr[c] - m) * rs;
      const float dxh = dr[c] * tof(s[c]);
      epi(r, c, rs * (dxh - md - xhat * mdx));
    }
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < R; ++r) {
      const float g = dh[(size_t)r * d + c];
      a += g * ((x[(size_t)r * d + c] - mean[r]) * rstd[r]);
      b += g;
    }
    gs[c] = a;
    gb[c] = b;
  }
}

// column sums over R rows of an fp32 (R, d) buffer, in row order
__device__ void col_sums(const float* x, int R, int d, float* out) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += x[(size_t)r * d + c];
    out[c] = s;
  }
}

template <typename T, bool kCls>
__global__ void __launch_bounds__(kThreads)
    block_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = a.m.d, f = blockIdx.x;
  const Smem<T> L(n, d, a.m.heads, a.m.dh, a.m.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  const T* x = (const T*)a.x + (size_t)f * n * d;
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  block<T, kCls>(a.m, a.w, n, kCls, x32, (float*)(smem_raw + L.acc),
                 (float*)(smem_raw + L.prob), (T*)(smem_raw + L.h),
                 (T*)(smem_raw + L.scratch),
                 kCls && a.sv.base != nullptr ? a.sv.at(f) : nullptr, a.sv);
  const int rows = kCls ? 1 : n;
  T* out = (T*)a.out + (size_t)f * rows * d;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
    out[i] = fromf<T>(x32[i]);
}

// K2f on the tensor cores (bf16, the flagship widths): block_mma_fwd.cuh's
// body on two frames a thread block, each warp owning 16 rows of a frame.
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    block_fwd_mma_kernel(const __grid_constant__ FwdArgs a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  const mmafwd::Layout L(n);
  const mmafwd::Place p(n, batch);
  const size_t frame = (size_t)p.f * n * mmafwd::D;
  mmafwd::Rows x;
  mmafwd::read_rows(x, (const bf16*)a.x + frame, p, n);
  mmafwd::block_fwd<false>(a.m, a.w, n, p, x, smem_raw, L, false);
  mmafwd::write_rows(x, (bf16*)a.out + frame, p, n);
}

// K3f on the tensor cores (bf16, the flagship widths): block_mma_fwd.cuh's
// CLS-only block, as K4 and K1 run their last block, every product on the
// tensor cores: k and v over every row, q, attention and the
// out-projection in the warps that hold row 0, the MLP of both frames' CLS
// rows on warp 0 (cls_mlp); each live frame's x1 + (b2 + MLP) rounded to
// bf16 once. With a record base in a.sv, the CLS rows' records as well.
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    cls_fwd_mma_kernel(const __grid_constant__ FwdArgs a, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = mmafwd::D;
  const mmafwd::Layout L(n);
  const mmafwd::Place p(n, batch);
  mmafwd::Rows x;
  mmafwd::read_rows(x, (const bf16*)a.x + (size_t)p.f * n * d, p, n);
  zero_rows((bf16*)(smem_raw + L.cls_h), mmafwd::kLd, 0, 16, d);
  mmafwd::block_fwd<false, true>(a.m, a.w, n, p, x, smem_raw, L, true, a.sv);
  mmafwd::cls_mlp<false, true>(a.m, a.w, n, p, x, smem_raw, L, a.sv, batch);
  // warp fl writes frame fl's CLS row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * mmafwd::kFrames + warp;
  if (warp >= mmafwd::kFrames || f >= batch) return;
  const float* x1 = (const float*)(smem_raw + L.cls_x1) + warp * d;
  const float* y = (const float*)(smem_raw + L.cls_y) + warp * d;
  bf16* out = (bf16*)a.out + (size_t)f * d;
  for (int c = lane; c < d; c += 32) out[c] = fromf<bf16>(x1[c] + y[c]);
}

// ---------------------------------------------------------------------
// A measurement, not a route: the intermediates of the bf16 tensor-core
// forward body as K2f (block_fwd_mma_kernel) and K3f (cls_fwd_mma_kernel)
// compute them, so that chip_smoke.py can hold K2b's and K3b's recomputes
// (block_bwd_mma, cls_bwd_mma) against the forward that ran. The kernel
// below repeats block_fwd<false> and cls_mlp<false> call by call, on the
// same device functions, and writes each intermediate as the body rounds
// it: h1 (B, n, d), o (B, n, heads d), h2 (B, n, d), hid (B, n, mlp); for
// the CLS-only block o, h2 and hid of the CLS row only, (B, heads d),
// (B, d) and (B, mlp); k and v of every row (B, n, heads d) each. Its
// output is K2f's or K3f's.
struct Probe {
  bf16 *h1, *o, *h2, *hid, *k, *v;
};

// A fragments a of the warp's 16 rows (mmafwd::to_frag's layout) into
// rows r0.. of a bf16 matrix of row stride ld; rows >= n not written
__device__ __forceinline__ void put_frag(const mmafwd::Frag& a, bf16* m,
                                         int ld, int r0, int n) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = r0 + g + 8 * (h & 1), c = 16 * kk + 8 * (h >> 1) + 2 * t;
      if (r < n)
        *reinterpret_cast<uint32_t*>(m + (size_t)r * ld + c) = a[kk][h];
    }
}

// bf16(gelu(h2 @ w1 + b1)) of the warp's 16 rows of A fragments h2, each
// 16-column block summed as mmafwd::mlp_run sums it, w1 staged chunk by
// chunk into the ring, into rows 0 .. rows - 1 of out (row stride ld).
// Every thread calls it; only `active` warps compute.
__device__ __forceinline__ void probe_hid(unsigned char* smem,
                                          const mmafwd::Layout& L,
                                          const mmafwd::Weights& w, int mlp,
                                          const mmafwd::Frag& h2, bool active,
                                          bf16* out, int ld, int rows) {
  using mmafwd::D;
  using mmafwd::HC;
  using mmafwd::kLd;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  bf16* w1c = (bf16*)(smem + L.ring);
  for (int c = 0; c < mlp / HC; ++c) {
    __syncthreads();  // every warp is done with the last chunk
    stage_rows(w1c, kLd, w.w1 + c * HC, mlp, D, HC);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const bf16* b1 = w.b1 + c * HC;
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c * HC + 16 * kk + 8 * j + 2 * t;
        const float c0 = tof(b1[col - c * HC]), c1 = tof(b1[col - c * HC + 1]);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = rt<bf16>(gelu<bf16>(pre[j][e] + (e % 2 ? c1 : c0)));
        if (g < rows)
          *reinterpret_cast<uint32_t*>(out + (size_t)g * ld + col) =
              pack_bf16(v[0], v[1]);
        if (g + 8 < rows)
          *reinterpret_cast<uint32_t*>(out + (size_t)(g + 8) * ld + col) =
              pack_bf16(v[2], v[3]);
      }
    }
  }
}

template <bool kCls>
__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    block_probe_kernel(const __grid_constant__ FwdArgs a, int batch,
                       Probe pr) {
  using namespace mmafwd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  const Dims& m = a.m;
  const Layout L(n);
  const Place p(n, batch);
  const Weights w(a.w);
  const int heads = m.heads, inner = heads * D;
  const size_t fr = (size_t)p.f * n;
  Rows x;
  read_rows(x, (const bf16*)a.x + fr * D, p, n);
  if (kCls) zero_rows((bf16*)(smem_raw + L.cls_h), kLd, 0, 16, D);
  // block_fwd<false>(m, a.w, n, p, x, smem_raw, L, kCls), written out
  bf16* ks = (bf16*)(smem_raw + L.k) + (size_t)p.fl * p.np * kLd;
  bf16* vs = (bf16*)(smem_raw + L.v) + (size_t)p.fl * p.np * kLd;
  bf16* qs = (bf16*)(smem_raw + L.q) + (size_t)p.fl * p.np * kLd;
  const bool queries = !kCls || p.r0 == 0;
  __syncthreads();
  stage_head(smem_raw, L, w, heads, 0);
  cp_async_commit();
  Frag h1;
  norm_frag(x, w.an_s, w.an_b, p.r0, n, h1);
  if (p.live) put_frag(h1, pr.h1 + fr * D, D, p.r0, n);
  float x1[8][4];
  zero(x1);
  for (int hd = 0; hd < heads; ++hd) {
    cp_async_wait<0>();
    __syncthreads();
    if (hd + 1 < heads) {
      stage_head(smem_raw, L, w, heads, hd + 1);
      cp_async_commit();
    }
    const bf16* wq = (const bf16*)(smem_raw + L.wqkv) + (hd & 1) * D * kLdQkv;
    const bf16* wo = (const bf16*)(smem_raw + L.wout) + (hd & 1) * D * kLd;
    Frag q;
    project<false>(h1, wq, ks, vs, qs, p.r0, queries, q);
    __syncthreads();
    if (p.live)  // the warp's rows of this head's k and v
      for (int r = p.r0; r < p.r0 + 16 && r < n; ++r) {
        const int c = 2 * (threadIdx.x % 32);
        const size_t at = (fr + r) * inner + hd * D + c;
        *reinterpret_cast<uint32_t*>(pr.k + at) =
            *reinterpret_cast<const uint32_t*>(ks + (size_t)r * kLd + c);
        *reinterpret_cast<uint32_t*>(pr.v + at) =
            *reinterpret_cast<const uint32_t*>(vs + (size_t)r * kLd + c);
      }
    if (!queries) continue;
    Frag o;
    attend_head(q, ks, vs, n, p.np, m.scale, o);
    if (p.live)
      put_frag(o, kCls ? pr.o + (size_t)p.f * inner + hd * D
                       : pr.o + fr * inner + hd * D,
               inner, p.r0, kCls ? 1 : n);
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
  __syncthreads();
  mlp_begin(smem_raw, L, w, m.mlp);
  if (!kCls) {
    Frag h2;
    norm_frag(x, w.fn_s, w.fn_b, p.r0, n, h2);
    if (p.live) put_frag(h2, pr.h2 + fr * D, D, p.r0, n);
    float y[8][4];
    bias_rows(y, w.b2);
    mlp_run<false>(smem_raw, L, w, m.mlp, m.hc, h2, y, true);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] += y[j][e];
    write_rows(x, (bf16*)a.out + fr * D, p, n);
    const int rows = p.live ? (n - p.r0 < 16 ? n - p.r0 : 16) : 0;
    probe_hid(smem_raw, L, w, m.mlp, h2, true,
              pr.hid + (fr + p.r0) * m.mlp, m.mlp, rows);
    return;
  }
  cls_mlp<false>(m, a.w, n, p, x, smem_raw, L);
  if (p.r0 == 0 && p.live) {  // LN2 of the CLS row, as cls_mlp takes it
    Frag h2;
    norm_frag(x, w.fn_s, w.fn_b, p.r0, n, h2);
    put_frag(h2, pr.h2 + (size_t)p.f * D, D, 0, 1);
  }
  Frag h2c;  // the frames' CLS rows, as cls_mlp's warp 0 reads them
  const bool active = threadIdx.x < 32;
  if (active)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      load_a(h2c[kk], (const bf16*)(smem_raw + L.cls_h), kLd, 0, 16 * kk);
  const int f0 = blockIdx.x * kFrames;
  probe_hid(smem_raw, L, w, m.mlp, h2c, active, pr.hid + (size_t)f0 * m.mlp,
            m.mlp, batch - f0 < kFrames ? batch - f0 : kFrames);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = f0 + warp;
  if (warp >= kFrames || f >= batch) return;
  const float* cx1 = (const float*)(smem_raw + L.cls_x1) + warp * D;
  const float* cy = (const float*)(smem_raw + L.cls_y) + warp * D;
  bf16* out = (bf16*)a.out + (size_t)f * D;
  for (int c = lane; c < D; c += 32) out[c] = fromf<bf16>(cx1[c] + cy[c]);
}

// Shared memory of the backward kernels (fp32 throughout).
struct BwdSmem {
  size_t x32, x1, acc, g1, stats, pb, dpb, prob, total;
  __host__ __device__ BwdSmem(int n, int d, int hc) {
    const size_t nd = sizeof(float) * n * d;
    x32 = 0;
    x1 = align16(x32 + nd);
    acc = align16(x1 + nd);
    g1 = align16(acc + nd);
    stats = align16(g1 + nd);
    pb = align16(stats + sizeof(float) * 4 * n);
    dpb = align16(pb + sizeof(float) * n * (n > hc ? n : hc));
    prob = align16(dpb + sizeof(float) * n * (n > hc ? n : hc));
    total = align16(prob + sizeof(float) * kWarps * n);
  }
};

// The per-frame pass of a full block's backward for frame f, on one thread
// block: the body of K2b's kernel and of each full block of K6's.
template <typename T>
__device__ __forceinline__ void block_bwd_body(const BwdArgs& a, int f,
                                               unsigned char* smem_raw) {
  const Dims m = a.m;
  const int n = a.n, d = m.d, dh = m.dh, inner = m.heads * dh,
            i3 = 3 * inner, mlp = m.mlp;
  const BwdSmem L(n, d, m.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  float* x1 = (float*)(smem_raw + L.x1);
  float* acc = (float*)(smem_raw + L.acc);
  float* g1 = (float*)(smem_raw + L.g1);
  float* mean1 = (float*)(smem_raw + L.stats);
  float* rstd1 = mean1 + n;
  float* mean2 = rstd1 + n;
  float* rstd2 = mean2 + n;
  float* pb = (float*)(smem_raw + L.pb);
  float* dpb = (float*)(smem_raw + L.dpb);
  float* prob = (float*)(smem_raw + L.prob);
  const T* an_s = (const T*)a.w[0];
  const T* an_b = (const T*)a.w[1];
  const T* wqkv = (const T*)a.w[2];
  const T* wout = (const T*)a.w[3];
  const T* bout = (const T*)a.w[4];
  const T* fn_s = (const T*)a.w[5];
  const T* fn_b = (const T*)a.w[6];
  const T* w1 = (const T*)a.w[7];
  const T* b1 = (const T*)a.w[8];
  const T* w2 = (const T*)a.w[9];
  const size_t fr = (size_t)f * n;
  const T* x = (const T*)a.x + fr * d;
  const T* dy = (const T*)a.dy + fr * d;
  T* dx = (T*)a.dx + fr * d;
  T* H1 = (T*)a.s[0] + fr * d;
  T* QKV = (T*)a.s[1] + fr * i3;
  T* O = (T*)a.s[2] + fr * inner;
  T* H2 = (T*)a.s[3] + fr * d;
  T* HID = (T*)a.s[4] + fr * mlp;
  T* DPRE = (T*)a.s[5] + fr * mlp;
  T* G1C = (T*)a.s[6] + fr * d;
  T* DO = (T*)a.s[7] + fr * inner;
  T* DQKV = (T*)a.s[8] + fr * i3;
  float* V = a.vec + (size_t)f * (6 * d + mlp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- recompute the forward: LN1 -> qkv -> attention -> x1 -> LN2 ----
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  layernorm_stats(x32, n, d, mean1, rstd1);
  layernorm_rows<T>(x32, n, d, an_s, an_b, H1);
  __syncthreads();
  // qkv with each head's q|k|v side by side (the layout `attend` takes):
  // column c of wqkv goes to head c % inner / dh, part c / inner
  matmul(H1, d, n, wqkv, i3, d, i3, Ident(), [=](int r, int c, float v) {
    const int head = c % inner / dh, part = c / inner;
    QKV[(size_t)r * i3 + (head * 3 + part) * dh + c % dh] = fromf<T>(v);
  });
  __syncthreads();
  for (int hd = 0; hd < m.heads; ++hd)
    attend<T>(QKV + 3 * hd * dh, i3, n, n, dh, m.scale, prob, O + hd * dh,
              inner);
  __syncthreads();
  matmul(O, inner, n, wout, d, inner, d, Ident(), [=](int r, int c, float v) {
    x1[(size_t)r * d + c] = x32[(size_t)r * d + c] + (v + tof(bout[c]));
  });
  __syncthreads();
  layernorm_stats(x1, n, d, mean2, rstd2);
  layernorm_rows<T>(x1, n, d, fn_s, fn_b, H2);
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // ---- MLP forward + backward, hidden dim in chunks: acc = dh2 ----------
  for (int c0 = 0; c0 < mlp; c0 += m.hc) {
    const int hc = min(m.hc, mlp - c0);
    matmul(H2, d, n, w1, mlp, d, hc, [=](int c) { return c0 + c; },
           [=](int r, int c, float v) {
             const float p = v + tof(b1[c0 + c]);
             pb[(size_t)r * hc + c] = p;
             HID[(size_t)r * mlp + c0 + c] = fromf<T>(gelu<T>(p));
           });
    __syncthreads();
    // dhid = dy @ w2c^T; dpre = dhid * gelu'(pre), in place of pre
    mm(n, hc, d, [=](int r, int k) { return tof(dy[(size_t)r * d + k]); },
       [=](int k, int c) { return tof(w2[(size_t)(c0 + c) * d + k]); },
       [=](int r, int c, float v) {
         float* p = pb + (size_t)r * hc + c;
         *p = v * gelu_grad<T>(*p);
       });
    __syncthreads();
    col_sums(pb, n, hc, V + 6 * d + c0);  // db1 from the unrounded dpre
    __syncthreads();
    for (int i = threadIdx.x; i < n * hc; i += blockDim.x) {
      const float v = rt<T>(pb[i]);
      pb[i] = v;
      DPRE[(size_t)(i / hc) * mlp + c0 + i % hc] = fromf<T>(v);
    }
    __syncthreads();
    mm(n, d, hc, [=](int r, int k) { return pb[(size_t)r * hc + k]; },
       [=](int k, int c) { return tof(w1[(size_t)c * mlp + c0 + k]); },
       [=](int r, int c, float v) { acc[(size_t)r * d + c] += v; });
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {  // db2
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += tof(dy[(size_t)r * d + c]);
    V[5 * d + c] = s;
  }
  ln_bwd<T>(x1, mean2, rstd2, acc, n, d, fn_s, V + 3 * d, V + 4 * d,
            [=](int r, int c, float v) {
              g1[(size_t)r * d + c] = tof(dy[(size_t)r * d + c]) + v;
            });
  __syncthreads();

  // ---- attention backward ---------------------------------------------
  for (int i = threadIdx.x; i < n * d; i += blockDim.x)
    G1C[i] = fromf<T>(g1[i]);
  col_sums(g1, n, d, V + 2 * d);  // dbout
  __syncthreads();
  // do = g1 @ wout^T, rounded (only do's rounded head slices are used)
  mm(n, inner, d, [=](int r, int k) { return tof(G1C[(size_t)r * d + k]); },
     [=](int k, int c) { return tof(wout[(size_t)c * d + k]); },
     [=](int r, int c, float v) { DO[(size_t)r * inner + c] = fromf<T>(v); });
  __syncthreads();
  for (int hd = 0; hd < m.heads; ++hd) {
    const T* q = QKV + 3 * hd * dh;
    const T* k = q + dh;
    const T* v = q + 2 * dh;
    const T* dob = DO + hd * dh;
    T* dq = DQKV + hd * dh;
    T* dk = dq + inner;
    T* dv = dq + 2 * inner;
    for (int r = warp; r < n; r += kWarps)
      softmax_row<T>(q + (size_t)r * i3, k, i3, n, dh, m.scale,
                     pb + (size_t)r * n);
    __syncthreads();
    // dv = p_c^T @ do; dp = do @ v^T
    mm(n, dh, n, [=](int j, int i) { return rt<T>(pb[(size_t)i * n + j]); },
       [=](int i, int e) { return tof(dob[(size_t)i * inner + e]); },
       [=](int j, int e, float val) { dv[(size_t)j * i3 + e] = fromf<T>(val); });
    mm(n, n, dh, [=](int i, int e) { return tof(dob[(size_t)i * inner + e]); },
       [=](int e, int j) { return tof(v[(size_t)j * i3 + e]); },
       [=](int i, int j, float val) { dpb[(size_t)i * n + j] = val; });
    __syncthreads();
    // ds = T((p * (dp - sum_j dp p)) * scale), in place of dp
    for (int r = warp; r < n; r += kWarps) {
      const float* pr = pb + (size_t)r * n;
      float* dr = dpb + (size_t)r * n;
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += dr[j] * pr[j];
      s = warp_sum(s);
      for (int j = lane; j < n; j += 32)
        dr[j] = rt<T>((pr[j] * (dr[j] - s)) * m.scale);
    }
    __syncthreads();
    // dq = ds @ k; dk = ds^T @ q
    mm(n, dh, n, [=](int i, int j) { return dpb[(size_t)i * n + j]; },
       [=](int j, int e) { return tof(k[(size_t)j * i3 + e]); },
       [=](int i, int e, float val) { dq[(size_t)i * i3 + e] = fromf<T>(val); });
    mm(n, dh, n, [=](int j, int i) { return dpb[(size_t)i * n + j]; },
       [=](int i, int e) { return tof(q[(size_t)i * i3 + e]); },
       [=](int j, int e, float val) { dk[(size_t)j * i3 + e] = fromf<T>(val); });
    __syncthreads();
  }
  // dh1 = dqkv_c @ wqkv^T, then LN1 backward: dx = g1 + dln1
  mm(n, d, i3, [=](int r, int k) { return tof(DQKV[(size_t)r * i3 + k]); },
     [=](int k, int c) { return tof(wqkv[(size_t)c * i3 + k]); },
     [=](int r, int c, float v) { acc[(size_t)r * d + c] = v; });
  __syncthreads();
  ln_bwd<T>(x32, mean1, rstd1, acc, n, d, an_s, V, V + d,
            [=](int r, int c, float v) {
              dx[(size_t)r * d + c] = fromf<T>(g1[(size_t)r * d + c] + v);
            });
}

// ---- the bf16 full-block backward on the tensor cores --------------------
//
// The same function as block_bwd_body<bf16>, every product a bf16 mma.sync
// tile product into fp32 (mma_common.cuh): each product's operands are
// values already rounded to bf16 (h1, q, k, v, the rounded p, o, h2, dy,
// the rounded dpre, g1c, do, the rounded ds, dqkv), so only the order of
// its sums differs from the FMA body. A frame's rows are padded to a
// multiple of 16 with zero rows and padded keys are masked, so padded rows
// add nothing to any sum over rows. Kept on CUDA cores in fp32 as in the
// FMA body: the LayerNorm statistics and backward, the softmax and its
// backward, GELU and its derivative, the column sums.
//
// Widths are the flagship's (d = dim_head = 64, fixed at compile time);
// n <= 80 rows (the 16 x 80 scores of a warp live in registers) and mlp a
// multiple of kMmaChunk. The caller picks this body where they hold
// (tensor_core_bwd in ops/fused_transformer.py) and the host checks them
// (mma_body_takes); other bf16 widths run block_bwd_body<bf16>.
//
// Per head, q, k and v are projected from h1 (kept in shared memory) and
// the head's slice of wqkv, forward and again in the backward, and do from
// g1c and the head's slice of wout: none of them goes through device
// memory. Weight tiles go to shared memory by cp.async; the transposed
// products (dy w2^T, dpre w1^T, g1 wout^T, dqkv wqkv^T) read the same
// tiles as [N][K] operands through ldmatrix, so no weight is read with a
// stride. The MLP walks its hidden dim in chunks of kMmaChunk with the
// next chunk's w1 and w2 tiles in flight (double-buffered). Per head the
// out-projection and the dqkv wqkv^T product are added into fp32 tiles in
// shared memory (another order of the same sums). The operands of the
// weight products (h1, o, h2, hid, dpre, g1c, dqkv) go to their workspace
// slots once, in 16-byte stores.

constexpr int kMmaD = 64;       // token width and head width of the body
constexpr int kMmaChunk = 64;   // MLP hidden columns per step
constexpr int kMmaRows = 80;    // most rows of a frame
constexpr int kMmaKeyTiles = kMmaRows / 8;
constexpr int kLd = kMmaD + 8;          // row stride of 64-wide bf16 tiles
constexpr int kLdQkv = 3 * kMmaD + 8;   // row stride of a head's q|k|v
static_assert(kMmaChunk == kMmaD, "the MLP tiles share the 64-wide stride");

// the offset of `bytes` at o, and o moved past them (16-byte aligned)
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = align16(o + bytes);
  return at;
}

// Shared memory of block_bwd_mma for n rows: fp32 tiles that live through
// the whole pass, then one region `u` that each phase lays out anew.
struct MmaBwdSmem {
  size_t x32, acc, g1, stats, h1;
  size_t x1, a_wqkv, a_wout, a_q, a_k, a_v, a_o;         // attention
  size_t b_h2, b_dy, b_w1, b_w2, b_hid, b_dpre, b_dprec;  // MLP (w: x 2)
  size_t c_g1c, c_wqkv, c_wout, c_q, c_k, c_v, c_do, c_pc, c_ds, c_dqkv;
  size_t total;
  __host__ __device__ explicit MmaBwdSmem(int n) {
    const size_t np = round16(n), rows = sizeof(float) * n * kMmaD,
                 tile = sizeof(bf16) * np * kLd,
                 wqkv = sizeof(bf16) * kMmaD * kLdQkv,
                 w64 = sizeof(bf16) * kMmaD * kLd,
                 probs = sizeof(bf16) * np * (np + 8);
    size_t o = 0;
    x32 = take(o, rows);
    acc = take(o, rows);
    g1 = take(o, rows);
    stats = take(o, sizeof(float) * 4 * n);
    h1 = take(o, tile);
    const size_t u = o;
    x1 = take(o, rows);  // lives from the attention through the MLP
    const size_t after_x1 = o;
    a_wqkv = take(o, wqkv);
    a_wout = take(o, w64);
    a_q = take(o, tile);
    a_k = take(o, tile);
    a_v = take(o, tile);
    a_o = take(o, tile);
    size_t end = o;
    o = after_x1;
    b_h2 = take(o, tile);
    b_dy = take(o, tile);
    b_w1 = take(o, 2 * w64);
    b_w2 = take(o, 2 * w64);
    b_hid = take(o, tile);
    b_dpre = take(o, sizeof(float) * np * kLd);
    b_dprec = take(o, tile);
    end = end > o ? end : o;
    o = u;
    c_g1c = take(o, tile);
    c_wqkv = take(o, wqkv);
    c_wout = take(o, w64);
    c_q = take(o, tile);
    c_k = take(o, tile);
    c_v = take(o, tile);
    c_do = take(o, tile);
    c_pc = take(o, probs);
    c_ds = take(o, probs);
    c_dqkv = take(o, sizeof(bf16) * np * kLdQkv);
    total = end > o ? end : o;
  }
};

// layernorm_rows (block_common.cuh), the same arithmetic, into a bf16 tile
// of row stride ld
__device__ void layernorm_tile(const float* x, int R, int d, const bf16* s,
                               const bf16* b, bf16* out, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x + (size_t)r * d;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += xr[c];
    const float m = warp_sum(sum) / d;
    float sq = 0.f;
    for (int c = lane; c < d; c += 32) sq += (xr[c] - m) * (xr[c] - m);
    const float inv = rsqrtf(warp_sum(sq) / d + 1e-5f);
    for (int c = lane; c < d; c += 32)
      out[(size_t)r * ld + c] =
          fromf<bf16>((xr[c] - m) * inv * tof(s[c]) + tof(b[c]));
  }
}

// col_sums over an fp32 tile of row stride ld
__device__ void col_sums_ld(const float* x, int ld, int R, int d,
                            float* out) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += x[(size_t)r * ld + c];
    out[c] = s;
  }
}

// bf16 pair (c, c + 1) of row r of a tile
__device__ __forceinline__ void put2(bf16* s, int ld, int r, int c, float v0,
                                     float v1) {
  *reinterpret_cast<uint32_t*>(s + (size_t)r * ld + c) = pack_bf16(v0, v1);
}

// One warp's 16 query rows m0.. of a head: the forward's softmax
// probabilities, unrounded, in the accumulator layout (key tile j, entry
// e: row m0 + g + 8 (e / 2), key 8 j + 2 t + e % 2); keys >= n hold 0.
// Scores, max, exp and sum as `attend` and `softmax_row` form them.
__device__ __forceinline__ void head_probs(float (&s)[kMmaKeyTiles][4],
                                           const bf16* qs, const bf16* ks,
                                           int m0, int n, int np,
                                           float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kMmaD; k0 += 16) {
    uint32_t a[4];
    load_a(a, qs, kLd, m0, k0);
#pragma unroll
    for (int j = 0; j < kMmaKeyTiles; j += 2)
      if (8 * j < np) {
        uint32_t b[4];
        load_b_nk(b, ks, kLd, 8 * j, k0);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
  }
  const float ninf = __int_as_float(0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + 2 * t + e % 2 < n ? s[j][e] * scale : ninf;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e / 2]);
      sum[e / 2] += s[j][e];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e / 2];
}

// The per-frame pass of a full block's backward for frame f, bf16, on the
// tensor cores; the same operands, slots and row sums as block_bwd_body.
__device__ __forceinline__ void block_bwd_mma(const BwdArgs& a, int f,
                                              unsigned char* smem_raw) {
  using T = bf16;
  constexpr int D = kMmaD, DH = kMmaD, HC = kMmaChunk;
  const Dims m = a.m;
  const int n = a.n, np = round16(n), heads = m.heads, inner = heads * DH,
            i3 = 3 * inner, mlp = m.mlp, lp = np + 8;
  const MmaBwdSmem L(n);
  float* x32 = (float*)(smem_raw + L.x32);
  float* acc = (float*)(smem_raw + L.acc);
  float* g1 = (float*)(smem_raw + L.g1);
  float* mean1 = (float*)(smem_raw + L.stats);
  float* rstd1 = mean1 + n;
  float* mean2 = rstd1 + n;
  float* rstd2 = mean2 + n;
  T* h1s = (T*)(smem_raw + L.h1);
  float* x1 = (float*)(smem_raw + L.x1);
  const T* an_s = (const T*)a.w[0];
  const T* an_b = (const T*)a.w[1];
  const T* wqkv = (const T*)a.w[2];
  const T* wout = (const T*)a.w[3];
  const T* bout = (const T*)a.w[4];
  const T* fn_s = (const T*)a.w[5];
  const T* fn_b = (const T*)a.w[6];
  const T* w1 = (const T*)a.w[7];
  const T* b1 = (const T*)a.w[8];
  const T* w2 = (const T*)a.w[9];
  const size_t fr = (size_t)f * n;
  const T* x = (const T*)a.x + fr * D;
  const T* dy = (const T*)a.dy + fr * D;
  T* dx = (T*)a.dx + fr * D;
  T* H1 = (T*)a.s[0] + fr * D;
  T* O = (T*)a.s[2] + fr * inner;
  T* H2 = (T*)a.s[3] + fr * D;
  T* HID = (T*)a.s[4] + fr * mlp;
  T* DPRE = (T*)a.s[5] + fr * mlp;
  T* G1C = (T*)a.s[6] + fr * D;
  T* DQKV = (T*)a.s[8] + fr * i3;
  float* V = a.vec + (size_t)f * (6 * D + mlp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // a head's q|k|v columns of wqkv and its rows of wout into shared memory
  auto stage_wqkv = [&](T* s, int hd) {
    for (int part = 0; part < 3; ++part)
      stage_rows(s + part * DH, kLdQkv, wqkv + part * inner + hd * DH, i3,
                 D, DH);
  };
  auto stage_wout = [&](T* s, int hd) {
    stage_rows(s, kLd, wout + (size_t)hd * DH * D, D, DH, D);
  };
  // q|k|v of head (its wqkv slice in ws) from h1s, rounded, into q, k, v
  auto project_qkv = [&](const T* ws, T* q, T* k, T* v) {
    block_mma<false, false>(np, 3 * DH, D, h1s, kLd, ws, kLdQkv,
                            [=](int r, int c, float v0, float v1) {
                              T* dst = c < DH ? q : (c < 2 * DH ? k : v);
                              put2(dst, kLd, r, c % DH, v0, v1);
                            });
  };

  // ---- recompute the forward: LN1 -> per head q|k|v, attention, o ------
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  layernorm_stats(x32, n, D, mean1, rstd1);
  layernorm_tile(x32, n, D, an_s, an_b, h1s, kLd);
  zero_rows(h1s, kLd, n, np, D);
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) x1[i] = 0.f;
  {
    T* wq = (T*)(smem_raw + L.a_wqkv);
    T* wo = (T*)(smem_raw + L.a_wout);
    T* q = (T*)(smem_raw + L.a_q);
    T* k = (T*)(smem_raw + L.a_k);
    T* v = (T*)(smem_raw + L.a_v);
    T* o = (T*)(smem_raw + L.a_o);
    stage_wqkv(wq, 0);
    stage_wout(wo, 0);
    cp_async_commit();
    __syncthreads();
    store_rows(H1, D, h1s, kLd, n, D);
    for (int hd = 0; hd < heads; ++hd) {
      cp_async_wait<0>();
      __syncthreads();
      project_qkv(wq, q, k, v);
      __syncthreads();
      if (hd + 1 < heads) {
        stage_wqkv(wq, hd + 1);
        cp_async_commit();
      }
      // attention of 16 query rows a warp: p_c = T(p), o = T(p_c v)
      for (int m0 = warp * 16; m0 < np; m0 += kWarps * 16) {
        float s[kMmaKeyTiles][4];
        head_probs(s, q, k, m0, n, np, m.scale);
        float acc_o[DH / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < kMmaKeyTiles / 2; ++kk) {
          if (16 * kk >= np) continue;
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2],
                                            s[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < DH / 8; j += 2) {
            uint32_t b[4];
            load_b_kn(b, v, kLd, 8 * j, 16 * kk);
            mma_bf16(acc_o[j], pa, b[0], b[1]);
            mma_bf16(acc_o[j + 1], pa, b[2], b[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          put2(o, kLd, m0 + g, 8 * j + 2 * t, acc_o[j][0], acc_o[j][1]);
          put2(o, kLd, m0 + g + 8, 8 * j + 2 * t, acc_o[j][2], acc_o[j][3]);
        }
      }
      __syncthreads();
      // x1 += o @ wout[head rows]; o to its slot
      block_mma<false, false>(np, D, DH, o, kLd, wo, kLd,
                              [=](int r, int c, float v0, float v1) {
                                if (r < n) {
                                  x1[r * D + c] += v0;
                                  x1[r * D + c + 1] += v1;
                                }
                              });
      store_rows(O + hd * DH, inner, o, kLd, n, DH);
      __syncthreads();
      if (hd + 1 < heads) {
        stage_wout(wo, hd + 1);
        cp_async_commit();
      }
    }
  }
  for (int i = threadIdx.x; i < n * D; i += blockDim.x)
    x1[i] = x32[i] + (x1[i] + tof(bout[i % D]));
  __syncthreads();

  // ---- MLP forward + backward, hidden dim in chunks: acc = dh2 ----------
  {
    T* h2s = (T*)(smem_raw + L.b_h2);
    T* dys = (T*)(smem_raw + L.b_dy);
    T* w1s = (T*)(smem_raw + L.b_w1);
    T* w2s = (T*)(smem_raw + L.b_w2);
    T* hid = (T*)(smem_raw + L.b_hid);
    float* dpre = (float*)(smem_raw + L.b_dpre);
    T* dprec = (T*)(smem_raw + L.b_dprec);
    auto stage_chunk = [&](int buf, int c0) {
      stage_rows(w1s + buf * D * kLd, kLd, w1 + c0, mlp, D, HC);
      stage_rows(w2s + buf * HC * kLd, kLd, w2 + (size_t)c0 * D, D, HC, D);
    };
    layernorm_stats(x1, n, D, mean2, rstd2);
    layernorm_tile(x1, n, D, fn_s, fn_b, h2s, kLd);
    zero_rows(h2s, kLd, n, np, D);
    stage_rows(dys, kLd, dy, D, n, D);
    zero_rows(dys, kLd, n, np, D);
    stage_chunk(0, 0);
    cp_async_commit();
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
    store_rows(H2, D, h2s, kLd, n, D);
    for (int c0 = 0, buf = 0; c0 < mlp; c0 += HC, buf ^= 1) {
      if (c0 + HC < mlp) {
        stage_chunk(buf ^ 1, c0 + HC);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* w1c = w1s + buf * D * kLd;
      const T* w2c = w2s + buf * HC * kLd;
      // pre = h2 @ w1c + b1 and dhid = dy @ w2c^T on the same tile:
      // hid = T(gelu(pre)); dpre = dhid * gelu'(pre), unrounded
      const int mt = np / 16;
      for (int it = warp; it < mt * (HC / 16); it += kWarps) {
        const int r0 = it % mt * 16, n0 = it / mt * 16;
        float pre[2][4] = {}, dh[2][4] = {};
        warp_mma<2, false, false>(pre, h2s, kLd, r0, w1c, kLd, n0, D);
        warp_mma<2, false, true>(dh, dys, kLd, r0, w2c, kLd, n0, D);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h, c = n0 + 8 * j + 2 * t;
            const float p0 = pre[j][2 * h] + tof(b1[c0 + c]);
            const float p1 = pre[j][2 * h + 1] + tof(b1[c0 + c + 1]);
            put2(hid, kLd, r, c, gelu<T>(p0), gelu<T>(p1));
            dpre[r * kLd + c] = dh[j][2 * h] * gelu_grad<T>(p0);
            dpre[r * kLd + c + 1] = dh[j][2 * h + 1] * gelu_grad<T>(p1);
          }
      }
      __syncthreads();
      col_sums_ld(dpre, kLd, n, HC, V + 6 * D + c0);  // db1, unrounded dpre
      // dpre rounded to T: its slot, and the next product's operand (zero
      // rows past n); hid to its slot
      for (int i = threadIdx.x; i < np * (HC / 8); i += blockDim.x) {
        const int r = i / (HC / 8), c = i % (HC / 8) * 8;
        uint4 pk = make_uint4(0, 0, 0, 0);
        if (r < n) {
          const float* src = dpre + r * kLd + c;
          pk = make_uint4(pack_bf16(src[0], src[1]), pack_bf16(src[2], src[3]),
                          pack_bf16(src[4], src[5]), pack_bf16(src[6], src[7]));
          *reinterpret_cast<uint4*>(DPRE + (size_t)r * mlp + c0 + c) = pk;
          *reinterpret_cast<uint4*>(HID + (size_t)r * mlp + c0 + c) =
              *reinterpret_cast<const uint4*>(hid + r * kLd + c);
        }
        *reinterpret_cast<uint4*>(dprec + r * kLd + c) = pk;
      }
      __syncthreads();
      // acc += dpre_c @ w1c^T
      block_mma<false, true>(np, D, HC, dprec, kLd, w1c, kLd,
                             [=](int r, int c, float v0, float v1) {
                               if (r < n) {
                                 acc[r * D + c] += v0;
                                 acc[r * D + c + 1] += v1;
                               }
                             });
      __syncthreads();
    }
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {  // db2
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += tof(dy[(size_t)r * D + c]);
    V[5 * D + c] = s;
  }
  ln_bwd<T>(x1, mean2, rstd2, acc, n, D, fn_s, V + 3 * D, V + 4 * D,
            [=](int r, int c, float v) {
              g1[(size_t)r * D + c] = tof(dy[(size_t)r * D + c]) + v;
            });
  __syncthreads();

  // ---- attention backward, per head; acc = dh1 -------------------------
  T* g1c = (T*)(smem_raw + L.c_g1c);
  T* wq = (T*)(smem_raw + L.c_wqkv);
  T* wo = (T*)(smem_raw + L.c_wout);
  T* q = (T*)(smem_raw + L.c_q);
  T* k = (T*)(smem_raw + L.c_k);
  T* v = (T*)(smem_raw + L.c_v);
  T* dob = (T*)(smem_raw + L.c_do);
  T* pc = (T*)(smem_raw + L.c_pc);
  T* ds = (T*)(smem_raw + L.c_ds);
  T* dqkv = (T*)(smem_raw + L.c_dqkv);
  stage_wqkv(wq, 0);
  stage_wout(wo, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < n * D; i += blockDim.x)
    g1c[(i / D) * kLd + i % D] = fromf<T>(g1[i]);
  zero_rows(g1c, kLd, n, np, D);
  col_sums(g1, n, D, V + 2 * D);  // dbout
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  store_rows(G1C, D, g1c, kLd, n, D);
  for (int hd = 0; hd < heads; ++hd) {
    cp_async_wait<0>();
    __syncthreads();
    // q|k|v again from h1; do = T(g1c @ wout[head rows]^T)
    project_qkv(wq, q, k, v);
    block_mma<false, true>(np, DH, D, g1c, kLd, wo, kLd,
                           [=](int r, int c, float v0, float v1) {
                             put2(dob, kLd, r, c, v0, v1);
                           });
    __syncthreads();
    if (hd + 1 < heads) {
      stage_wout(wo, hd + 1);
      cp_async_commit();
    }
    // per 16 query rows: p, dp = do v^T, ds = T((p (dp - sum_j dp p))
    // scale); the rounded p and ds to shared memory, zero past row n
    for (int m0 = warp * 16; m0 < np; m0 += kWarps * 16) {
      float p[kMmaKeyTiles][4], dp[kMmaKeyTiles][4];
      head_probs(p, q, k, m0, n, np, m.scale);
#pragma unroll
      for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < DH; k0 += 16) {
        uint32_t af[4];
        load_a(af, dob, kLd, m0, k0);
#pragma unroll
        for (int j = 0; j < kMmaKeyTiles; j += 2)
          if (8 * j < np) {
            uint32_t b[4];
            load_b_nk(b, v, kLd, 8 * j, k0);
            mma_bf16(dp[j], af, b[0], b[1]);
            mma_bf16(dp[j + 1], af, b[2], b[3]);
          }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMmaKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e / 2] += dp[j][e] * p[j][e];
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
#pragma unroll
      for (int j = 0; j < kMmaKeyTiles; ++j)
        if (8 * j < np)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + g + 8 * h, c = 8 * j + 2 * t;
            const bool live = r < n;
            float d0 = (p[j][2 * h] * (dp[j][2 * h] - rs[h])) * m.scale;
            float d1 = (p[j][2 * h + 1] * (dp[j][2 * h + 1] - rs[h])) *
                       m.scale;
            put2(pc, lp, r, c, live ? p[j][2 * h] : 0.f,
                 live ? p[j][2 * h + 1] : 0.f);
            put2(ds, lp, r, c, live ? d0 : 0.f, live ? d1 : 0.f);
          }
    }
    __syncthreads();
    // dq = ds @ k, dk = ds^T @ q, dv = p_c^T @ do, rounded into dqkv
    {
      const int mt = np / 16, per = mt * (DH / 16);
      for (int it = warp; it < 3 * per; it += kWarps) {
        const int part = it / per, r0 = it % per % mt * 16,
                  n0 = it % per / mt * 16;
        float c2[2][4] = {};
        if (part == 0)
          warp_mma<2, false, false>(c2, ds, lp, r0, k, kLd, n0, np);
        else if (part == 1)
          warp_mma<2, true, false>(c2, ds, lp, r0, q, kLd, n0, np);
        else
          warp_mma<2, true, false>(c2, pc, lp, r0, dob, kLd, n0, np);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = part * DH + n0 + 8 * j + 2 * t;
          put2(dqkv, kLdQkv, r0 + g, c, c2[j][0], c2[j][1]);
          put2(dqkv, kLdQkv, r0 + g + 8, c, c2[j][2], c2[j][3]);
        }
      }
    }
    __syncthreads();
    // acc += dqkv_h @ wqkv[:, head columns]^T; dqkv to its slot (wqkv's
    // column order)
    block_mma<false, true>(np, D, 3 * DH, dqkv, kLdQkv, wq, kLdQkv,
                           [=](int r, int c, float v0, float v1) {
                             if (r < n) {
                               acc[r * D + c] += v0;
                               acc[r * D + c + 1] += v1;
                             }
                           });
    for (int part = 0; part < 3; ++part)
      store_rows(DQKV + part * inner + hd * DH, i3, dqkv + part * DH, kLdQkv,
                 n, DH);
    __syncthreads();
    if (hd + 1 < heads) {
      stage_wqkv(wq, hd + 1);
      cp_async_commit();
    }
  }
  ln_bwd<T>(x32, mean1, rstd1, acc, n, D, an_s, V, V + D,
            [=](int r, int c, float v) {
              dx[(size_t)r * D + c] = fromf<T>(g1[(size_t)r * D + c] + v);
            });
}

// The full-block backward body: with Mma the bf16 tensor-core body (the
// flagship widths, see mma_body_takes), else the FMA body of T, which
// takes any width (fp32 off the flagship widths; at them fp32 runs
// block_bwd_cluster_fp32_kernel, below).
template <typename T, bool Mma>
__device__ __forceinline__ void block_bwd(const BwdArgs& a, int f,
                                          unsigned char* smem_raw) {
  if constexpr (Mma)
    block_bwd_mma(a, f, smem_raw);
  else
    block_bwd_body<T>(a, f, smem_raw);
}

template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads)
    block_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  block_bwd<T, Mma>(a, blockIdx.x, smem_raw);
}

// ---- the fp32 forms at the flagship widths: one frame a cluster ---------
//
// K2f and K2b's per-frame pass in fp32 at d = dim_head = 64, 4 heads, at
// most 80 rows and mlp a multiple of 4 x 64 (fp32_cluster_fwd in
// ops/fused_transformer.py picks them; fp32_cluster_takes checks them),
// one frame over a cluster of 4 CTAs on tf32_block.cuh's body, every
// product on the tensor cores (tf32_mma.cuh). The FMA bodies ran a frame
// on one SM (a batch of 64 filled 64 of 132 SMs, each frame 256 threads of
// fp32 FMA chains); a cluster puts four SMs on a frame and the products on
// the tensor cores.
//
// K2f (block_fwd_cluster_fp32_kernel) runs the body's full block. K2b's
// pass (block_bwd_cluster_fp32_kernel) runs on rank r:
//  * the forward's first half (cl32::attend, the same function K2f runs,
//    so h1, q, k, v, o, x1 and h2 are K2f's bit for bit), then the MLP's
//    first products over its quarter of the hidden columns in K2f's tiles
//    (pre = h2 w1 + b1, hid = gelu(pre): K2f's GELU values);
//  * the reverse pass of that quarter: dpre = (dy w2^T) gelu'(pre), dh2's
//    partial dpre w1^T; the partials exchanged through distributed
//    shared memory and added in rank order, then LN2's backward: g1
//    (LN2's backward magnifies dh2's errors by 1 / std of its row, and on
//    some frames of a trained model that is large);
//  * head r's backward: do = g1 wout_r^T; the probabilities recomputed
//    from the kept q and k (cl32::probs, the forward's own function);
//    dv = p^T do and dk = ds^T q by key rows (each warp 16 keys, p and ds
//    read transposed from a shared tile), dp = do v^T, ds = p (dp - rowsum
//    (dp p)) scale and dq = ds k by query rows; dh1's partial dq wq_r^T +
//    dk wk_r^T + dv wv_r^T, exchanged and added in rank order, then LN1's
//    backward: dx = g1 + dln1.
// The reverse pass's products take the exact split into three TF32 parts
// (tf32::A3, six mma.sync.m16n8k8 a step), the recompute the forward's
// (the attention's exact, the MLP's first product 3xTF32). The
// operands of the weight products go to the workspace slots as
// block_bwd_body writes them (h1, h2, g1 and dx by rank columns, o and
// dqkv by head, hid and dpre by quarter), and so do the frame's row sums
// (each vector by one rank, b1 by quarter): pass 2 reads them unchanged.
// Per CTA: the head's k, v and q tiles and the probabilities (over them
// dh2's partials), one region that holds in turn the head's weights, the
// MLP's ring and the backward's weights and do tile, the partial tile and
// each warp's x and x1 (later g1) tiles: 225,792 bytes at 80 rows.

namespace bw32 {

using cl32::D;
using cl32::HC;
using cl32::kLdK;
using cl32::kLdW;
using cl32::kPart;
using cl32::kRanks;
using mmafwd::col_of;
using mmafwd::kKeyTiles;
using mmafwd::row_of;
using mmafwd::zero;

// row stride of the probabilities' tile (4 mod 16: its columns read
// transposed, rows 2t and 2t + 1 at column g, fall on distinct banks)
__host__ __device__ inline int ld_probs(int n) { return round16(n) + 4; }

// A CTA of block_bwd_cluster_fp32_kernel for n rows; `fwd` places the
// forward body's tiles inside it.
struct Layout {
  size_t k, v, q, p, u, part_a, xs, x1s, cs, total;
  cl32::Layout fwd;
  __host__ __device__ explicit Layout(int n) : fwd(n, 0) {
    using mmafwd::take;
    const size_t np = round16(n), w64 = sizeof(float) * D * kLdW,
                 part = sizeof(float) * (np / 16) * kPart,
                 probs = sizeof(float) * np * ld_probs(n);
    size_t o = 0;
    k = take(o, sizeof(float) * np * kLdK);  // the head's k, v, q
    v = take(o, sizeof(float) * np * kLdW);
    q = take(o, sizeof(float) * np * kLdW);
    p = take(o, probs > part ? probs : part);  // p, ds; dh2's partials
    u = take(o, 4 * w64);  // wqkv, wout slices; the ring; wout, do; wqkv
    part_a = take(o, part);  // the out-projection's and dh1's partials
    xs = take(o, part);      // each warp's rows of x
    x1s = take(o, part);     // ... of x1, then g1
    cs = take(o, sizeof(float) * (np / 16) * D);  // column sums by warp
    total = o;
    fwd.k = k;
    fwd.v = v;
    fwd.wq = u;
    fwd.wo = u + 3 * w64;
    fwd.ring = u;
    fwd.part_a = part_a;
    fwd.part_m = p;
    fwd.total = total;
  }
};

using cl32::read_rows;  // the warp's 16 rows of an fp32 frame

// the warp's rows < n, column tiles [j0, j1) (8 columns each), into a
// row-major fp32 matrix of row stride ld
__device__ __forceinline__ void write_rows(const float (&v)[8][4], float* m,
                                           int ld, int r0, int n, int j0 = 0,
                                           int j1 = 8) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < j0 || j >= j1) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_of(r0, 2 * h);
      if (r < n)
        *reinterpret_cast<float2*>(m + (size_t)r * ld + col_of(j, 0)) =
            make_float2(v[j][2 * h], v[j][2 * h + 1]);
    }
  }
}

// the warp's own slot of a partial tile back into registers
__device__ __forceinline__ void get_part(float (&v)[8][4],
                                         const float* tile) {
  const float* s = tile + threadIdx.x / 32 * kPart + threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = s[(4 * j + e) * 32];
}

// acc[j] += a (16 x 64) @ W^T for W a [64][kLdW] tile: B(k, n) = W[n][k],
// read as the pair (2t, 2t + 1) of row n
__device__ __forceinline__ void rows_mma_t(float (&acc)[8][4],
                                           const float (&a)[8][4],
                                           const float* w) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    tf32::A3 af;
    tf32::frag(af, a[kk]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(
          w + (size_t)(8 * j + g) * kLdW + 8 * kk + 2 * t);
      tf32::mma_add(acc[j], af, b.x, b.y);
    }
  }
}

// s[j] (16 rows x np keys) += a (16 x 64) @ T^T, T a tile of np rows (the
// keys) and row stride ld: B(e, key) = T[key][e]
__device__ __forceinline__ void keys_mma(float (&s)[kKeyTiles][4],
                                         const float (&a)[8][4],
                                         const float* tile, int ld, int np) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    tf32::A3 af;
    tf32::frag(af, a[kk]);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
      if (8 * j < np) {
        const float2 b = *reinterpret_cast<const float2*>(
            tile + (size_t)(8 * j + g) * ld + 8 * kk + 2 * t);
        tf32::mma_add(s[j], af, b.x, b.y);
      }
  }
}

// acc[j] += s (16 rows x np keys) @ T, T a tile of np rows (the keys),
// row stride ld: B(key, e) = T[key][e]
__device__ __forceinline__ void over_keys(float (&acc)[8][4],
                                          const float (&s)[kKeyTiles][4],
                                          const float* tile, int ld, int np) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles; ++kk) {
    if (8 * kk >= np) continue;
    tf32::A3 af;
    tf32::frag(af, s[kk]);
    const float* b0 = tile + (size_t)(8 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tf32::mma_add(acc[j], af, b0[8 * j], b0[ld + 8 * j]);
  }
}

// acc[j] += M^T @ B for the warp's 16 rows r0.. of the result: A(r, i) =
// M[i][r0 + r] and B(i, e) = B[i][e] over i < np; M of row stride ldm (4
// mod 16), B of row stride ldb (4 mod 32)
__device__ __forceinline__ void cols_mma(float (&acc)[8][4], const float* m,
                                         int ldm, int r0, const float* b,
                                         int ldb, int np) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles; ++kk) {
    if (8 * kk >= np) continue;
    const float* m0 = m + (size_t)(8 * kk + 2 * t) * ldm + r0 + g;
    tf32::A3 af;
    tf32::frag(af, m0[0], m0[8], m0[ldm], m0[ldm + 8]);
    const float* b0 = b + (size_t)(8 * kk + 2 * t) * ldb + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tf32::mma_add(acc[j], af, b0[8 * j], b0[ldb + 8 * j]);
  }
}

// the warp's 16 rows x np keys (accumulator layout) into a row-major tile
// of row stride ld
__device__ __forceinline__ void put_keys(const float (&s)[kKeyTiles][4],
                                         float* tile, int ld, int r0,
                                         int np) {
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
    if (8 * j < np)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (size_t)row_of(r0, 2 * h) * ld +
                                   8 * j + 2 * (threadIdx.x % 4)) =
            make_float2(s[j][2 * h], s[j][2 * h + 1]);
}

// LayerNorm's backward on the warp's rows: x its input, dh the grad of its
// output, s its scale; dx = rstd (dh s - mean(dh s) - xhat mean(dh s
// xhat)) as block_bwd_body's ln_bwd forms it, and xhat; rows >= n zero.
// The statistics are norm_rows' (mean, then the centred squares).
__device__ __forceinline__ void ln_back(const float (&x)[8][4],
                                        const float (&dh)[8][4],
                                        const float* s, int r0, int n,
                                        float (&xhat)[8][4],
                                        float (&dx)[8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += x[j][2 * h] + x[j][2 * h + 1];
    const float m = quad_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c = x[j][2 * h + e] - m;
        sq += c * c;
      }
    const float inv = rsqrtf(quad_sum(sq) / D + 1e-5f);
    const bool live = row_of(r0, 2 * h) < n;
    float sd = 0.f, sdx = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xh = live ? (x[j][2 * h + e] - m) * inv : 0.f;
        const float dxh = dh[j][2 * h + e] * s[col_of(j, e)];
        xhat[j][2 * h + e] = xh;
        sd += dxh;
        sdx += dxh * xh;
      }
    const float md = quad_sum(sd) / D, mdx = quad_sum(sdx) / D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dxh = dh[j][2 * h + e] * s[col_of(j, e)];
        dx[j][2 * h + e] =
            live ? inv * (dxh - md - xhat[j][2 * h + e] * mdx) : 0.f;
      }
  }
}

// out[c] = the sum over the frame's rows of v (the warps' rows in the
// accumulator layout, rows >= n zero), c < 64: each warp's 16 rows, then
// the warps in order. Every thread of the CTA calls it.
__device__ __forceinline__ void col_sums(const float (&v)[8][4], float* cs,
                                         float* out, int warps) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[j][e] + v[j][e + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) cs[warp * D + col_of(j, e)] = s;
    }
  __syncthreads();
  if (threadIdx.x < D) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += cs[w * D + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();  // cs is free again
}

// the elementwise product a * b of two warps' tiles
__device__ __forceinline__ void mul(float (&out)[8][4], const float (&a)[8][4],
                                    const float (&b)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = a[j][e] * b[j][e];
}

// What K2b's pass keeps of the forward's first half: h1 and h2 to their
// workspace slots by the rank's column tiles, o by its head, q to the q
// tile (every row), x1 to the warp's x1 tile.
struct BwdSave {
  float *h1p, *op, *h2p, *qs, *x1s;
  int n, r0, rank, inner;
  __device__ __forceinline__ void h1(const float (&v)[8][4]) {
    write_rows(v, h1p, D, r0, n, 2 * rank, 2 * rank + 2);
  }
  __device__ __forceinline__ void q(const float (&v)[8][4]) {
    write_rows(v, qs, kLdW, r0, round16(n));
  }
  __device__ __forceinline__ void p(const float (&)[kKeyTiles][4]) {}
  __device__ __forceinline__ void o(const float (&v)[8][4]) {
    write_rows(v, op + rank * D, inner, r0, n);
  }
  __device__ __forceinline__ void x1h2(const float (&x1)[8][4],
                                       const float (&h2)[8][4]) {
    cl32::put_part(x1, x1s);
    write_rows(h2, h2p, D, r0, n, 2 * rank, 2 * rank + 2);
  }
  __device__ __forceinline__ void hid(const float (&)[8][4], int) {}
};

// What the fp32 probe writes of K2f's body: h1, o, h2 and hid (B, n, d),
// (B, n, heads d), (B, n, d), (B, n, mlp), each part by the rank that
// computes it.
struct ProbeSave {
  float *h1p, *op, *h2p, *hidp;
  int n, r0, rank, inner, mlp;
  __device__ __forceinline__ void h1(const float (&v)[8][4]) {
    write_rows(v, h1p, D, r0, n, 2 * rank, 2 * rank + 2);
  }
  __device__ __forceinline__ void q(const float (&)[8][4]) {}
  __device__ __forceinline__ void p(const float (&)[kKeyTiles][4]) {}
  __device__ __forceinline__ void o(const float (&v)[8][4]) {
    write_rows(v, op + rank * D, inner, r0, n);
  }
  __device__ __forceinline__ void x1h2(const float (&)[8][4],
                                       const float (&h2)[8][4]) {
    write_rows(h2, h2p, D, r0, n, 2 * rank, 2 * rank + 2);
  }
  __device__ __forceinline__ void hid(const float (&z)[8][4], int col0) {
    write_rows(z, hidp + col0, mlp, r0, n);
  }
};

}  // namespace bw32

// K2f in fp32 at the flagship widths: one frame a cluster of 4 CTAs, the
// body's full block (tf32_block.cuh), the output rows written by the
// rank's column tiles.
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    block_fwd_cluster_fp32_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank(),
            f = blockIdx.x / cl32::kRanks, r0 = threadIdx.x / 32 * 16;
  const cl32::Layout L(n, 0);
  const size_t frame = (size_t)f * n * cl32::D;
  mmafwd::Rows x;
  bw32::read_rows(x, (const float*)a.x + frame, cl32::D, r0, n);
  cl32::block<cl32::Exact>(cluster, a.m, a.w, n, rank, r0, x, smem_raw, L,
                           false);
  bw32::write_rows(x, (float*)a.out + frame, cl32::D, r0, n, 2 * rank,
                   2 * rank + 2);
  cluster.sync();  // no rank leaves while another reads its partials
}

// A measurement, not a route: block_fwd_cluster_fp32_kernel with the
// body's intermediates written out (Probe32: h1, o, h2, hid as
// bw32::ProbeSave writes them, and the head's k and v of every row, (B,
// n, heads d) each). With P = cl32::Exact its output is K2f's; with
// cl32::Fast it runs the body as K1's fp32 cluster form sums it.
struct Probe32 {
  float *h1, *o, *h2, *hid, *k, *v;
};

template <typename P>
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    block_probe_cluster_fp32_kernel(const __grid_constant__ FwdArgs a,
                                    Probe32 pr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank(),
            f = blockIdx.x / cl32::kRanks, r0 = threadIdx.x / 32 * 16;
  const int D = cl32::D, inner = a.m.heads * D;
  const cl32::Layout L(n, 0);
  const size_t fr = (size_t)f * n;
  mmafwd::Rows x;
  bw32::read_rows(x, (const float*)a.x + fr * D, D, r0, n);
  bw32::ProbeSave save = {pr.h1 + fr * D, pr.o + fr * inner, pr.h2 + fr * D,
                          pr.hid + fr * a.m.mlp, n, r0, rank, inner,
                          a.m.mlp};
  float h2[8][4];
  cl32::attend<P>(cluster, a.m, a.w, n, rank, r0, x, h2, smem_raw, L, false,
                  save);
  const float* ks = (const float*)(smem_raw + L.k);
  const float* vs = (const float*)(smem_raw + L.v);
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const size_t at = (fr + r) * inner + rank * D + c;
    pr.k[at] = ks[(size_t)r * cl32::kLdK + c];
    pr.v[at] = vs[(size_t)r * cl32::kLdW + c];
  }
  cl32::mlp<P>(cluster, a.m, a.w, n, rank, r0, x, h2, smem_raw, L, false,
               save);
  bw32::write_rows(x, (float*)a.out + fr * D, D, r0, n, 2 * rank,
                   2 * rank + 2);
  cluster.sync();
}

// K2b's per-frame pass in fp32 at the flagship widths (see above).
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 1)
    block_bwd_cluster_fp32_kernel(const __grid_constant__ BwdArgs a) {
  using namespace bw32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, np = round16(n), warps = np / 16,
            rank = (int)cluster.block_rank(), f = blockIdx.x / kRanks,
            r0 = threadIdx.x / 32 * 16, j0 = 2 * rank, j1 = j0 + 2;
  const Dims m = a.m;
  const int inner = m.heads * D, i3 = 3 * inner, mlp = m.mlp,
            ldp = ld_probs(n);
  const Layout L(n);
  float* ks = (float*)(smem_raw + L.k);
  float* vs = (float*)(smem_raw + L.v);
  float* qs = (float*)(smem_raw + L.q);
  float* ps = (float*)(smem_raw + L.p);
  float* u = (float*)(smem_raw + L.u);
  float* part_a = (float*)(smem_raw + L.part_a);
  float* xs = (float*)(smem_raw + L.xs);
  float* x1s = (float*)(smem_raw + L.x1s);
  float* cs = (float*)(smem_raw + L.cs);
  const float* an_s = (const float*)a.w[0];
  const float* wqkv = (const float*)a.w[2];
  const float* wout = (const float*)a.w[3];
  const float* fn_s = (const float*)a.w[5];
  const float* w1 = (const float*)a.w[7];
  const float* b1 = (const float*)a.w[8];
  const float* w2 = (const float*)a.w[9];
  const size_t fr = (size_t)f * n;
  float* V = a.vec + (size_t)f * (6 * D + mlp);
  float* hid_slot = (float*)a.s[4] + fr * mlp;
  float* dpre_slot = (float*)a.s[5] + fr * mlp;
  float* dqkv = (float*)a.s[8] + fr * i3;

  // ---- the forward's first half, as K2f runs it ----
  float x[8][4];
  read_rows(x, (const float*)a.x + fr * D, D, r0, n);
  cl32::put_part(x, xs);
  BwdSave save = {(float*)a.s[0] + fr * D, (float*)a.s[2] + fr * inner,
                  (float*)a.s[3] + fr * D, qs, x1s, n, r0, rank, inner};
  float h2[8][4];
  cl32::attend<cl32::Exact>(cluster, m, a.w, n, rank, r0, x, h2, smem_raw,
                            L.fwd, false, save);

  // ---- the MLP's quarter, forward and backward: dh2's partial ----
  float dy[8][4];
  read_rows(dy, (const float*)a.dy + fr * D, D, r0, n);
  float dh2[8][4];
  zero(dh2);
  const int quarter = mlp / kRanks, c0 = rank * quarter / HC,
            nc = quarter / HC;
  auto fetch = [&](int i) {
    float* s = u + (i & 1) * 2 * D * kLdW;
    cl32::stage(s, kLdW, w1 + (c0 + i) * HC, mlp, D, HC);
    cl32::stage(s + D * kLdW, kLdW, w2 + (size_t)(c0 + i) * HC * D, D, HC,
                D);
    cp_async_commit();
  };
  fetch(0);
  for (int i = 0; i < nc; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i landed; every warp is done with i - 1
    if (i + 1 < nc) fetch(i + 1);
    const float* w1c = u + (i & 1) * 2 * D * kLdW;
    const float* b1c = b1 + (c0 + i) * HC;
    const int col0 = (c0 + i) * HC;
    float pre[8][4];
    zero(pre);
    cl32::rows_mma<cl32::Exact, tf32::A>(pre, h2, w1c);
    float v[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pre[j][e] = pre[j][e] + b1c[col_of(j, e)];
        v[j][e] = gelu<float>(pre[j][e]);
      }
    write_rows(v, hid_slot + col0, mlp, r0, n);
    zero(v);
    rows_mma_t(v, dy, w1c + D * kLdW);  // dhid = dy w2c^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = v[j][e] * gelu_grad<float>(pre[j][e]);
    write_rows(v, dpre_slot + col0, mlp, r0, n);
    rows_mma_t(dh2, v, w1c);  // dh2 += dpre w1c^T
    col_sums(v, cs, V + 6 * D + col0, warps);  // db1 from dpre
  }
  cl32::put_part(dh2, ps);
  cluster.sync();  // every rank's dh2 partial is in place
  zero(dh2);
  cl32::add_parts(cluster, ps, dh2);
  cluster.sync();  // every rank has read them: ps is free

  // ---- LN2's backward: g1 = dy + dln2 ----
  cl32::stage(u + 3 * D * kLdW, kLdW, wout + (size_t)rank * D * D, D, D, D);
  cp_async_commit();
  float g1[8][4];
  {
    float x1[8][4], xhat[8][4];
    get_part(x1, x1s);
    ln_back(x1, dh2, fn_s, r0, n, xhat, g1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g1[j][e] = dy[j][e] + g1[j][e];
    if (rank == 2) {
      mul(x1, dh2, xhat);
      col_sums(x1, cs, V + 3 * D, warps);  // fn_s
      col_sums(dh2, cs, V + 4 * D, warps);  // fn_b
    }
  }
  if (rank == 1) col_sums(g1, cs, V + 2 * D, warps);  // bout
  if (rank == 3) col_sums(dy, cs, V + 5 * D, warps);  // b2
  write_rows(g1, (float*)a.s[6] + fr * D, D, r0, n, j0, j1);
  cl32::put_part(g1, x1s);  // kept for dx

  // ---- head r's backward ----
  cp_async_wait<0>();
  __syncthreads();  // wout's slice landed
  float dov[8][4];
  zero(dov);
  rows_mma_t(dov, g1, u + 3 * D * kLdW);  // do = g1 wout_r^T
  write_rows(dov, u, kLdW, r0, np);       // the do tile, every row
  float s[kKeyTiles][4];
  {
    float q[8][4];
    read_rows(q, qs, kLdW, r0, np);
    cl32::probs<cl32::Exact>(s, q, ks, n, np, m.scale);
  }
  put_keys(s, ps, ldp, r0, np);
  __syncthreads();  // p and do of every row are in place
  float dv[8][4];
  zero(dv);
  cols_mma(dv, ps, ldp, r0, u, kLdW, np);  // dv = p^T do
  {
    float dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    keys_mma(dp, dov, vs, kLdW, np);  // dp = do v^T
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e / 2] += dp[j][e] * s[j][e];
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = (s[j][e] * (dp[j][e] - rs[e / 2])) * m.scale;  // ds
  }
  __syncthreads();  // every warp has read p and the do tile
  put_keys(s, ps, ldp, r0, np);
  for (int part = 0; part < 3; ++part)
    cl32::stage(u + part * D * kLdW, kLdW, wqkv + part * inner + rank * D,
                i3, D, D);
  cp_async_commit();
  __syncthreads();  // ds of every row is in place
  float dq[8][4], dk[8][4];
  zero(dq);
  over_keys(dq, s, ks, kLdK, np);  // dq = ds k
  zero(dk);
  cols_mma(dk, ps, ldp, r0, qs, kLdW, np);  // dk = ds^T q
  write_rows(dq, dqkv + rank * D, i3, r0, n);
  write_rows(dk, dqkv + inner + rank * D, i3, r0, n);
  write_rows(dv, dqkv + 2 * inner + rank * D, i3, r0, n);
  cp_async_wait<0>();
  __syncthreads();  // the head's wqkv slices landed
  float dh1[8][4];
  zero(dh1);
  rows_mma_t(dh1, dq, u);
  rows_mma_t(dh1, dk, u + D * kLdW);
  rows_mma_t(dh1, dv, u + 2 * D * kLdW);
  cl32::put_part(dh1, part_a);
  cluster.sync();  // every rank's dh1 partial is in place
  zero(dh1);
  cl32::add_parts(cluster, part_a, dh1);

  // ---- LN1's backward: dx = g1 + dln1 ----
  {
    float xhat[8][4], dln[8][4];
    get_part(x, xs);
    ln_back(x, dh1, an_s, r0, n, xhat, dln);
    get_part(g1, x1s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g1[j][e] = g1[j][e] + dln[j][e];
    write_rows(g1, (float*)a.dx + fr * D, D, r0, n, j0, j1);
    if (rank == 0) {
      mul(dln, dh1, xhat);
      col_sums(dln, cs, V, warps);       // an_s
      col_sums(dh1, cs, V + D, warps);   // an_b
    }
  }
  cluster.sync();  // no rank leaves while another reads its partials
}

// ---- K3's fp32 forms at the flagship widths ------------------------------
//
// K3f and K3b in fp32 at the widths of the full block's cluster forms
// (fp32_cluster_fwd in ops/fused_transformer.py; form 2 of the launches).
// The CLS-only block's work is of two kinds. Its row-heavy work (LN1 and
// the head's k and v over every row, the CLS row's q, attention and
// out-projection; in the backward, dk|dv over every row and LN1's
// backward) runs one frame over a cluster of 4 CTAs, rank r on head r,
// on tf32_block.cuh's body summed as K2f sums it (cl32::Exact). Its
// weight-heavy work, the CLS row's MLP (2 x 64 x mlp products a row, 1 MB
// of fp32 weights at mlp 2048), is a matrix product only across frames:
// the batch's CLS rows, 16 a tile, run it on the tensor cores in the same
// arithmetic (3xTF32, each 8-deep step summed from zero), the hidden
// chunks spread over a cluster of cm32::kRanks CTAs, so the weights are
// read once per 16 frames. The chunks' partial sums are added in a fixed
// order (a warp's chunks in order, the CTA's warps in order, then the
// cluster's ranks in order through distributed shared memory), with no
// atomics.
//
// K3f, two launches: cls_attend_cluster_fp32_kernel (cl32::attend with
// cls_only; rank r writes head r's q, probabilities and o into the CLS
// record, rank 0 x1 and h2; x1 goes to the output, h2 to a scratch row),
// then cls_mlp_fp32_kernel (z = h2 w1 + b1 into the record's z, the erf
// GELU, y = x1 + (b2 + gelu(z) w2) into the output).
// K3b, two launches before the weight products: cls_mlp_bwd_fp32_kernel
// (from dy and the record's z: dg = dy w2^T, dz = dg gelu'(z), dh2 = dz
// w1^T; hid, dz, h2, db1's, db2's and dfn_b's rows to the workspace) and
// cls_bwd_cluster_fp32_kernel (rank r: LN1 and head r's k and v of every
// row by cl32::project, the forward's own code, so they are K3f's bit for
// bit; the CLS row's q, p, o, x1 and h2 from the record, never
// recomputed; LN2's backward on row 0, do_r, dp, ds and dq on row 0 as
// one-row tiles, dk = ds q^T and dv = p do^T over every row, dh1's
// partial [dk | dv] [wk_r | wv_r]^T (+ row 0: dq wq_r^T) exchanged through
// distributed shared memory and added in rank order, then LN1's
// backward). The reverse pass's products take the exact three-part TF32
// split (tf32::A3), as K2b's cluster form does. The workspace slots and
// row sums are those cls_bwd_body writes, so launch_grads runs unchanged.

namespace cm32 {

namespace cg = cl32::cg;
using cl32::D;
using cl32::HC;
using cl32::kLdW;
using cl32::kPart;
using mmafwd::col_of;
using mmafwd::zero;

constexpr int kRanks = 8;      // CTAs of a cluster: a tile of 16 CLS rows
constexpr int kTileWarps = 4;  // warps a CTA, a hidden chunk at a time each
constexpr int kWarpSlots = kRanks * kTileWarps;
constexpr int kThreads = 32 * kTileWarps;
// a warp's w1 and w2 chunks (64 x 64 each, rows of kLdW floats); the
// partial tiles lie over them at the end
constexpr size_t kWarpBytes = sizeof(float) * 2 * D * kLdW;
constexpr size_t kBytes = kTileWarps * kWarpBytes;
static_assert(kRanks * 8 == D, "rank r adds column tile r");
static_assert(kThreads == 4 * 32, "a thread an entry of a column tile");

// rows x cols fp32 from device memory into the warp's shared memory by its
// own lanes (16-byte cp.async); commits nothing
__device__ __forceinline__ void warp_stage(float* s, int sld, const float* g,
                                           size_t gld, int rows, int cols) {
  const int per_row = cols / 4, lane = threadIdx.x % 32;
  for (int i = lane; i < rows * per_row; i += 32) {
    const int r = i / per_row, c = i % per_row * 4;
    cp_async16(s + (size_t)r * sld + c, g + r * gld + c);
  }
}

// hidden chunk i (64 columns) of w1 and w2 into the warp's ring, landed
__device__ __forceinline__ void fetch(float* ring, const float* w1,
                                      const float* w2, int mlp, int i) {
  __syncwarp();  // every lane is done with the last chunk
  warp_stage(ring, kLdW, w1 + i * HC, mlp, D, HC);
  warp_stage(ring + D * kLdW, kLdW, w2 + (size_t)i * HC * D, D, HC, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// The sum of every warp's tile `acc` (16 rows x 64, the accumulator
// layout) over the cluster: each CTA's warps in order, then the ranks in
// rank order onto `init(row, col)`; fn(row, col, sum) for the entries of
// column tile `rank` (rank r, thread i: entry i / 32 of lane i % 32). Every
// thread of every CTA of the cluster calls it.
template <typename Init, typename Fn>
__device__ __forceinline__ void reduce(cg::cluster_group& cluster,
                                       unsigned char* smem,
                                       const float (&acc)[8][4], int rank,
                                       Init init, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tile = (float*)smem;
  float* mine = (float*)(smem + warp * kWarpBytes) + lane;
  __syncwarp();  // the warp is done with its ring
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = acc[j][e];
  __syncthreads();  // every warp's tile is in place
  for (int i = threadIdx.x; i < kPart; i += blockDim.x) {
    float v = tile[i];
    for (int w = 1; w < kTileWarps; ++w)
      v += ((const float*)(smem + w * kWarpBytes))[i];
    tile[i] = v;
  }
  cluster.sync();  // every rank's sum is in place
  const int e = threadIdx.x / 32, at = (4 * rank + e) * 32 + lane;
  const int row = lane / 4 + 8 * (e / 2),
            col = 8 * rank + 2 * (lane % 4) + e % 2;
  float v = init(row, col);
  for (int rk = 0; rk < kRanks; ++rk)
    v += cluster.map_shared_rank(tile, rk)[at];
  fn(row, col, v);
  cluster.sync();  // no rank leaves while another reads its sum
}

}  // namespace cm32

// What K3f's cluster form writes besides its records: x1 of the CLS rows
// (into the output, which the MLP launch completes) and h2 (a scratch row
// a frame); with a probe's pointers also h1 (B, n, d), o (B, inner), and
// the head's k and v of every row (B, n, inner) each.
struct ClsOut32 {
  float *h2, *h1, *o, *k, *v;
};

// The hooks of K3f's cluster form for frame f (see ClsOut32): the record
// `rec` (null when autograd does not record) takes head r's q, its n
// probabilities and its o from rank r, x1 and h2 from rank 0.
struct ClsSave32 {
  float* rec;
  ClsSave sl;
  float *x1p, *h2p, *h1p, *op;
  int n, r0, rank, inner;
  __device__ __forceinline__ void h1(const float (&v)[8][4]) {
    if (h1p) bw32::write_rows(v, h1p, cl32::D, r0, n, 2 * rank, 2 * rank + 2);
  }
  __device__ __forceinline__ void q(const float (&v)[8][4]) {
    if (rec) bw32::write_rows(v, rec + rank * cl32::D, cl32::D, 0, 1);
  }
  __device__ __forceinline__ void p(const float (&s)[mmafwd::kKeyTiles][4]) {
    if (!rec || threadIdx.x % 32 >= 4) return;  // row 0: lanes 0-3
    float* pr = rec + sl.p + rank * n;
#pragma unroll
    for (int j = 0; j < mmafwd::kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = mmafwd::col_of(j, e);
        if (key < n) pr[key] = s[j][e];
      }
  }
  __device__ __forceinline__ void o(const float (&v)[8][4]) {
    if (rec) bw32::write_rows(v, rec + sl.o + rank * cl32::D, cl32::D, 0, 1);
    if (op) bw32::write_rows(v, op + rank * cl32::D, inner, 0, 1);
  }
  __device__ __forceinline__ void x1h2(const float (&x1)[8][4],
                                       const float (&h2)[8][4]) {
    if (rank != 0) return;
    bw32::write_rows(x1, x1p, cl32::D, 0, 1);
    bw32::write_rows(h2, h2p, cl32::D, 0, 1);
    if (rec) {
      bw32::write_rows(x1, rec + sl.x1, cl32::D, 0, 1);
      bw32::write_rows(h2, rec + sl.h2, cl32::D, 0, 1);
    }
  }
  __device__ __forceinline__ void hid(const float (&)[8][4], int) {}
};

// A CTA of cls_attend_cluster_fp32_kernel: cl32::Layout's attention tiles
// (the head's k and v of every row, its q|k|v and wout slices), the
// out-projection's partial tile over the q|k|v slices (only the warp of
// row 0 writes it, after every warp has projected), no MLP ring.
struct ClsFwdLayout {
  cl32::Layout fwd;
  size_t total;
  __host__ __device__ explicit ClsFwdLayout(int n) : fwd(n, 0) {
    fwd.part_a = fwd.wq;
    total = align16(fwd.wo + sizeof(float) * cl32::D * cl32::kLdW);
    fwd.total = total;
  }
};

// K3f's first launch in fp32 (see above): one frame over a cluster of 4
// CTAs, cl32::attend with cls_only, two CTAs an SM (its registers held
// to 204 a thread, a few spilled: so all 32 clusters of B=32 run at once
// where a CTA an SM ran about 30).
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 2)
    cls_attend_cluster_fp32_kernel(const __grid_constant__ FwdArgs a,
                                   ClsOut32 out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank(),
            f = blockIdx.x / cl32::kRanks, r0 = threadIdx.x / 32 * 16;
  const int D = cl32::D, inner = a.m.heads * D;
  const ClsFwdLayout L(n);
  const size_t fr = (size_t)f * n;
  mmafwd::Rows x;
  bw32::read_rows(x, (const float*)a.x + fr * D, D, r0, n);
  ClsSave32 save = {a.sv.base ? a.sv.at(f) : nullptr, a.sv,
                    (float*)a.out + (size_t)f * D, out.h2 + (size_t)f * D,
                    out.h1 ? out.h1 + fr * D : nullptr,
                    out.o ? out.o + (size_t)f * inner : nullptr,
                    n, r0, rank, inner};
  float h2[8][4];
  cl32::attend<cl32::Exact>(cluster, a.m, a.w, n, rank, r0, x, h2, smem_raw,
                            L.fwd, true, save);
  if (out.k) {  // a probe: the head's k and v of every row
    const float* ks = (const float*)(smem_raw + L.fwd.k);
    const float* vs = (const float*)(smem_raw + L.fwd.v);
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const size_t at = (fr + r) * inner + rank * D + c;
      out.k[at] = ks[(size_t)r * cl32::kLdK + c];
      out.v[at] = vs[(size_t)r * cl32::kLdW + c];
    }
  }
  cluster.sync();  // no rank leaves while another reads its partials
}

// K3f's second launch in fp32: the MLP of the batch's CLS rows, 16 a
// cluster of cm32::kRanks CTAs, hidden chunk c on warp slot c mod
// cm32::kWarpSlots. x1 is in the output, h2 in h2s (batch, d); z goes to the
// records when autograd records, the GELU values to hid in a probe.
__global__ void __launch_bounds__(cm32::kThreads, 1)
    cls_mlp_fp32_kernel(const __grid_constant__ FwdArgs a, const float* h2s,
                        float* hid, int batch) {
  using namespace cm32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), f0 = blockIdx.x / kRanks * 16,
            rows = batch - f0 < 16 ? batch - f0 : 16,
            warp = threadIdx.x / 32, mlp = a.m.mlp;
  const float* w1 = (const float*)a.w[7];
  const float* b1 = (const float*)a.w[8];
  const float* w2 = (const float*)a.w[9];
  const float* b2 = (const float*)a.w[10];
  float* ring = (float*)(smem_raw + warp * kWarpBytes);
  float* rec = a.sv.base ? a.sv.at(f0) : nullptr;
  float h2[8][4], y[8][4];
  cl32::read_rows(h2, h2s + (size_t)f0 * D, D, 0, rows);
  zero(y);
  for (int c = rank * kTileWarps + warp; c < mlp / HC; c += kWarpSlots) {
    fetch(ring, w1, w2, mlp, c);
    float z[8][4];
    zero(z);
    cl32::rows_mma<cl32::Exact, tf32::A>(z, h2, ring);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = z[j][e] + b1[c * HC + col_of(j, e)];
    if (rec) bw32::write_rows(z, rec + a.sv.z + c * HC, a.sv.stride, 0, rows);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = gelu<float>(z[j][e]);
    if (hid) bw32::write_rows(z, hid + (size_t)f0 * mlp + c * HC, mlp, 0, rows);
    cl32::rows_mma<cl32::Exact, tf32::A>(y, z, ring + D * kLdW);
  }
  float* out = (float*)a.out + (size_t)f0 * D;
  reduce(cluster, smem_raw, y, rank, [&](int, int col) { return b2[col]; },
         [&](int row, int col, float v) {
           if (row < rows) out[row * D + col] = out[row * D + col] + v;
         });
}

// K3b's first launch in fp32: the MLP's backward on the batch's CLS rows,
// 16 a cluster as cls_mlp_fp32_kernel: dg = dy w2^T, dz = dg gelu'(z)
// (z from the records), dh2 = dz w1^T; hid = gelu(z) and dz to their
// slots, dz as db1's row sum; dh2 (dfn_b's row sum), dy (db2's) and the
// record's h2 (its slot) by the rank's column tile.
__global__ void __launch_bounds__(cm32::kThreads, 1)
    cls_mlp_bwd_fp32_kernel(const __grid_constant__ BwdArgs a, int batch) {
  using namespace cm32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), f0 = blockIdx.x / kRanks * 16,
            rows = batch - f0 < 16 ? batch - f0 : 16,
            warp = threadIdx.x / 32, mlp = a.m.mlp, L_ = 6 * D + mlp;
  const float* w1 = (const float*)a.w[7];
  const float* w2 = (const float*)a.w[9];
  float* ring = (float*)(smem_raw + warp * kWarpBytes);
  const float* rec = a.sv.at(f0);
  const float* dyp = (const float*)a.dy + (size_t)f0 * D;
  float* V = a.vec + (size_t)f0 * L_;
  float dy[8][4], dh2[8][4];
  cl32::read_rows(dy, dyp, D, 0, rows);
  zero(dh2);
  for (int c = rank * kTileWarps + warp; c < mlp / HC; c += kWarpSlots) {
    fetch(ring, w1, w2, mlp, c);
    float z[8][4], g[8][4];
    cl32::read_rows(z, rec + a.sv.z + c * HC, a.sv.stride, 0, rows);
    zero(g);
    bw32::rows_mma_t(g, dy, ring + D * kLdW);  // dg = dy w2c^T
    float hv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hv[j][e] = gelu<float>(z[j][e]);
        g[j][e] = g[j][e] * gelu_grad<float>(z[j][e]);
      }
    const size_t col0 = (size_t)f0 * mlp + c * HC;
    bw32::write_rows(hv, (float*)a.s[4] + col0, mlp, 0, rows);
    bw32::write_rows(g, (float*)a.s[5] + col0, mlp, 0, rows);
    bw32::write_rows(g, V + 6 * D + c * HC, L_, 0, rows);  // db1
    bw32::rows_mma_t(dh2, g, ring);  // dh2 += dz w1c^T
  }
  float* h2_slot = (float*)a.s[3] + (size_t)f0 * D;
  reduce(cluster, smem_raw, dh2, rank, [](int, int) { return 0.f; },
         [&](int row, int col, float v) {
           if (row >= rows) return;
           V[(size_t)row * L_ + 4 * D + col] = v;         // dfn_b: dh2
           V[(size_t)row * L_ + 5 * D + col] = dyp[row * D + col];  // db2
           h2_slot[row * D + col] =
               rec[(size_t)row * a.sv.stride + a.sv.h2 + col];
         });
}

// A CTA of cls_bwd_cluster_fp32_kernel: the forward's tiles (cl32::Layout:
// the head's k and v of every row, its q|k|v and wout slices), the same
// bytes as ClsFwdLayout's, so two CTAs fit an SM. Once the CLS row's
// reverse is done (a __syncthreads), k and v are free: dh1's partial
// tile (16 x 64 a warp) lies over k, the column sums by warp over v;
// row 0's ds, p, do and q lie over the wout slice, which only the warp of
// row 0 reads, before it writes them.
struct ClsBwdLayout {
  cl32::Layout fwd;
  size_t part, cs, ds, p, dov, qv, total;
  __host__ __device__ explicit ClsBwdLayout(int n) : fwd(n, 0) {
    using mmafwd::take;
    const size_t np = round16(n);
    part = fwd.k;
    cs = fwd.v;
    size_t o = fwd.wo;
    ds = take(o, sizeof(float) * np);
    p = take(o, sizeof(float) * np);
    dov = take(o, sizeof(float) * cl32::D);
    qv = take(o, sizeof(float) * cl32::D);
    total = align16(fwd.wo + sizeof(float) * cl32::D * cl32::kLdW);
    fwd.part_a = part;
    fwd.total = total;
  }
};

// What K3b's cluster form keeps of cl32::project: h1 by the rank's column
// tiles (its slot).
struct ClsBwdSave : cl32::NoSave {
  float* h1p;
  int n, r0, rank;
  __device__ __forceinline__ void h1(const float (&v)[8][4]) {
    bw32::write_rows(v, h1p, cl32::D, r0, n, 2 * rank, 2 * rank + 2);
  }
};

// K3b's second launch in fp32: the per-frame pass over a cluster of 4
// CTAs (see above), two CTAs an SM.
__global__ void __launch_bounds__(mmafwd::kMaxThreads / mmafwd::kFrames, 2)
    cls_bwd_cluster_fp32_kernel(const __grid_constant__ BwdArgs a) {
  using namespace bw32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cl32::cg::cluster_group cluster = cl32::cg::this_cluster();
  const int n = a.n, np = round16(n), warps = np / 16,
            rank = (int)cluster.block_rank(), f = blockIdx.x / kRanks,
            r0 = threadIdx.x / 32 * 16, j0 = 2 * rank, j1 = j0 + 2;
  const Dims m = a.m;
  const int inner = m.heads * D, i2 = 2 * inner, mlp = m.mlp;
  const ClsBwdLayout L(n);
  const float* ks = (const float*)(smem_raw + L.fwd.k);
  const float* vs = (const float*)(smem_raw + L.fwd.v);
  const float* wq = (const float*)(smem_raw + L.fwd.wq);
  const float* wo = (const float*)(smem_raw + L.fwd.wo);
  float* part = (float*)(smem_raw + L.part);
  float* cs = (float*)(smem_raw + L.cs);
  float* dsv = (float*)(smem_raw + L.ds);
  float* pv = (float*)(smem_raw + L.p);
  float* dov = (float*)(smem_raw + L.dov);
  float* qv = (float*)(smem_raw + L.qv);
  const float* an_s = (const float*)a.w[0];
  const float* fn_s = (const float*)a.w[5];
  const size_t fr = (size_t)f * n;
  const ClsSave sl = a.sv;
  const float* rec = sl.at(f);
  float* V = a.vec + (size_t)f * (6 * D + mlp);
  const int lane = threadIdx.x % 32;

  // ---- LN1 and head r's k and v of every row, as K3f computed them ----
  float x[8][4], unused[8][4];
  read_rows(x, (const float*)a.x + fr * D, D, r0, n);
  ClsBwdSave save;
  save.h1p = (float*)a.s[0] + fr * D;
  save.n = n;
  save.r0 = r0;
  save.rank = rank;
  cl32::project<cl32::Exact>(m, a.w, n, rank, r0, x, unused, smem_raw, L.fwd,
                             false, save);
  {  // k|v to its slot (wqkv's column order), as cls_bwd_body writes it
    float* KV = (float*)a.s[1] + fr * i2;
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      KV[(size_t)r * i2 + rank * D + c] = ks[(size_t)r * kLdK + c];
      KV[(size_t)r * i2 + inner + rank * D + c] = vs[(size_t)r * kLdW + c];
    }
  }

  // ---- the CLS row's reverse on the warp of row 0 (one-row tiles) ----
  float g1[8][4], dq[8][4];
  zero(g1);
  zero(dq);
  if (r0 == 0) {
    float x1[8][4], dh2[8][4], dy[8][4], xhat[8][4];
    read_rows(x1, rec + sl.x1, D, 0, 1);
    read_rows(dh2, V + 4 * D, D, 0, 1);
    read_rows(dy, (const float*)a.dy + (size_t)f * D, D, 0, 1);
    ln_back(x1, dh2, fn_s, 0, 1, xhat, g1);  // g1 = dy + LN2^T(dh2)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g1[j][e] = dy[j][e] + g1[j][e];
    if (rank == 0) {
      mul(x1, dh2, xhat);
      write_rows(x1, V + 3 * D, D, 0, 1);  // dfn_s
      write_rows(g1, V + 2 * D, D, 0, 1);  // dbout
      write_rows(g1, (float*)a.s[6] + (size_t)f * D, D, 0, 1);
    }
    float d_o[8][4];
    zero(d_o);
    rows_mma_t(d_o, g1, wo);  // do_r = g1 wout_r^T
    write_rows(d_o, (float*)a.s[7] + (size_t)f * inner + rank * D, D, 0, 1);
    // the forward's probabilities of head r (row 0), dp = do v^T, ds
    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = col_of(j, e);
        s[j][e] = lane < 4 && e < 2 && key < n ? rec[sl.p + rank * n + key]
                                               : 0.f;
        dp[j][e] = 0.f;
      }
    keys_mma(dp, d_o, vs, kLdW, np);
    __syncwarp();  // every lane is done with wout, whose region takes row 0
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) rs += dp[j][e] * s[j][e];
    rs = quad_sum(rs);
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = col_of(j, e);
          if (key < np) {
            pv[key] = s[j][e];
            dp[j][e] = (s[j][e] * (dp[j][e] - rs)) * m.scale;  // ds
            dsv[key] = dp[j][e];
          }
        }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 2; e < 4; ++e) dp[j][e] = 0.f;
    if (lane >= 4)
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) dp[j][e] = 0.f;
    over_keys(dq, dp, ks, kLdK, np);  // dq = ds k
    const size_t at = (size_t)f * inner + rank * D;
    write_rows(dq, (float*)a.s[10] + at, D, 0, 1);
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) dov[col_of(j, e)] = d_o[j][e];
    for (int c = lane; c < D; c += 32) {
      qv[c] = rec[rank * D + c];
      ((float*)a.s[9])[at + c] = rec[rank * D + c];
      ((float*)a.s[2])[at + c] = rec[sl.o + rank * D + c];
    }
  }
  __syncthreads();  // row 0's ds, p, do and q are in place

  // ---- dk = ds q^T, dv = p do^T over every row; dh1 ----
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_of(r0, e), c = col_of(j, e);
      dk[j][e] = dsv[r] * qv[c];
      dv[j][e] = pv[r] * dov[c];
    }
  float* dkv = (float*)a.s[8] + fr * i2;
  write_rows(dk, dkv + rank * D, i2, r0, n);
  write_rows(dv, dkv + inner + rank * D, i2, r0, n);
  float dh1[8][4];
  zero(dh1);
  rows_mma_t(dh1, dk, wq + D * kLdW);
  rows_mma_t(dh1, dv, wq + 2 * D * kLdW);
  if (r0 == 0) rows_mma_t(dh1, dq, wq);  // row 0: dq wq_r^T
  cl32::put_part(dh1, part);
  cluster.sync();  // every rank's dh1 partial is in place
  zero(dh1);
  cl32::add_parts(cluster, part, dh1);

  // ---- LN1's backward: dx = LN1^T(dh1) (+ g1 on row 0) ----
  {
    float xhat[8][4], dln[8][4];
    ln_back(x, dh1, an_s, r0, n, xhat, dln);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = dln[j][e] + g1[j][e];
    write_rows(x, (float*)a.dx + fr * D, D, r0, n, j0, j1);
    if (rank == 0) {
      mul(dln, dh1, xhat);
      col_sums(dln, cs, V, warps);      // dan_s
      col_sums(dh1, cs, V + D, warps);  // dan_b
    }
  }
  cluster.sync();  // no rank leaves while another reads its partials
}

// A launch of a cm32 kernel over the batch's tiles of 16 CLS rows, a
// cluster of cm32::kRanks CTAs a tile. Returns a cudaError_t.
template <typename Kernel, typename... Ts>
int launch_cls_mlp(Kernel kernel, int batch, cudaStream_t s, Ts... args) {
  size_t limit = 0;
  cudaError_t err = (cudaError_t)smem_opt_in(kernel, &limit);
  if (err != cudaSuccess) return err;
  if (cm32::kBytes > limit) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cm32::kRanks * ((batch + 15) / 16), 1, 1);
  cfg.blockDim = dim3(cm32::kThreads, 1, 1);
  cfg.dynamicSmemBytes = cm32::kBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cm32::kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The per-frame pass of the CLS-only block's backward for frame f: the
// body of K3b's kernel and of the last block of K6's. kRecompute: the body
// before fault k's repair, which recomputes the CLS row instead of reading
// its record (only the measurement kernels cls_bwd_recompute_kernel and
// trunk_bwd_recompute_kernel take it).
template <typename T, bool kRecompute>
__device__ __forceinline__ void cls_bwd_body(const BwdArgs& a, int f,
                                             unsigned char* smem_raw) {
  const Dims m = a.m;
  const int n = a.n, d = m.d, dh = m.dh, inner = m.heads * dh,
            i2 = 2 * inner, i3 = 3 * inner, mlp = m.mlp;
  const BwdSmem L(n, d, m.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  float* x1 = (float*)(smem_raw + L.x1);    // CLS row
  float* acc = (float*)(smem_raw + L.acc);
  float* g1 = (float*)(smem_raw + L.g1);    // CLS row
  float* mean1 = (float*)(smem_raw + L.stats);
  float* rstd1 = mean1 + n;
  float* mean2 = rstd1 + n;
  float* rstd2 = mean2 + 1;
  float* pb = (float*)(smem_raw + L.pb);    // heads x n CLS probabilities
  float* dpb = (float*)(smem_raw + L.dpb);  // MLP chunk, then heads x n ds
  const T* an_s = (const T*)a.w[0];
  const T* an_b = (const T*)a.w[1];
  const T* wqkv = (const T*)a.w[2];
  const T* wout = (const T*)a.w[3];
  const T* bout = (const T*)a.w[4];
  const T* fn_s = (const T*)a.w[5];
  const T* fn_b = (const T*)a.w[6];
  const T* w1 = (const T*)a.w[7];
  const T* b1 = (const T*)a.w[8];
  const T* w2 = (const T*)a.w[9];
  const size_t fr = (size_t)f * n;
  const T* x = (const T*)a.x + fr * d;
  const T* dy = (const T*)a.dy + (size_t)f * d;
  T* dx = (T*)a.dx + fr * d;
  T* H1 = (T*)a.s[0] + fr * d;
  T* KV = (T*)a.s[1] + fr * i2;
  T* O = (T*)a.s[2] + (size_t)f * inner;
  T* H2 = (T*)a.s[3] + (size_t)f * d;
  T* HID = (T*)a.s[4] + (size_t)f * mlp;
  T* DPRE = (T*)a.s[5] + (size_t)f * mlp;
  T* G1C = (T*)a.s[6] + (size_t)f * d;
  T* DO = (T*)a.s[7] + (size_t)f * inner;
  T* DKV = (T*)a.s[8] + fr * i2;
  T* Q = (T*)a.s[9] + (size_t)f * inner;
  T* DQ = (T*)a.s[10] + (size_t)f * inner;
  float* V = a.vec + (size_t)f * (6 * d + mlp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const ClsSave sl = a.sv;
  const float* sv = kRecompute ? nullptr : sl.at(f);

  // ---- LN1 (all rows) -> k/v (all rows); the CLS row's q, probabilities,
  // o, x1, h2 from the forward's record (recomputed with kRecompute) --------
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  layernorm_stats(x32, n, d, mean1, rstd1);
  layernorm_rows<T>(x32, n, d, an_s, an_b, H1);
  __syncthreads();
  matmul(H1, d, n, wqkv, i3, d, i2, [=](int c) { return inner + c; },
         [=](int r, int c, float v) { KV[(size_t)r * i2 + c] = fromf<T>(v); });
  if (!kRecompute) {
    for (int c = threadIdx.x; c < inner; c += blockDim.x) {
      Q[c] = fromf<T>(sv[c]);
      O[c] = fromf<T>(sv[sl.o + c]);
    }
    for (int i = threadIdx.x; i < m.heads * n; i += blockDim.x)
      pb[i] = sv[sl.p + i];
    for (int c = threadIdx.x; c < d; c += blockDim.x) x1[c] = sv[sl.x1 + c];
  } else {
    matmul(H1, d, 1, wqkv, i3, d, inner, Ident(),
           [=](int r, int c, float v) { Q[c] = fromf<T>(v); });
    __syncthreads();
    // attention of the CLS row, one warp per head; p kept for the backward
    for (int hd = warp; hd < m.heads; hd += kWarps) {
      float* p = pb + (size_t)hd * n;
      const T* v = KV + inner + hd * dh;
      softmax_row<T>(Q + hd * dh, KV + hd * dh, i2, n, dh, m.scale, p);
      for (int c = lane; c < dh; c += 32) {
        float s = 0.f;
        for (int j = 0; j < n; ++j)
          s = fmaf(rt<T>(p[j]), tof(v[(size_t)j * i2 + c]), s);
        O[hd * dh + c] = fromf<T>(s);
      }
    }
    __syncthreads();
    matmul(O, inner, 1, wout, d, inner, d, Ident(),
           [=](int r, int c, float v) { x1[c] = x32[c] + (v + tof(bout[c])); });
  }
  __syncthreads();
  layernorm_stats(x1, 1, d, mean2, rstd2);
  if (!kRecompute)
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      H2[c] = fromf<T>(sv[sl.h2 + c]);
  else
    layernorm_rows<T>(x1, 1, d, fn_s, fn_b, H2);
  for (int c = threadIdx.x; c < d; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();

  // ---- MLP forward + backward on the CLS row: acc row 0 = dh2 ----------
  for (int c0 = 0; c0 < mlp; c0 += m.hc) {
    const int hc = min(m.hc, mlp - c0);
    if (!kRecompute)
      for (int c = threadIdx.x; c < hc; c += blockDim.x) {
        const float z = sv[sl.z + c0 + c];
        dpb[c] = z;
        HID[c0 + c] = fromf<T>(gelu<T>(z));
      }
    else
      matmul(H2, d, 1, w1, mlp, d, hc, [=](int c) { return c0 + c; },
             [=](int r, int c, float v) {
               const float p = v + tof(b1[c0 + c]);
               dpb[c] = p;
               HID[c0 + c] = fromf<T>(gelu<T>(p));
             });
    __syncthreads();
    mm(1, hc, d, [=](int r, int k) { return tof(dy[k]); },
       [=](int k, int c) { return tof(w2[(size_t)(c0 + c) * d + k]); },
       [=](int r, int c, float v) { dpb[c] = v * gelu_grad<T>(dpb[c]); });
    __syncthreads();
    for (int c = threadIdx.x; c < hc; c += blockDim.x) {
      V[6 * d + c0 + c] = dpb[c];  // db1: one row, the unrounded dpre
      const float v = rt<T>(dpb[c]);
      dpb[c] = v;
      DPRE[c0 + c] = fromf<T>(v);
    }
    __syncthreads();
    mm(1, d, hc, [=](int r, int k) { return dpb[k]; },
       [=](int k, int c) { return tof(w1[(size_t)c * mlp + c0 + k]); },
       [=](int r, int c, float v) { acc[c] += v; });
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) V[5 * d + c] = tof(dy[c]);
  ln_bwd<T>(x1, mean2, rstd2, acc, 1, d, fn_s, V + 3 * d, V + 4 * d,
            [=](int r, int c, float v) { g1[c] = tof(dy[c]) + v; });
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    G1C[c] = fromf<T>(g1[c]);
    V[2 * d + c] = g1[c];  // dbout
  }
  __syncthreads();
  mm(1, inner, d, [=](int r, int k) { return tof(G1C[k]); },
     [=](int k, int c) { return tof(wout[(size_t)c * d + k]); },
     [=](int r, int c, float v) { DO[c] = fromf<T>(v); });
  __syncthreads();

  // ---- attention backward, one warp per head ----------------------------
  for (int hd = warp; hd < m.heads; hd += kWarps) {
    const float* p = pb + (size_t)hd * n;
    float* ds = dpb + (size_t)hd * n;
    const T* qh = Q + hd * dh;
    const T* kh = KV + hd * dh;
    const T* vh = KV + inner + hd * dh;
    const T* doh = DO + hd * dh;
    for (int j = lane; j < n; j += 32) {
      float s = 0.f;
      for (int e = 0; e < dh; ++e)
        s = fmaf(tof(doh[e]), tof(vh[(size_t)j * i2 + e]), s);
      ds[j] = s;  // dp
      const float pc = rt<T>(p[j]);
      for (int e = 0; e < dh; ++e)  // dv = p_c^T @ do
        DKV[(size_t)j * i2 + inner + hd * dh + e] = fromf<T>(pc * tof(doh[e]));
    }
    __syncwarp();
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += ds[j] * p[j];
    s = warp_sum(s);
    for (int j = lane; j < n; j += 32)
      ds[j] = rt<T>((p[j] * (ds[j] - s)) * m.scale);
    __syncwarp();
    for (int e = lane; e < dh; e += 32) {  // dq = ds @ k
      float t = 0.f;
      for (int j = 0; j < n; ++j)
        t = fmaf(ds[j], tof(kh[(size_t)j * i2 + e]), t);
      DQ[hd * dh + e] = fromf<T>(t);
    }
    for (int j = lane; j < n; j += 32)  // dk = ds^T @ q
      for (int e = 0; e < dh; ++e)
        DKV[(size_t)j * i2 + hd * dh + e] = fromf<T>(ds[j] * tof(qh[e]));
  }
  __syncthreads();
  // dh1: the k/v path on every row, plus the q path on the CLS row
  mm(n, d, i2, [=](int r, int k) { return tof(DKV[(size_t)r * i2 + k]); },
     [=](int k, int c) { return tof(wqkv[(size_t)c * i3 + inner + k]); },
     [=](int r, int c, float v) { acc[(size_t)r * d + c] = v; });
  __syncthreads();
  mm(1, d, inner, [=](int r, int k) { return tof(DQ[k]); },
     [=](int k, int c) { return tof(wqkv[(size_t)c * i3 + k]); },
     [=](int r, int c, float v) { acc[c] += v; });
  __syncthreads();
  ln_bwd<T>(x32, mean1, rstd1, acc, n, d, an_s, V, V + d,
            [=](int r, int c, float v) {
              dx[(size_t)r * d + c] = fromf<T>(r == 0 ? v + g1[c] : v);
            });
}

// ---- the bf16 CLS-only backward on the tensor cores ----------------------
//
// The same function as cls_bwd_body<bf16>, with its rounding points (k, v,
// dpre, g1, do, ds, dq and dk|dv rounded to bf16 where it rounds them; q,
// o, h2 and hid as the forward rounded them, from its record). Its two
// products over every row of the frame run on mma.sync tiles as
// block_bwd_mma runs them: per head, k and v are projected from h1 (a
// bf16 tile in shared memory, rows padded to a multiple of 16 with zeros)
// with the head's k|v columns of wqkv (staged by cp.async, the next
// head's slice in flight), and the head's dk|dv tile times the same slice
// read as [N][K] is added into the fp32 dh1 tile. The CLS row's forward
// (q, the probabilities, o, x1, h2, the MLP pre-activations) comes from
// the record; its backward products (the w2 matvec, dh2, do, dp, dq, and
// dq's part of dh1) are the FMA body's fp32 chains, term by term in the
// same order, on the CUDA cores: one row gives a tensor core nothing to
// do. Their operands are read from shared memory, their weights from
// device memory (L2) in 16-byte loads; the MLP runs every hidden column
// at once, eight a thread, and dh2's partial sums over chunks of
// kClsChunk hidden columns are taken in parallel, then added in chunk
// order as the FMA body adds them. k and v are projected in the head
// loop rather than kept, so the layout does not grow with the heads.
// k, v and dk|dv never go to device memory but for dk|dv's slot, which
// the weight product h1^T dk|dv reads (and, with kRecompute, k|v's
// slot, for the measurement).
//
// Widths: d = dim_head = 64, n <= 80 rows, mlp a multiple of 64 (the
// checks of mma_body_takes), any number of heads.

constexpr int kLdKv = 2 * kMmaD + 8;  // row stride of a head's k|v tiles
constexpr int kClsChunk = 128;        // dh2's hidden columns a partial sum

// Shared memory of cls_bwd_mma for n rows, inner = heads x 64 and an
// mlp-wide MLP: what lives through the whole pass, two buffers of a head's
// k|v slice of wqkv, then one region that the head loops (k, v, dk|dv) and
// the MLP (the rounded dpre, dh2's partial sums) lay out in turn.
struct ClsMmaSmem {
  size_t x32, acc, stats, h1, q, o, dq, dob, dy, x1, g1, h2, g1c, p, ds, w,
      k, v, dkv, dpre, part, total;
  __host__ __device__ ClsMmaSmem(int n, int inner, int mlp) {
    const size_t np = round16(n), rows = sizeof(float) * n * kMmaD,
                 tile = sizeof(bf16) * np * kLd,
                 wkv = sizeof(bf16) * kMmaD * kLdKv,
                 vec = sizeof(bf16) * inner, d32 = sizeof(float) * kMmaD,
                 d16 = sizeof(bf16) * kMmaD;
    const int chunks = (mlp + kClsChunk - 1) / kClsChunk;
    size_t at = 0;
    x32 = take(at, rows);
    acc = take(at, rows);
    stats = take(at, sizeof(float) * (2 * n + 2));
    h1 = take(at, tile);
    q = take(at, vec);
    o = take(at, vec);
    dq = take(at, vec);
    dob = take(at, vec);
    dy = take(at, d32);
    x1 = take(at, d32);
    g1 = take(at, d32);
    h2 = take(at, d16);
    g1c = take(at, d16);
    p = take(at, sizeof(float) * n);
    ds = take(at, sizeof(float) * n);
    w = take(at, 2 * wkv);
    const size_t u = at;
    k = take(at, tile);
    v = take(at, tile);
    dkv = take(at, sizeof(bf16) * np * kLdKv);
    const size_t heads_end = at;
    at = u;
    dpre = take(at, sizeof(bf16) * mlp);
    part = take(at, sizeof(float) * chunks * kMmaD);
    total = heads_end > at ? heads_end : at;
  }
};

// the eight bf16 values of a 16-byte load from device memory, as floats
__device__ __forceinline__ void load8(float (&out)[8], const bf16* g) {
  const uint4 raw = *reinterpret_cast<const uint4*>(g);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = tof(b[i]);
}

// The per-frame pass of the CLS-only block's backward for frame f, bf16,
// on the tensor cores; the same operands, slots and row sums as
// cls_bwd_body (its kv slot stays unwritten: no weight product reads
// it). kRecompute as for cls_bwd_body.
template <bool kRecompute>
__device__ __forceinline__ void cls_bwd_mma(const BwdArgs& a, int f,
                                            unsigned char* smem_raw) {
  using T = bf16;
  constexpr int D = kMmaD, DH = kMmaD;
  const Dims m = a.m;
  const int n = a.n, np = round16(n), heads = m.heads, inner = heads * DH,
            i2 = 2 * inner, i3 = 3 * inner, mlp = m.mlp;
  const ClsMmaSmem L(n, inner, mlp);
  float* x32 = (float*)(smem_raw + L.x32);
  float* acc = (float*)(smem_raw + L.acc);  // row 0: dh2; then dh1
  float* mean1 = (float*)(smem_raw + L.stats);
  float* rstd1 = mean1 + n;
  float* mean2 = rstd1 + n;
  float* rstd2 = mean2 + 1;
  T* h1s = (T*)(smem_raw + L.h1);
  T* qs = (T*)(smem_raw + L.q);     // CLS-row vectors, inner wide
  T* os = (T*)(smem_raw + L.o);
  T* dqs = (T*)(smem_raw + L.dq);
  T* dos = (T*)(smem_raw + L.dob);
  float* dys = (float*)(smem_raw + L.dy);  // CLS-row vectors, d wide
  float* x1 = (float*)(smem_raw + L.x1);
  float* g1 = (float*)(smem_raw + L.g1);
  T* h2s = (T*)(smem_raw + L.h2);
  T* g1c = (T*)(smem_raw + L.g1c);
  float* p = (float*)(smem_raw + L.p);     // one head's probabilities
  float* ds = (float*)(smem_raw + L.ds);   // one head's dp, then ds
  T* ws = (T*)(smem_raw + L.w);
  T* k = (T*)(smem_raw + L.k);
  T* v = (T*)(smem_raw + L.v);
  T* dkv = (T*)(smem_raw + L.dkv);
  T* dpre = (T*)(smem_raw + L.dpre);
  float* part = (float*)(smem_raw + L.part);
  const T* an_s = (const T*)a.w[0];
  const T* an_b = (const T*)a.w[1];
  const T* wqkv = (const T*)a.w[2];
  const T* wout = (const T*)a.w[3];
  const T* bout = (const T*)a.w[4];
  const T* fn_s = (const T*)a.w[5];
  const T* fn_b = (const T*)a.w[6];
  const T* w1 = (const T*)a.w[7];
  const T* b1 = (const T*)a.w[8];
  const T* w2 = (const T*)a.w[9];
  const size_t fr = (size_t)f * n;
  const T* x = (const T*)a.x + fr * D;
  const T* dy = (const T*)a.dy + (size_t)f * D;
  T* dx = (T*)a.dx + fr * D;
  T* H1 = (T*)a.s[0] + fr * D;
  T* O = (T*)a.s[2] + (size_t)f * inner;
  T* H2 = (T*)a.s[3] + (size_t)f * D;
  T* HID = (T*)a.s[4] + (size_t)f * mlp;
  T* DPRE = (T*)a.s[5] + (size_t)f * mlp;
  T* G1C = (T*)a.s[6] + (size_t)f * D;
  T* DO = (T*)a.s[7] + (size_t)f * inner;
  T* DKV = (T*)a.s[8] + fr * i2;
  T* Q = (T*)a.s[9] + (size_t)f * inner;
  T* DQ = (T*)a.s[10] + (size_t)f * inner;
  float* V = a.vec + (size_t)f * (6 * D + mlp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // slice i of the 2 x heads the pass walks (the forward's heads, then the
  // backward's): the k|v columns of head i % heads, into buffer i % 2
  auto stage = [&](int i) {
    T* s = ws + (i % 2) * D * kLdKv;
    const int hd = i % heads;
    for (int kv = 0; kv < 2; ++kv)
      stage_rows(s + kv * DH, kLdKv, wqkv + (kv + 1) * inner + hd * DH, i3,
                 D, DH);
    cp_async_commit();
  };
  // k and v of a head (its slice in w) from h1s, rounded
  auto project_kv = [&](const T* w) {
    block_mma<false, false>(np, 2 * DH, D, h1s, kLd, w, kLdKv,
                            [=](int r, int c, float v0, float v1) {
                              put2(c < DH ? k : v, kLd, r, c % DH, v0, v1);
                            });
  };

  // ---- LN1 (all rows); the CLS row's q, o, x1 and h2 from the forward's
  // record. With kRecompute (a measurement of fault k): q, then per head k/v
  // (all rows, to slot 1) and the CLS row's attention, x1 and LN2
  // recomputed as single-row chains --------------------------------------
  const ClsSave sl = a.sv;
  const float* sv = kRecompute ? nullptr : sl.at(f);
  stage(kRecompute ? 0 : heads);
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) x32[i] = tof(x[i]);
  for (int c = threadIdx.x; c < D; c += blockDim.x) dys[c] = tof(dy[c]);
  __syncthreads();
  layernorm_stats(x32, n, D, mean1, rstd1);
  layernorm_tile(x32, n, D, an_s, an_b, h1s, kLd);
  zero_rows(h1s, kLd, n, np, D);
  __syncthreads();
  store_rows(H1, D, h1s, kLd, n, D);
  if (!kRecompute) {
    for (int c = threadIdx.x; c < inner; c += blockDim.x) {
      qs[c] = Q[c] = fromf<T>(sv[c]);
      os[c] = O[c] = fromf<T>(sv[sl.o + c]);
    }
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      x1[c] = sv[sl.x1 + c];
      h2s[c] = fromf<T>(sv[sl.h2 + c]);
    }
    __syncthreads();
    layernorm_stats(x1, 1, D, mean2, rstd2);
  } else {
    T* KV = (T*)a.s[1] + fr * i2;
    for (int c = threadIdx.x; c < inner; c += blockDim.x) {
      float s = 0.f;
      for (int kk = 0; kk < D; ++kk)
        s = fmaf(tof(h1s[kk]), tof(wqkv[(size_t)kk * i3 + c]), s);
      qs[c] = Q[c] = fromf<T>(s);
    }
    for (int hd = 0; hd < heads; ++hd) {
      cp_async_wait<0>();
      __syncthreads();
      stage(hd + 1);  // the next head's slice, or the backward's first
      project_kv(ws + (hd % 2) * D * kLdKv);
      __syncthreads();
      store_rows(KV + hd * DH, i2, k, kLd, n, DH);
      store_rows(KV + inner + hd * DH, i2, v, kLd, n, DH);
      if (warp == 0) softmax_row<T>(qs + hd * DH, k, kLd, n, DH, m.scale, p);
      __syncthreads();
      for (int c = threadIdx.x; c < DH; c += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < n; ++j)
          s = fmaf(rt<T>(p[j]), tof(v[(size_t)j * kLd + c]), s);
        os[hd * DH + c] = O[hd * DH + c] = fromf<T>(s);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int kk = 0; kk < inner; ++kk)
        s = fmaf(tof(os[kk]), tof(wout[(size_t)kk * D + c]), s);
      x1[c] = x32[c] + (s + tof(bout[c]));
    }
    __syncthreads();
    layernorm_stats(x1, 1, D, mean2, rstd2);
    layernorm_tile(x1, 1, D, fn_s, fn_b, h2s, D);
  }
  __syncthreads();

  // ---- MLP forward + backward on the CLS row, eight hidden columns a
  // thread: hid, dpre (its unrounded sum is db1's row), then dh2 = dpre_c
  // w1^T in acc row 0 -----------------------------------------------------
  for (int c = threadIdx.x; c < D; c += blockDim.x) H2[c] = h2s[c];
  for (int c0 = 8 * threadIdx.x; c0 < mlp; c0 += 8 * blockDim.x) {
    float z[8], wv[8];
    if (!kRecompute) {
#pragma unroll
      for (int i = 0; i < 8; ++i) z[i] = sv[sl.z + c0 + i];
    } else {
      float pre[8] = {};
      for (int kk = 0; kk < D; ++kk) {
        load8(wv, w1 + (size_t)kk * mlp + c0);
        const float h = tof(h2s[kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i) pre[i] = fmaf(h, wv[i], pre[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) z[i] = pre[i] + tof(b1[c0 + i]);
    }
    float hid[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = 0.f;
      for (int k8 = 0; k8 < D; k8 += 8) {
        load8(wv, w2 + (size_t)(c0 + i) * D + k8);
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(dys[k8 + j], wv[j], s);
      }
      hid[i] = gelu<T>(z[i]);
      dp[i] = s * gelu_grad<T>(z[i]);
      V[6 * D + c0 + i] = dp[i];  // db1: one row, the unrounded dpre
    }
    const uint4 hk = make_uint4(pack_bf16(hid[0], hid[1]),
                                pack_bf16(hid[2], hid[3]),
                                pack_bf16(hid[4], hid[5]),
                                pack_bf16(hid[6], hid[7]));
    const uint4 dk = make_uint4(pack_bf16(dp[0], dp[1]),
                                pack_bf16(dp[2], dp[3]),
                                pack_bf16(dp[4], dp[5]),
                                pack_bf16(dp[6], dp[7]));
    *reinterpret_cast<uint4*>(HID + c0) = hk;
    *reinterpret_cast<uint4*>(DPRE + c0) = dk;
    *reinterpret_cast<uint4*>(dpre + c0) = dk;
  }
  __syncthreads();
  // dh2's partial sums over chunks of kClsChunk hidden columns, each the
  // FMA body's chain, all at once; then added in chunk order
  const int chunks = (mlp + kClsChunk - 1) / kClsChunk;
  for (int it = threadIdx.x; it < chunks * D; it += blockDim.x) {
    const int c = it % D, k0 = it / D * kClsChunk;
    const int kn = min(kClsChunk, mlp - k0);
    float s = 0.f, wv[8];
    for (int k8 = 0; k8 < kn; k8 += 8) {
      load8(wv, w1 + (size_t)c * mlp + k0 + k8);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s = fmaf(tof(dpre[k0 + k8 + j]), wv[j], s);
    }
    part[it] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += part[ch * D + c];
    acc[c] = s;
    V[5 * D + c] = dys[c];  // db2
  }
  __syncthreads();
  ln_bwd<T>(x1, mean2, rstd2, acc, 1, D, fn_s, V + 3 * D, V + 4 * D,
            [=](int r, int c, float v) { g1[c] = dys[c] + v; });
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    g1c[c] = G1C[c] = fromf<T>(g1[c]);
    V[2 * D + c] = g1[c];  // dbout
  }
  __syncthreads();
  // do = T(g1c wout^T): a chain over d a column
  for (int c = threadIdx.x; c < inner; c += blockDim.x) {
    float s = 0.f, wv[8];
    for (int k8 = 0; k8 < D; k8 += 8) {
      load8(wv, wout + (size_t)c * D + k8);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(tof(g1c[k8 + j]), wv[j], s);
    }
    dos[c] = DO[c] = fromf<T>(s);
  }
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) acc[i] = 0.f;

  // ---- attention backward, per head; acc = dh1 --------------------------
  for (int hd = 0; hd < heads; ++hd) {
    const int i = heads + hd;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < 2 * heads) stage(i + 1);
    const T* w = ws + (i % 2) * D * kLdKv;
    const T* qh = qs + hd * DH;
    const T* doh = dos + hd * DH;
    project_kv(w);
    __syncthreads();
    // the forward's probabilities (recomputed with kRecompute); dp = do
    // v^T, then ds = T((p (dp - sum_j dp p)) scale), as cls_bwd_body forms
    // them
    if (warp == 0) {
      if (!kRecompute) {
        for (int j = lane; j < n; j += 32) p[j] = sv[sl.p + hd * n + j];
        __syncwarp();
      } else {
        softmax_row<T>(qh, k, kLd, n, DH, m.scale, p);
      }
      for (int j = lane; j < n; j += 32) {
        float s = 0.f;
        for (int e = 0; e < DH; ++e)
          s = fmaf(tof(doh[e]), tof(v[(size_t)j * kLd + e]), s);
        ds[j] = s;  // dp
      }
      __syncwarp();
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += ds[j] * p[j];
      s = warp_sum(s);
      for (int j = lane; j < n; j += 32)
        ds[j] = rt<T>((p[j] * (ds[j] - s)) * m.scale);
    }
    __syncthreads();
    // dk = T(ds^T q) | dv = T(p_c^T do) into the tile (zero past row n);
    // dq = T(ds k), a chain over the keys a column
    for (int it = threadIdx.x; it < np * DH; it += blockDim.x) {
      const int r = it / DH, c = it % DH * 2;
      float v0 = 0.f, v1 = 0.f;
      if (r < n) {
        if (c < DH) {
          v0 = ds[r] * tof(qh[c]);
          v1 = ds[r] * tof(qh[c + 1]);
        } else {
          const float pc = rt<T>(p[r]);
          v0 = pc * tof(doh[c - DH]);
          v1 = pc * tof(doh[c - DH + 1]);
        }
      }
      put2(dkv, kLdKv, r, c, v0, v1);
    }
    for (int e = threadIdx.x; e < DH; e += blockDim.x) {
      float t = 0.f;
      for (int j = 0; j < n; ++j)
        t = fmaf(ds[j], tof(k[(size_t)j * kLd + e]), t);
      dqs[hd * DH + e] = DQ[hd * DH + e] = fromf<T>(t);
    }
    __syncthreads();
    // acc += dk|dv @ wkv[head]^T (the slice read as [N][K]); dk|dv to its
    // slot (wqkv's column order: dk of every head, then dv)
    block_mma<false, true>(np, D, 2 * DH, dkv, kLdKv, w, kLdKv,
                           [=](int r, int c, float v0, float v1) {
                             if (r < n) {
                               acc[r * D + c] += v0;
                               acc[r * D + c + 1] += v1;
                             }
                           });
    store_rows(DKV + hd * DH, i2, dkv, kLdKv, n, DH);
    store_rows(DKV + inner + hd * DH, i2, dkv + DH, kLdKv, n, DH);
  }
  __syncthreads();
  // dh1 of the CLS row gains the q path: dq wqkv[:, :inner]^T, a chain over
  // inner a column
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f, wv[8];
    for (int k8 = 0; k8 < inner; k8 += 8) {
      load8(wv, wqkv + (size_t)c * i3 + k8);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(tof(dqs[k8 + j]), wv[j], s);
    }
    acc[c] += s;
  }
  __syncthreads();
  ln_bwd<T>(x32, mean1, rstd1, acc, n, D, an_s, V, V + D,
            [=](int r, int c, float v) {
              dx[(size_t)r * D + c] = fromf<T>(r == 0 ? v + g1[c] : v);
            });
}

// The CLS-only backward body: with Mma the bf16 tensor-core body (the
// flagship widths, see mma_body_takes), else the FMA body of T.
template <typename T, bool Mma, bool kRecompute>
__device__ __forceinline__ void cls_bwd(const BwdArgs& a, int f,
                                        unsigned char* smem_raw) {
  if constexpr (Mma)
    cls_bwd_mma<kRecompute>(a, f, smem_raw);
  else
    cls_bwd_body<T, kRecompute>(a, f, smem_raw);
}

template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads)
    cls_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cls_bwd<T, Mma, false>(a, blockIdx.x, smem_raw);
}

// K3b's body before fault k's repair (the CLS row recomputed, its k|v
// stored to slot 1), for the measurement of the fault: launched only
// without a record, which no route passes.
template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads)
    cls_bwd_recompute_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cls_bwd<T, Mma, true>(a, blockIdx.x, smem_raw);
}

// K6, the per-frame pass of the whole trunk's backward. One thread block
// per frame: the final norm's backward on K4's rounded CLS row, then the
// CLS block's and the full blocks' backward bodies in reverse (with Mma:
// cls_bwd_mma and block_bwd_mma), each on the block input K4 wrote
// (blk[i].x). A block's dx is written in T and read back as the next one's
// dy, which is the rounding between blocks.
struct TrunkBwdArgs {
  BwdArgs blk[kMaxTrunkDepth];
  const void* dy;     // (B, d) in T: grad of the normed latent
  const void* cls;    // (B, d) in T: K4's rounded pre-norm CLS rows
  void* dcls;         // (B, d) in T: blk[depth - 1].dy, written here
  const float* fn_s;  // final-norm scale and bias, fp32
  const float* fn_b;
  float* fnvec;       // (B, 2 d): each frame's final-norm grads
  int depth, final_norm;
};

template <typename T, bool Mma, bool kRecompute>
__device__ __forceinline__ void trunk_bwd_pass(const TrunkBwdArgs& a,
                                               unsigned char* smem_raw) {
  const int f = blockIdx.x, depth = a.depth, d = a.blk[0].m.d;

  // final-norm backward on the CLS row (warp 0; each lane reads back only
  // the columns it wrote): dcls in T, and this frame's scale and bias grads
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float* x32 = (float*)smem_raw;
    const T* cls = (const T*)a.cls + (size_t)f * d;
    for (int c = lane; c < d; c += 32) x32[c] = tof(cls[c]);
    const T* dy = (const T*)a.dy + (size_t)f * d;
    T* dcls = (T*)a.dcls + (size_t)f * d;
    float* V = a.fnvec + (size_t)f * 2 * d;
    if (a.final_norm == 0) {
      float sq = 0.f;
      for (int c = lane; c < d; c += 32) sq += x32[c] * x32[c];
      const float nn = fmaxf(sqrtf(warp_sum(sq)), 1e-12f);
      const float sd = sqrtf((float)d);
      float proj = 0.f;
      for (int c = lane; c < d; c += 32)
        proj += tof(dy[c]) * a.fn_s[c] * (x32[c] / nn);
      proj = warp_sum(proj);
      for (int c = lane; c < d; c += 32) {
        const float u = x32[c] / nn, g = tof(dy[c]);
        dcls[c] = fromf<T>((sd / nn) * (g * a.fn_s[c] - u * proj));
        V[c] = sd * u * g;
        V[d + c] = 0.f;
      }
    } else {
      float sum = 0.f;
      for (int c = lane; c < d; c += 32) sum += x32[c];
      const float mu = warp_sum(sum) / d;
      float sq = 0.f;
      for (int c = lane; c < d; c += 32) sq += (x32[c] - mu) * (x32[c] - mu);
      const float rs = rsqrtf(warp_sum(sq) / d + 1e-5f);
      float sd = 0.f, sdx = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float dxh = tof(dy[c]) * a.fn_s[c];
        sd += dxh;
        sdx += dxh * ((x32[c] - mu) * rs);
      }
      const float md = warp_sum(sd) / d, mdx = warp_sum(sdx) / d;
      for (int c = lane; c < d; c += 32) {
        const float xhat = (x32[c] - mu) * rs, g = tof(dy[c]);
        dcls[c] = fromf<T>(rs * (g * a.fn_s[c] - md - xhat * mdx));
        V[c] = g * xhat;
        V[d + c] = g;
      }
    }
  }
  __syncthreads();

  cls_bwd<T, Mma, kRecompute>(a.blk[depth - 1], f, smem_raw);
  for (int i = depth - 2; i >= 0; --i) {
    __syncthreads();
    block_bwd<T, Mma>(a.blk[i], f, smem_raw);
  }
}

template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_bwd_kernel(const __grid_constant__ TrunkBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_bwd_pass<T, Mma, false>(a, smem_raw);
}

// K6 with its CLS block's body before fault k's repair, for the
// measurement of the fault: launched only without a record.
template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_bwd_recompute_kernel(const __grid_constant__ TrunkBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_bwd_pass<T, Mma, true>(a, smem_raw);
}

// One weight-gradient product C = A^T B over a segment of rows:
// A (R, K) and B (R, N) in T with row strides lda, ldb; the segment's fp32
// sums go to part[segment] (K x N). Each thread block owns a 64 x 64 tile
// of C (4 x 4 per thread) and walks its rows in order, 16 at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* A, int lda, const T* B, int ldb, long R, int K,
                 int N, long seg_rows, float* part) {
  __shared__ float As[kChunk][kTile];
  __shared__ float Bs[kChunk][kTile];
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const long r_begin = (long)blockIdx.z * seg_rows;
  const long r_end = r_begin + seg_rows < R ? r_begin + seg_rows : R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long r0 = r_begin; r0 < r_end; r0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile; i += blockDim.x) {
      const int rr = i / kTile, cc = i % kTile;
      const long r = r0 + rr;
      As[rr][cc] = (r < r_end && k0 + cc < K)
                       ? tof(A[(size_t)r * lda + k0 + cc]) : 0.f;
      Bs[rr][cc] = (r < r_end && n0 + cc < N)
                       ? tof(B[(size_t)r * ldb + n0 + cc]) : 0.f;
    }
    __syncthreads();
    const int rows = r_end - r0 < kChunk ? (int)(r_end - r0) : kChunk;
    for (int rr = 0; rr < rows; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[rr][ty * 4 + i];
        bv[i] = Bs[rr][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* P = part + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (k < K && c < N) P[(size_t)k * N + c] = acc[i][j];
    }
}

// The same product for bf16 on the tensor cores: the same tiles, row
// segments and partials as wgrad_kernel, each thread block walking its
// segment's rows in order, kWgRows at a time. A chunk's rows of A and B go
// to shared memory by cp.async (the next chunk's in flight, zeros past
// the segment's end and past K or N), and each warp adds its 16 x 32
// piece of the 64 x 64 tile as mma.sync products into fp32 registers, A
// read transposed through ldmatrix.trans. The order of every sum is fixed
// by the shapes, so a gradient is the same from run to run. What bounds
// it is bytes: A is read once for each tile column of C, B once for each
// tile row (h2^T dpre at B=256 moves ~136 MB, 3.4 GFLOP). Takes what
// wgrad_mma_takes says; other products keep wgrad_kernel, and fp32 always
// does: at the BC batches fp32 K2b's products on wgrad_kernel are under a
// quarter of its time on the cluster form (PERF.md), so they stay on the
// FMA kernel.
constexpr int kWgRows = 64;         // rows of a chunk
constexpr int kWgLd = kTile + 8;    // row stride of a chunk's tiles

__global__ void __launch_bounds__(kThreads)
    wgrad_mma_kernel(const bf16* A, int lda, const bf16* B, int ldb, long R,
                     int K, int N, long seg_rows, float* part) {
  __shared__ __align__(16) bf16 As[2][kWgRows][kWgLd];
  __shared__ __align__(16) bf16 Bs[2][kWgRows][kWgLd];
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int kc = min(kTile, K - k0), nc = min(kTile, N - n0);
  const long r_begin = (long)blockIdx.z * seg_rows;
  const long r_end = r_begin + seg_rows < R ? r_begin + seg_rows : R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = 16 * (warp % 4), c0 = 32 * (warp / 4);
  // rows r0.. of the segment into buffer buf, 16 bytes a copy
  auto stage = [&](long r0, int buf) {
    const long rows = r_end - r0;
    for (int i = threadIdx.x; i < kWgRows * (kTile / 8); i += blockDim.x) {
      const int r = i / (kTile / 8), c = i % (kTile / 8) * 8;
      if (r < rows && c < kc)
        cp_async16(&As[buf][r][c], A + (size_t)(r0 + r) * lda + k0 + c);
      else
        *reinterpret_cast<uint4*>(&As[buf][r][c]) = make_uint4(0, 0, 0, 0);
      if (r < rows && c < nc)
        cp_async16(&Bs[buf][r][c], B + (size_t)(r0 + r) * ldb + n0 + c);
      else
        *reinterpret_cast<uint4*>(&Bs[buf][r][c]) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  float acc[4][4] = {};
  if (r_begin < r_end) stage(r_begin, 0);
  int buf = 0;
  for (long r0 = r_begin; r0 < r_end; r0 += kWgRows, buf ^= 1) {
    if (r0 + kWgRows < r_end) {
      stage(r0 + kWgRows, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma<4, true, false>(acc, &As[buf][0][0], kWgLd, m0, &Bs[buf][0][0],
                             kWgLd, c0, kWgRows);
    __syncthreads();
  }
  float* P = part + (size_t)blockIdx.z * K * N;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + m0 + g + 8 * h, c = n0 + c0 + 8 * j + 2 * t;
      if (k < K && c < N)
        *reinterpret_cast<float2*>(P + (size_t)k * N + c) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

// C[k][col0 + c] = T(sum over segments, in order, of part[s][k][c])
template <typename T>
__global__ void wgrad_finish(const float* part, int S, int K, int N, T* C,
                             int ldc, int col0) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)K * N) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += part[(size_t)j * K * N + i];
  C[(size_t)(i / N) * ldc + col0 + i % N] = fromf<T>(s);
}

struct VecOut {
  void* p[7];
  int len[7];
};

// Vector gradients: out = T(sum over frames, in order, of the frames' row
// sums), the L = 6 d + mlp columns split over seven outputs.
template <typename T>
__global__ void vec_finish(const float* vec, int B, int L, VecOut o) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  float s = 0.f;
  for (int f = 0; f < B; ++f) s += vec[(size_t)f * L + c];
  int seg = 0, off = c;
  while (off >= o.len[seg]) off -= o.len[seg++];
  ((T*)o.p[seg])[off] = fromf<T>(s);
}

// One weight-gradient product of a backward: C[:, col0:col0+N] (row
// stride ldc) = A^T B over R rows.
struct Product {
  const void* A;
  int lda;
  const void* B;
  int ldb;
  long R;
  int K, N;
  void* C;
  int ldc, col0;
};

// The row segments of a product: at least 128 rows each, about
// kTargetCtas thread blocks in all.
int splits(long R, int K, int N) {
  const int tiles = ((K + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  const long most = R / 128 > 1 ? R / 128 : 1;  // >= 128 rows a segment
  const long want = (kTargetCtas + tiles - 1) / tiles;
  return (int)(want < most ? want : most);
}

// The backward's weight products, in the order they are launched; the
// pointers are those of `a` and of the grads (null when only sizing).
int products(bool cls, const BwdArgs& a, void* const* g, int B, Product* p) {
  const int n = a.n, d = a.m.d, inner = a.m.heads * a.m.dh, mlp = a.m.mlp;
  const long rows = (long)B * n, rq = cls ? B : rows;
  int k = 0;
  if (cls) {
    p[k++] = {a.s[0], n * d, a.s[10], inner, (long)B, d, inner, g[2],
              3 * inner, 0};
    p[k++] = {a.s[0], d, a.s[8], 2 * inner, rows, d, 2 * inner, g[2],
              3 * inner, inner};
  } else {
    p[k++] = {a.s[0], d, a.s[8], 3 * inner, rows, d, 3 * inner, g[2],
              3 * inner, 0};
  }
  p[k++] = {a.s[2], inner, a.s[6], d, rq, inner, d, g[3], d, 0};
  p[k++] = {a.s[3], d, a.s[5], mlp, rq, d, mlp, g[7], mlp, 0};
  p[k++] = {a.s[4], mlp, a.dy, d, rq, mlp, d, g[9], d, 0};
  return k;
}

struct Workspace {
  size_t slot[kSlots], vec, part, total;
};

Workspace workspace(bool cls, size_t esize, int B, int n, int d, int heads,
                    int dh, int mlp) {
  const size_t inner = (size_t)heads * dh, rq = cls ? 1 : n;
  const size_t qkv = cls ? 2 * inner : 3 * inner;
  const size_t elems[kSlots] = {
      (size_t)n * d, n * qkv, rq * inner, rq * d, rq * mlp, rq * mlp,
      rq * d, rq * inner, n * qkv, cls ? inner : 0, cls ? inner : 0};
  Workspace w;
  size_t off = 0;
  for (int s = 0; s < kSlots; ++s) {
    w.slot[s] = off;
    off = align16(off + esize * B * elems[s]);
  }
  w.vec = off;
  off = align16(off + sizeof(float) * B * (6 * (size_t)d + mlp));
  BwdArgs a = {};
  a.n = n;
  a.m.d = d;
  a.m.heads = heads;
  a.m.dh = dh;
  a.m.mlp = mlp;
  void* g[11] = {};
  Product p[5];
  size_t part = 0;
  for (int i = 0, k = products(cls, a, g, B, p); i < k; ++i) {
    const size_t e = (size_t)splits(p[i].R, p[i].K, p[i].N) * p[i].K * p[i].N;
    part = e > part ? e : part;
  }
  w.part = off;
  w.total = align16(off + sizeof(float) * part);
  return w;
}

// Point a block's operand slots and row sums into its workspace `ws`;
// returns the partial-sum buffer of its weight products.
float* bind(bool cls, size_t esize, BwdArgs& a, unsigned char* ws, int B) {
  const Workspace w = workspace(cls, esize, B, a.n, a.m.d, a.m.heads, a.m.dh,
                                a.m.mlp);
  for (int s = 0; s < kSlots; ++s) a.s[s] = ws + w.slot[s];
  a.vec = (float*)(ws + w.vec);
  return (float*)(ws + w.part);
}

// Whether wgrad_mma_kernel takes a bf16 product: K and N multiples of 8,
// row strides multiples of 8 elements and A and B 16-byte aligned (its
// 16-byte copies).
bool wgrad_mma_takes(const Product& p) {
  return p.K % 8 == 0 && p.N % 8 == 0 && p.lda % 8 == 0 && p.ldb % 8 == 0 &&
         ((uintptr_t)p.A | (uintptr_t)p.B) % 16 == 0;
}

// One weight product: its partial sums over the row segments into `part`
// (splits(R, K, N) x K x N floats), then their sum in segment order.
template <typename T>
int launch_product(const Product& p, float* part, cudaStream_t stream) {
  const int S = splits(p.R, p.K, p.N);
  const long seg = (p.R + S - 1) / S;
  const dim3 grid((p.K + kTile - 1) / kTile, (p.N + kTile - 1) / kTile, S);
  bool mma = false;
  if constexpr (std::is_same<T, bf16>::value)
    if ((mma = wgrad_mma_takes(p)))
      wgrad_mma_kernel<<<grid, kThreads, 0, stream>>>(
          (const T*)p.A, p.lda, (const T*)p.B, p.ldb, p.R, p.K, p.N, seg,
          part);
  if (!mma)
    wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
        (const T*)p.A, p.lda, (const T*)p.B, p.ldb, p.R, p.K, p.N, seg, part);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long kn = (long)p.K * p.N;
  wgrad_finish<T><<<(unsigned)((kn + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(part, S, p.K, p.N, (T*)p.C, p.ldc, p.col0);
  return cudaGetLastError();
}

// Pass 2 of a block's backward: its weight-gradient products and vector
// gradients from the operands the per-frame pass left in `a`'s slots.
template <typename T>
int launch_grads(bool cls, const BwdArgs& a, void* const* g, float* part,
                 int B, cudaStream_t stream) {
  int err;
  Product p[5];
  const int k = products(cls, a, g, B, p);
  for (int i = 0; i < k; ++i)
    if ((err = launch_product<T>(p[i], part, stream)) != cudaSuccess)
      return err;
  const int d = a.m.d, L_ = 6 * d + a.m.mlp;
  // row-sum layout an_s, an_b, bout, fn_s, fn_b, b2, b1 -> grads 0 1 4 5 6 10 8
  VecOut o = {{g[0], g[1], g[4], g[5], g[6], g[10], g[8]},
              {d, d, d, d, d, d, a.m.mlp}};
  vec_finish<T><<<(L_ + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.vec, B, L_, o);
  return cudaGetLastError();
}

// Whether block_bwd_mma and cls_bwd_mma take these widths and pointers:
// d = dim_head = kMmaD, n <= kMmaRows, mlp a multiple of kMmaChunk, and
// every tensor they copy in 16-byte pieces 16-byte aligned (the workspace
// slots are).
bool mma_body_takes(const BwdArgs& a) {
  const Dims& m = a.m;
  uintptr_t any = (uintptr_t)a.x | (uintptr_t)a.dy;
  for (int i : {2, 3, 7, 9}) any |= (uintptr_t)a.w[i];
  return m.d == kMmaD && m.dh == kMmaD && a.n <= kMmaRows &&
         m.mlp % kMmaChunk == 0 && any % 16 == 0;
}

// Whether the fp32 cluster forms take these widths and pointers (K2b's
// block_bwd_cluster_fp32_kernel; K2f's with x and out): d = dim_head = 64,
// 4 heads, n <= 80, mlp a multiple of 4 x 64, and every tensor they copy
// or write in 8- or 16-byte pieces 16-byte aligned (the workspace slots
// are).
bool fp32_cluster_takes(int n, const Dims& m, const void* const* ptrs,
                        int count) {
  uintptr_t any = 0;
  for (int i = 0; i < count; ++i) any |= (uintptr_t)ptrs[i];
  return m.d == cl32::D && m.dh == cl32::D && m.heads == cl32::kRanks &&
         n <= mmafwd::kMaxRows && m.mlp % (cl32::kRanks * cl32::HC) == 0 &&
         any % 16 == 0;
}

// The per-frame pass of K2b (cls false) or K3b in `form` (0 the FMA body,
// 1 the bf16 tensor-core body, 2 the fp32 cluster form: K2b's one launch,
// K3b's two, which read the records), then pass 2.
template <typename T>
int launch_bwd(bool cls, int form, BwdArgs& a, void* const* g,
               unsigned char* ws, int B, cudaStream_t stream) {
  float* part = bind(cls, sizeof(T), a, ws, B);
  const BwdSmem L(a.n, a.m.d, a.m.hc);
  const bool recompute = cls && a.sv.base == nullptr;  // a measurement
  int err;
  if (form == 0) {
    err = !cls ? launch_smem(block_bwd_kernel<T, false>, B, L.total, stream,
                             a)
          : recompute
              ? launch_smem(cls_bwd_recompute_kernel<T, false>, B, L.total,
                            stream, a)
              : launch_smem(cls_bwd_kernel<T, false>, B, L.total, stream, a);
  } else if constexpr (std::is_same<T, bf16>::value) {
    if (form != 1 || !mma_body_takes(a)) return cudaErrorInvalidValue;
    const size_t cls_bytes =
        ClsMmaSmem(a.n, a.m.heads * kMmaD, a.m.mlp).total;
    err = !cls ? launch_smem(block_bwd_kernel<T, true>, B,
                             MmaBwdSmem(a.n).total, stream, a)
          : recompute
              ? launch_smem(cls_bwd_recompute_kernel<T, true>, B, cls_bytes,
                            stream, a)
              : launch_smem(cls_bwd_kernel<T, true>, B, cls_bytes, stream,
                            a);
  } else {
    const void* aligned[] = {a.x, a.dy, a.dx, a.w[2], a.w[3], a.w[7],
                             a.w[9], a.sv.base};
    if (form != 2 || recompute ||
        !fp32_cluster_takes(a.n, a.m, aligned, cls ? 8 : 7))
      return cudaErrorInvalidValue;
    if (!cls) {
      err = cl32::launch(block_bwd_cluster_fp32_kernel, a.n, B,
                         bw32::Layout(a.n).total, stream, a);
    } else {
      err = launch_cls_mlp(cls_mlp_bwd_fp32_kernel, B, stream, a, B);
      if (err == cudaSuccess)
        err = cl32::launch(cls_bwd_cluster_fp32_kernel, a.n, B,
                           ClsBwdLayout(a.n).total, stream, a);
    }
  }
  if (err != cudaSuccess) return err;
  return launch_grads<T>(cls, a, g, part, B, stream);
}

// K6's device workspace: the dx between blocks, the CLS grad, the
// frames' final-norm grads, then each block's own workspace.
struct TrunkWorkspace {
  size_t dxs[kMaxTrunkDepth], blk[kMaxTrunkDepth], dcls, fnvec, total;
};

TrunkWorkspace trunk_workspace(size_t esize, int B, int n, int d, int heads,
                               int dh, int mlp, int depth) {
  TrunkWorkspace w = {};
  const size_t stream_bytes = esize * B * n * d;
  size_t off = 0;
  for (int i = 1; i < depth; ++i) {
    w.dxs[i] = off;
    off = align16(off + stream_bytes);
  }
  w.dcls = off;
  off = align16(off + esize * B * d);
  w.fnvec = off;
  off = align16(off + sizeof(float) * B * 2 * d);
  for (int i = 0; i < depth; ++i) {
    w.blk[i] = off;
    off += workspace(i == depth - 1, esize, B, n, d, heads, dh, mlp).total;
  }
  w.total = off;
  return w;
}

// K6's shared memory: the largest backward body's it runs (the final
// norm's CLS row, d floats, lies in any of them).
size_t trunk_bwd_bytes(int n, const Dims& m, bool mma) {
  size_t bytes = sizeof(float) * m.d;
  for (const size_t b :
       {BwdSmem(n, m.d, m.hc).total, mma ? MmaBwdSmem(n).total : 0,
        mma ? ClsMmaSmem(n, m.heads * m.dh, m.mlp).total : 0})
    bytes = b > bytes ? b : bytes;
  return bytes;
}

// K6: ptrs as trunk_backward_launch takes them.
template <typename T>
int launch_trunk_bwd(const void* const* ptrs, int B, int n, const Dims& m,
                     int depth, int final_norm, bool mma,
                     cudaStream_t stream) {
  const void* const* wts = ptrs + 2;
  void* const* grads = (void* const*)ptrs + 5 + 11 * depth;
  unsigned char* ws = (unsigned char*)ptrs[7 + 22 * depth];
  const T* xs = (const T*)ptrs[8 + 22 * depth];
  const TrunkWorkspace w = trunk_workspace(sizeof(T), B, n, m.d, m.heads,
                                           m.dh, m.mlp, depth);
  TrunkBwdArgs a = {};
  float* part[kMaxTrunkDepth];
  for (int i = 0; i < depth; ++i) {
    BwdArgs& b = a.blk[i];
    b.x = i == 0 ? ptrs[0] : xs + (size_t)(i - 1) * B * n * m.d;
    b.dy = i == depth - 1 ? ws + w.dcls : ws + w.dxs[i + 1];
    for (int j = 0; j < 11; ++j) b.w[j] = wts[11 * i + j];
    b.dx = i == 0 ? (void*)ptrs[4 + 11 * depth] : ws + w.dxs[i];
    b.n = n;
    b.m = m;
    part[i] = bind(i == depth - 1, sizeof(T), b, ws + w.blk[i], B);
  }
  a.blk[depth - 1].sv = ClsSave((float*)ptrs[10 + 22 * depth], n, m.d,
                                m.heads, m.dh, m.mlp);
  a.dy = ptrs[1];
  a.cls = ptrs[9 + 22 * depth];
  a.dcls = ws + w.dcls;
  a.fn_s = (const float*)ptrs[2 + 11 * depth];
  a.fn_b = (const float*)ptrs[3 + 11 * depth];
  a.fnvec = (float*)(ws + w.fnvec);
  a.depth = depth;
  a.final_norm = final_norm;
  const size_t bytes = trunk_bwd_bytes(n, m, mma);
  const bool recompute = a.blk[depth - 1].sv.base == nullptr;  // measuring
  int err;
  if (!mma) {
    err = recompute ? launch_smem(trunk_bwd_recompute_kernel<T, false>, B,
                                  bytes, stream, a)
                    : launch_smem(trunk_bwd_kernel<T, false>, B, bytes,
                                  stream, a);
  } else if constexpr (std::is_same<T, bf16>::value) {
    for (int i = 0; i < depth; ++i)
      if (!mma_body_takes(a.blk[i])) return cudaErrorInvalidValue;
    err = recompute ? launch_smem(trunk_bwd_recompute_kernel<T, true>, B,
                                  bytes, stream, a)
                    : launch_smem(trunk_bwd_kernel<T, true>, B, bytes,
                                  stream, a);
  } else {
    return cudaErrorInvalidValue;  // the tensor-core body is bf16's
  }
  if (err != cudaSuccess) return err;
  for (int i = 0; i < depth; ++i) {
    err = launch_grads<T>(i == depth - 1, a.blk[i], grads + 11 * i, part[i],
                          B, stream);
    if (err != cudaSuccess) return err;
  }
  VecOut o = {{(void*)ptrs[5 + 22 * depth], (void*)ptrs[6 + 22 * depth]},
              {m.d, m.d}};
  vec_finish<float><<<(2 * m.d + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(a.fnvec, B, 2 * m.d, o);
  return cudaGetLastError();
}

Dims dims(int d, int heads, int dim_head, int mlp, int hc_max, float scale) {
  Dims m;
  m.d = d;
  m.heads = heads;
  m.dh = dim_head;
  m.mlp = mlp;
  m.hc = mlp < hc_max ? mlp : hc_max;
  m.scale = scale;
  return m;
}

bool bad_shape(int batch, int n, int d, int heads, int dim_head, int mlp) {
  return batch < 1 || n < 1 || d < 1 || heads < 1 || dim_head < 1 ||
         mlp < 1 || heads > n;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of K2f (cls = 0) and K3f (cls = 1) for
// these shapes in `form` (as block_forward_launch takes it): 1 the bf16
// tensor-core body, 2 a CTA of the fp32 cluster form (K3f: of its
// attention half; cls_mlp_smem gives its MLP launch's).
size_t block_forward_smem(int dtype, int cls, int n, int d, int heads,
                          int dim_head, int mlp, int form) {
  if (form == 2) return cls ? ClsFwdLayout(n).total : cl32::Layout(n, 0).total;
  if (form) return mmafwd::Layout(n).total;
  const int hc = mlp < 256 ? mlp : 256;
  return dtype == 1 ? Smem<__nv_bfloat16>(n, d, heads, dim_head, hc).total
                    : Smem<float>(n, d, heads, dim_head, hc).total;
}

// Bytes of dynamic shared memory of the per-frame pass of K2b (cls = 0)
// and K3b (cls = 1) in `form` (as block_backward_launch takes it): 1 the
// bf16 tensor-core bodies, 2 a CTA of the fp32 cluster form (K3b: of
// cls_bwd_cluster_fp32_kernel; cls_mlp_smem gives its MLP launch's).
size_t block_backward_smem(int dtype, int cls, int n, int d, int heads,
                           int dim_head, int mlp, int form) {
  (void)dtype;
  if (form == 2) return cls ? ClsBwdLayout(n).total : bw32::Layout(n).total;
  if (form) return cls ? ClsMmaSmem(n, heads * dim_head, mlp).total
                       : MmaBwdSmem(n).total;
  return BwdSmem(n, d, mlp < 128 ? mlp : 128).total;
}

// Bytes of dynamic shared memory of a CTA of the fp32 cluster forms'
// batched CLS-row MLP launches (K3f's cls_mlp_fp32_kernel, K3b's
// cls_mlp_bwd_fp32_kernel), any width.
size_t cls_mlp_smem() { return cm32::kBytes; }

// Bytes of dynamic shared memory of K6's per-frame pass; mma = 1: its
// full blocks on the tensor-core body.
size_t trunk_backward_smem(int dtype, int n, int d, int heads, int dim_head,
                           int mlp, int mma) {
  (void)dtype;
  return trunk_bwd_bytes(n, dims(d, heads, dim_head, mlp, 128, 1.f),
                         mma != 0);
}

// K2f (cls = 0) and K3f (cls = 1). dtype: 0 = fp32, 1 = bf16 compute.
// ptrs: x (B, n, d), 11 weights in the fused-transformer order, out
// (B, n, d) or, with cls, (B, d), then, with cls, the CLS rows' records
// (B, ClsSave stride) fp32, written when not null (autograd records), and
// K3f's fp32 cluster form's scratch, (B, d) fp32 (LN2 of the CLS rows).
// form = 1 runs K2f (block_fwd_mma_kernel) or K3f (cls_fwd_mma_kernel) on
// the bf16 tensor-core body, which takes bf16, d = dim_head = 64, n <= 80,
// mlp a multiple of 64 and 16-byte aligned x, out and matrix weights;
// form = 2 the fp32 cluster form, K2f over a cluster of 4 CTAs a frame
// (block_fwd_cluster_fp32_kernel), K3f as cls_attend_cluster_fp32_kernel
// then cls_mlp_fp32_kernel, which take fp32, d = dim_head = 64, 4 heads,
// n <= 80, mlp a multiple of 256 and those tensors (the records and the
// scratch too) 16-byte aligned (cudaErrorInvalidValue else); form = 0 the
// FMA body, any width. Returns a cudaError_t (0 = launched).
int block_forward_launch(int dtype, int cls, const void* const* ptrs,
                         int batch, int n, int d, int heads, int dim_head,
                         int mlp, float scale, void* stream, int form) {
  if (bad_shape(batch, n, d, heads, dim_head, mlp))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.x = ptrs[0];
  for (int i = 0; i < 11; ++i) a.w[i] = ptrs[1 + i];
  a.out = (void*)ptrs[12];
  a.sv = ClsSave(cls ? (float*)ptrs[13] : nullptr, n, d, heads, dim_head,
                 mlp);
  a.n = n;
  a.m = dims(d, heads, dim_head, mlp, 256, scale);
  cudaStream_t s = (cudaStream_t)stream;
  const void* aligned[] = {a.x, a.out, a.w[2], a.w[3], a.w[7], a.w[9],
                           a.sv.base, cls && form == 2 ? ptrs[14] : nullptr};
  if (form == 2) {
    if (dtype != 0 || !fp32_cluster_takes(n, a.m, aligned, 8))
      return cudaErrorInvalidValue;
    if (!cls)
      return cl32::launch(block_fwd_cluster_fp32_kernel, n, batch,
                          cl32::Layout(n, 0).total, s, a);
    const ClsOut32 o = {(float*)ptrs[14], nullptr, nullptr, nullptr,
                        nullptr};
    if (o.h2 == nullptr) return cudaErrorInvalidValue;
    const int err = cl32::launch(cls_attend_cluster_fp32_kernel, n, batch,
                                 ClsFwdLayout(n).total, s, a, o);
    if (err != cudaSuccess) return err;
    return launch_cls_mlp(cls_mlp_fp32_kernel, batch, s, a,
                          (const float*)o.h2, (float*)nullptr, batch);
  }
  if (form) {
    if (form != 1 || dtype != 1 || !mmafwd::takes(n, a.m, aligned, 6))
      return cudaErrorInvalidValue;
    const size_t bytes = mmafwd::Layout(n).total;
    return cls ? mmafwd::launch_fwd(cls_fwd_mma_kernel, n, batch, bytes, s,
                                    a, batch)
               : mmafwd::launch_fwd(block_fwd_mma_kernel, n, batch, bytes, s,
                                    a, batch);
  }
  const size_t bf = Smem<__nv_bfloat16>(n, d, heads, dim_head, a.m.hc).total;
  const size_t f32 = Smem<float>(n, d, heads, dim_head, a.m.hc).total;
  if (dtype == 1)
    return cls ? launch_smem(block_fwd_kernel<__nv_bfloat16, true>, batch, bf,
                             s, a)
               : launch_smem(block_fwd_kernel<__nv_bfloat16, false>, batch,
                             bf, s, a);
  return cls ? launch_smem(block_fwd_kernel<float, true>, batch, f32, s, a)
             : launch_smem(block_fwd_kernel<float, false>, batch, f32, s, a);
}

// A measurement (chip_smoke.py), not a route: K2f (cls = 0) or K3f (cls =
// 1) on the bf16 tensor-core body with its intermediates written out
// (block_probe_kernel), or, dtype 0, K2f's fp32 cluster form
// (block_probe_cluster_fp32_kernel; k1 = 1: the body as K1's fp32 cluster
// form sums it, cl32::Fast) or K3f's (its two kernels with the probe's
// pointers: h1 and o by the attention half, hid by the MLP launch, h2 as
// the attention half hands it to the MLP). ptrs: x, 11 weights, out as
// block_forward_launch takes them, then h1, o, h2, hid, k, v as Probe (bf16)
// or Probe32 (fp32) says. The widths and alignment of
// block_forward_launch's form 1 (bf16) or 2 (fp32) (cudaErrorInvalidValue
// else).
int block_forward_probe(int dtype, int cls, const void* const* ptrs,
                        int batch, int n, int d, int heads, int dim_head,
                        int mlp, float scale, void* stream, int k1) {
  if (bad_shape(batch, n, d, heads, dim_head, mlp))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.x = ptrs[0];
  for (int i = 0; i < 11; ++i) a.w[i] = ptrs[1 + i];
  a.out = (void*)ptrs[12];
  a.n = n;
  a.m = dims(d, heads, dim_head, mlp, 256, scale);
  const void* aligned[] = {a.x, a.out, a.w[2], a.w[3], a.w[7], a.w[9]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const Probe32 pr = {(float*)ptrs[13], (float*)ptrs[14], (float*)ptrs[15],
                        (float*)ptrs[16], (float*)ptrs[17], (float*)ptrs[18]};
    if (!fp32_cluster_takes(n, a.m, aligned, 6)) return cudaErrorInvalidValue;
    if (cls) {  // K3f's cluster form itself, its h2 into the probe's
      const ClsOut32 o = {pr.h2, pr.h1, pr.o, pr.k, pr.v};
      const int err = cl32::launch(cls_attend_cluster_fp32_kernel, n, batch,
                                   ClsFwdLayout(n).total, s, a, o);
      if (err != cudaSuccess) return err;
      return launch_cls_mlp(cls_mlp_fp32_kernel, batch, s, a,
                            (const float*)pr.h2, pr.hid, batch);
    }
    const size_t bytes = cl32::Layout(n, 0).total;
    return k1 ? cl32::launch(block_probe_cluster_fp32_kernel<cl32::Fast>, n,
                             batch, bytes, s, a, pr)
              : cl32::launch(block_probe_cluster_fp32_kernel<cl32::Exact>, n,
                             batch, bytes, s, a, pr);
  }
  const Probe pr = {(bf16*)ptrs[13], (bf16*)ptrs[14], (bf16*)ptrs[15],
                    (bf16*)ptrs[16], (bf16*)ptrs[17], (bf16*)ptrs[18]};
  if (dtype != 1 || !mmafwd::takes(n, a.m, aligned, 6))
    return cudaErrorInvalidValue;
  const size_t bytes = mmafwd::Layout(n).total;
  return cls ? mmafwd::launch_fwd(block_probe_kernel<true>, n, batch, bytes,
                                  s, a, batch, pr)
             : mmafwd::launch_fwd(block_probe_kernel<false>, n, batch, bytes,
                                  s, a, batch, pr);
}

// Bytes of device workspace block_backward_launch needs for these shapes.
size_t block_backward_workspace(int dtype, int cls, int batch, int n, int d,
                                int heads, int dim_head, int mlp) {
  return workspace(cls != 0, dtype == 1 ? 2 : 4, batch, n, d, heads,
                   dim_head, mlp)
      .total;
}

// K2b (cls = 0) and K3b (cls = 1). ptrs: x (B, n, d), dy (B, n, d) or,
// with cls, (B, d), 11 weights, dx (B, n, d), 11 grads (weight shapes, in
// the compute dtype), workspace (block_backward_workspace bytes), then,
// with cls, the CLS rows' records K3f wrote (B, ClsSave stride) fp32
// (null only to measure fault k: the CLS row recomputed). form = 1
// runs the per-frame pass on the bf16 tensor-core body (block_bwd_mma,
// cls_bwd_mma), which takes bf16, d = dim_head = 64, n <= 80, mlp a
// multiple of 64 and 16-byte aligned x, dy and matrix weights; form = 2
// the pass in fp32 over a cluster of 4 CTAs a frame (K2b:
// block_bwd_cluster_fp32_kernel; K3b: cls_mlp_bwd_fp32_kernel, then
// cls_bwd_cluster_fp32_kernel, on the records, which it requires), which
// takes fp32, d = dim_head = 64, 4 heads, n <= 80, mlp a multiple of 256
// and x, dy, dx, the matrix weights and the records 16-byte aligned
// (cudaErrorInvalidValue else); form = 0 the FMA body, any width.
int block_backward_launch(int dtype, int cls, const void* const* ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, float scale, void* stream, int form) {
  if (bad_shape(batch, n, d, heads, dim_head, mlp))
    return cudaErrorInvalidValue;
  BwdArgs a = {};
  a.x = ptrs[0];
  a.dy = ptrs[1];
  for (int i = 0; i < 11; ++i) a.w[i] = ptrs[2 + i];
  a.dx = (void*)ptrs[13];
  a.n = n;
  a.m = dims(d, heads, dim_head, mlp, 128, scale);
  void* g[11];
  for (int i = 0; i < 11; ++i) g[i] = (void*)ptrs[14 + i];
  unsigned char* ws = (unsigned char*)ptrs[25];
  a.sv = ClsSave(cls ? (float*)ptrs[26] : nullptr, n, d, heads, dim_head,
                 mlp);
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_bwd<__nv_bfloat16>(cls != 0, form, a, g, ws,
                                                batch, s)
                    : launch_bwd<float>(cls != 0, form, a, g, ws, batch, s);
}

// Bytes of device workspace trunk_backward_launch needs for these shapes.
size_t trunk_backward_workspace(int dtype, int batch, int n, int d,
                                int heads, int dim_head, int mlp, int depth) {
  if (depth < 1 || depth > kMaxTrunkDepth) return 0;
  return trunk_workspace(dtype == 1 ? 2 : 4, batch, n, d, heads, dim_head,
                         mlp, depth)
      .total;
}

// K6: the backward of the whole-trunk forward (blocks_forward_launch in
// got_megakernel.cu). ptrs: x (B, n, d), dy (B, d), 11 weights per block,
// fn_s, fn_b (d, fp32), dx (B, n, d), 11 grads per block (weight shapes,
// compute dtype), dfn_s, dfn_b (d, fp32), workspace
// (trunk_backward_workspace bytes), then the streams K4 wrote in the
// compute dtype: xs, each full block's output (depth - 1, B, n, d), the
// inputs of blocks 1..; cls, the CLS row before the final norm (B, d);
// then the CLS rows' records of its last block (B, ClsSave stride) fp32
// (null only to measure fault k).
// final_norm: 0 = rms, 1 = layer. mma as block_backward_launch takes it,
// for the full blocks.
int trunk_backward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, int depth, int final_norm, float scale,
                          void* stream, int mma) {
  if (depth < 1 || depth > kMaxTrunkDepth || n_ptrs != 11 + 22 * depth ||
      bad_shape(batch, n, d, heads, dim_head, mlp))
    return cudaErrorInvalidValue;
  const Dims m = dims(d, heads, dim_head, mlp, 128, scale);
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_trunk_bwd<__nv_bfloat16>(
                          ptrs, batch, n, m, depth, final_norm, mma != 0, s)
                    : launch_trunk_bwd<float>(ptrs, batch, n, m, depth,
                                              final_norm, mma != 0, s);
}

// Rows of partial sums a weight product takes: splits(R, K, N) segments,
// each K x N floats (the part argument of weight_product_launch).
int weight_product_segments(long R, int K, int N) { return splits(R, K, N); }

// One weight product C[:, col0:col0+N] (row stride ldc) = A^T B over R
// rows, as the backwards launch them: A (R, K) and B (R, N) with row
// strides lda, ldb, C in the compute dtype; part holds
// weight_product_segments(R, K, N) x K x N floats. bf16 products that
// wgrad_mma_takes run on the tensor cores.
int weight_product_launch(int dtype, const void* A, int lda, const void* B,
                          int ldb, long R, int K, int N, void* C, int ldc,
                          int col0, void* part, void* stream) {
  if (R < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const Product p = {A, lda, B, ldb, R, K, N, C, ldc, col0};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_product<__nv_bfloat16>(p, (float*)part, s)
                    : launch_product<float>(p, (float*)part, s);
}

const char* block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
