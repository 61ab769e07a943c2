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
// Forward: K3f, and K2f off the flagship widths and in fp32, run one
// thread block per frame on `block` (block_common.cuh) with the frame's
// fp32 stream in shared memory, as K1 does, and write the block's output
// (K2f: every row; K3f: the CLS row) in the compute dtype T. The bf16 K2f
// at the flagship widths (tensor_core_fwd in ops/fused_transformer.py)
// runs block_fwd_mma_kernel: the tensor-core body of block_mma_fwd.cuh,
// two frames a thread block.
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
// products in the same order) for fp32 and for the bf16 FMA bodies. At
// the flagship widths the bf16 full block runs on the tensor cores both
// ways, K2f on block_mma_fwd.cuh's body and K2b's recompute in
// block_bwd_mma, and K3b's k/v recompute runs on them (cls_bwd_mma)
// while K3f keeps the FMA body, with the same bf16 operands and rounding
// points; where
// their sums differ in order (see block_mma_fwd.cuh), now and then one
// bf16 rounding of the recomputed q, k, v, o or hidden activations lands
// on the other side. That is the same kind of difference the checks
// already allow against the plain version (cuBLAS sums in yet another
// order): a flip moves what follows by about one ulp of its own size,
// which phase 5's per-tensor max (2^-6 L) and pooled mean (2^-18) of
// chip_smoke.py admit, as does phase 13's per-frame rule (two thirds of
// K6's frames within 2^-18), and the wrong versions still miss them by a
// rounding point moved everywhere, not now and then. K6's own forward
// chain keeps the FMA body.
// The TPU pads 65 rows to 72 and masks the padded keys; padded rows carry
// zero gradient there, so computing the 65 real rows is exact.
//
// K6 is the backward of the whole-trunk forward K4 (got_megakernel.cu).
// The TPU kernel sums its weight gradients across a sequential grid; here
// blocks run in no order, so it takes the two passes above: one thread
// block per frame recomputes the chain of block inputs (rounded to T at
// every block boundary, kept in a workspace), runs the final norm's
// backward, then the CLS block's and the full blocks' per-frame passes in
// reverse (the bodies of K3b and K2b, each dx written in T and read back
// as the next dy); then every block's weight products as above. Its output
// is K3b and K2b chained. The TPU kernel's smaller MLP chunk is its memory
// budget, not part of the function: every block here keeps K2b's chunk.
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
// (cls_bwd_mma), and keeps its single-row chains on the CUDA cores. The
// bf16 K2f at those widths runs on the tensor cores too
// (block_fwd_mma_kernel), and so do the bf16 weight products
// (wgrad_mma_kernel, bound by the bytes of their operands). K3f, the fp32
// bodies and products, and K6's forward chain are FMA work on fp32 CUDA
// cores, far from the bf16 tensor-core roofline.
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
  block<T>(a.m, a.w, n, kCls, x32, (float*)(smem_raw + L.acc),
           (float*)(smem_raw + L.prob), (T*)(smem_raw + L.h),
           (T*)(smem_raw + L.scratch));
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
// takes any width (fp32 always: TF32 would not meet the fp32 checks).
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

// The per-frame pass of the CLS-only block's backward for frame f: the
// body of K3b's kernel and of the last block of K6's.
template <typename T>
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

  // ---- recompute: LN1 (all rows) -> k/v (all rows), q (CLS row) ---------
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  layernorm_stats(x32, n, d, mean1, rstd1);
  layernorm_rows<T>(x32, n, d, an_s, an_b, H1);
  __syncthreads();
  matmul(H1, d, n, wqkv, i3, d, i2, [=](int c) { return inner + c; },
         [=](int r, int c, float v) { KV[(size_t)r * i2 + c] = fromf<T>(v); });
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
  matmul(O, inner, 1, wout, d, inner, d, Ident(), [=](int r, int c, float v) {
    x1[c] = x32[c] + (v + tof(bout[c]));
  });
  __syncthreads();
  layernorm_stats(x1, 1, d, mean2, rstd2);
  layernorm_rows<T>(x1, 1, d, fn_s, fn_b, H2);
  for (int c = threadIdx.x; c < d; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();

  // ---- MLP forward + backward on the CLS row: acc row 0 = dh2 ----------
  for (int c0 = 0; c0 < mlp; c0 += m.hc) {
    const int hc = min(m.hc, mlp - c0);
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
// q, o, h2, hid, dpre, g1, do, ds, dq and dk|dv rounded to bf16 where it
// rounds them). Its two products over every row of the frame run on
// mma.sync tiles as block_bwd_mma runs them: per head, k and v are
// projected from h1 (a bf16 tile in shared memory, rows padded to a
// multiple of 16 with zeros) with the head's k|v columns of wqkv (staged
// by cp.async, the next head's slice in flight), and the head's dk|dv tile
// times the same slice read as [N][K] is added into the fp32 dh1 tile.
// Only the order of those two products' sums differs from the FMA body;
// every product of the CLS row (q, the scores and P.V, the
// out-projection, the MLP matvecs, do, dp, dq, and dq's part of dh1) is
// the FMA body's fp32 chain, term by term in the same order, on the CUDA
// cores: one row gives a tensor core nothing to do. Their operands are
// read from shared memory, their weights from device memory (L2) in
// 16-byte loads; the MLP runs every hidden column at once, eight a
// thread, and dh2's partial sums over chunks of kClsChunk hidden columns
// are taken in parallel, then added in chunk order as the FMA body adds
// them. k and v are projected again in the backward's head loop rather
// than kept, so the layout does not grow with the heads; the
// probabilities are formed again there by the same code. k, v and dk|dv
// never go to device memory but for dk|dv's slot, which the weight
// product h1^T dk|dv reads.
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
// it).
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

  // ---- recompute: LN1 (all rows) -> q (CLS row) -> per head k/v (all
  // rows) and the CLS row's attention -> x1, LN2 ------------------------
  stage(0);
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) x32[i] = tof(x[i]);
  for (int c = threadIdx.x; c < D; c += blockDim.x) dys[c] = tof(dy[c]);
  __syncthreads();
  layernorm_stats(x32, n, D, mean1, rstd1);
  layernorm_tile(x32, n, D, an_s, an_b, h1s, kLd);
  zero_rows(h1s, kLd, n, np, D);
  __syncthreads();
  store_rows(H1, D, h1s, kLd, n, D);
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
  __syncthreads();

  // ---- MLP forward + backward on the CLS row, eight hidden columns a
  // thread: hid, dpre (its unrounded sum is db1's row), then dh2 = dpre_c
  // w1^T in acc row 0 -----------------------------------------------------
  for (int c = threadIdx.x; c < D; c += blockDim.x) H2[c] = h2s[c];
  for (int c0 = 8 * threadIdx.x; c0 < mlp; c0 += 8 * blockDim.x) {
    float pre[8] = {}, wv[8];
    for (int kk = 0; kk < D; ++kk) {
      load8(wv, w1 + (size_t)kk * mlp + c0);
      const float h = tof(h2s[kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i) pre[i] = fmaf(h, wv[i], pre[i]);
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
      const float z = pre[i] + tof(b1[c0 + i]);
      hid[i] = gelu<T>(z);
      dp[i] = s * gelu_grad<T>(z);
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
    // the forward's probabilities again; dp = do v^T, then
    // ds = T((p (dp - sum_j dp p)) scale), as cls_bwd_body forms them
    if (warp == 0) {
      softmax_row<T>(qh, k, kLd, n, DH, m.scale, p);
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
template <typename T, bool Mma>
__device__ __forceinline__ void cls_bwd(const BwdArgs& a, int f,
                                        unsigned char* smem_raw) {
  if constexpr (Mma)
    cls_bwd_mma(a, f, smem_raw);
  else
    cls_bwd_body<T>(a, f, smem_raw);
}

template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads)
    cls_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cls_bwd<T, Mma>(a, blockIdx.x, smem_raw);
}

// K6, the per-frame pass of the whole trunk's backward. One thread block
// per frame: the forward chain (the whole-trunk forward's blocks, stream
// rounded to T after each and written to blk[i + 1].x), the final norm's
// backward on the rounded CLS row, then the CLS block's and the full
// blocks' backward bodies in reverse (with Mma: cls_bwd_mma and
// block_bwd_mma). A block's dx is written in T and read back as the next
// one's dy, which is the rounding between blocks.
struct TrunkBwdArgs {
  BwdArgs blk[kMaxTrunkDepth];
  const void* dy;     // (B, d) in T: grad of the normed latent
  void* dcls;         // (B, d) in T: blk[depth - 1].dy, written here
  const float* fn_s;  // final-norm scale and bias, fp32
  const float* fn_b;
  float* fnvec;       // (B, 2 d): each frame's final-norm grads
  int depth, final_norm, hc_fwd;
};

template <typename T, bool Mma>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_bwd_kernel(const __grid_constant__ TrunkBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f = blockIdx.x, depth = a.depth;
  const int n = a.blk[0].n, d = a.blk[0].m.d;
  Dims mf = a.blk[0].m;
  mf.hc = a.hc_fwd;
  const Smem<T> L(n, d, mf.heads, mf.dh, mf.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  const size_t fr = (size_t)f * n * d;

  const T* x = (const T*)a.blk[0].x + fr;
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) x32[i] = tof(x[i]);
  __syncthreads();
  for (int i = 0; i < depth; ++i) {
    const bool last = i == depth - 1;
    block<T>(mf, a.blk[i].w, n, last, x32, (float*)(smem_raw + L.acc),
             (float*)(smem_raw + L.prob), (T*)(smem_raw + L.h),
             (T*)(smem_raw + L.scratch));
    if (last) {
      for (int j = threadIdx.x; j < d; j += blockDim.x) x32[j] = rt<T>(x32[j]);
    } else {
      T* nxt = (T*)a.blk[i + 1].x + fr;
      for (int j = threadIdx.x; j < n * d; j += blockDim.x) {
        const T v = fromf<T>(x32[j]);
        nxt[j] = v;
        x32[j] = tof(v);
      }
    }
    __syncthreads();
  }

  // final-norm backward on the CLS row (warp 0): dcls in T, and this
  // frame's scale and bias grads
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
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

  cls_bwd<T, Mma>(a.blk[depth - 1], f, smem_raw);
  for (int i = depth - 2; i >= 0; --i) {
    __syncthreads();
    block_bwd<T, Mma>(a.blk[i], f, smem_raw);
  }
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
// does (TF32 would not meet the fp32 checks).
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

template <typename T>
int launch_bwd(bool cls, bool mma, BwdArgs& a, void* const* g,
               unsigned char* ws, int B, cudaStream_t stream) {
  float* part = bind(cls, sizeof(T), a, ws, B);
  const BwdSmem L(a.n, a.m.d, a.m.hc);
  int err;
  if (!mma) {
    err = cls ? launch_smem(cls_bwd_kernel<T, false>, B, L.total, stream, a)
              : launch_smem(block_bwd_kernel<T, false>, B, L.total, stream,
                            a);
  } else if constexpr (std::is_same<T, bf16>::value) {
    if (!mma_body_takes(a)) return cudaErrorInvalidValue;
    err = cls ? launch_smem(cls_bwd_kernel<T, true>, B,
                            ClsMmaSmem(a.n, a.m.heads * kMmaD, a.m.mlp).total,
                            stream, a)
              : launch_smem(block_bwd_kernel<T, true>, B,
                            MmaBwdSmem(a.n).total, stream, a);
  } else {
    return cudaErrorInvalidValue;  // the tensor-core body is bf16's
  }
  if (err != cudaSuccess) return err;
  return launch_grads<T>(cls, a, g, part, B, stream);
}

// K6's device workspace: the chain's block inputs x_1.., the CLS grad,
// the dx between blocks, the frames' final-norm grads, then each block's
// own workspace.
struct TrunkWorkspace {
  size_t xs[kMaxTrunkDepth], dxs[kMaxTrunkDepth], blk[kMaxTrunkDepth], dcls,
      fnvec, total;
};

TrunkWorkspace trunk_workspace(size_t esize, int B, int n, int d, int heads,
                               int dh, int mlp, int depth) {
  TrunkWorkspace w = {};
  const size_t stream_bytes = esize * B * n * d;
  size_t off = 0;
  for (int i = 1; i < depth; ++i) {
    w.xs[i] = off;
    off = align16(off + stream_bytes);
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

// K6's shared memory: the forward chain's (the FMA body's, MLP chunk 256)
// and the largest backward body's it runs.
template <typename T>
size_t trunk_bwd_bytes(int n, const Dims& m, bool mma) {
  size_t bytes = Smem<T>(n, m.d, m.heads, m.dh, m.mlp < 256 ? m.mlp : 256)
                     .total;
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
  const TrunkWorkspace w = trunk_workspace(sizeof(T), B, n, m.d, m.heads,
                                           m.dh, m.mlp, depth);
  TrunkBwdArgs a = {};
  float* part[kMaxTrunkDepth];
  for (int i = 0; i < depth; ++i) {
    BwdArgs& b = a.blk[i];
    b.x = i == 0 ? ptrs[0] : ws + w.xs[i];
    b.dy = i == depth - 1 ? ws + w.dcls : ws + w.dxs[i + 1];
    for (int j = 0; j < 11; ++j) b.w[j] = wts[11 * i + j];
    b.dx = i == 0 ? (void*)ptrs[4 + 11 * depth] : ws + w.dxs[i];
    b.n = n;
    b.m = m;
    part[i] = bind(i == depth - 1, sizeof(T), b, ws + w.blk[i], B);
  }
  a.dy = ptrs[1];
  a.dcls = ws + w.dcls;
  a.fn_s = (const float*)ptrs[2 + 11 * depth];
  a.fn_b = (const float*)ptrs[3 + 11 * depth];
  a.fnvec = (float*)(ws + w.fnvec);
  a.depth = depth;
  a.final_norm = final_norm;
  a.hc_fwd = m.mlp < 256 ? m.mlp : 256;  // the forward kernels' MLP chunk
  const size_t bytes = trunk_bwd_bytes<T>(n, m, mma);
  int err;
  if (!mma) {
    err = launch_smem(trunk_bwd_kernel<T, false>, B, bytes, stream, a);
  } else if constexpr (std::is_same<T, bf16>::value) {
    for (int i = 0; i < depth; ++i)
      if (!mma_body_takes(a.blk[i])) return cudaErrorInvalidValue;
    err = launch_smem(trunk_bwd_kernel<T, true>, B, bytes, stream, a);
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
// these shapes; mma = 1: K2f on the tensor-core body.
size_t block_forward_smem(int dtype, int cls, int n, int d, int heads,
                          int dim_head, int mlp, int mma) {
  if (mma && !cls) return mmafwd::Layout(n).total;
  const int hc = mlp < 256 ? mlp : 256;
  return dtype == 1 ? Smem<__nv_bfloat16>(n, d, heads, dim_head, hc).total
                    : Smem<float>(n, d, heads, dim_head, hc).total;
}

// Bytes of dynamic shared memory of the per-frame pass of K2b (cls = 0)
// and K3b (cls = 1); mma = 1: on the tensor-core bodies.
size_t block_backward_smem(int dtype, int cls, int n, int d, int heads,
                           int dim_head, int mlp, int mma) {
  (void)dtype;
  if (mma) return cls ? ClsMmaSmem(n, heads * dim_head, mlp).total
                      : MmaBwdSmem(n).total;
  return BwdSmem(n, d, mlp < 128 ? mlp : 128).total;
}

// Bytes of dynamic shared memory of K6's per-frame pass; mma = 1: its
// full blocks on the tensor-core body.
size_t trunk_backward_smem(int dtype, int n, int d, int heads, int dim_head,
                           int mlp, int mma) {
  const Dims m = dims(d, heads, dim_head, mlp, 128, 1.f);
  return dtype == 1 ? trunk_bwd_bytes<__nv_bfloat16>(n, m, mma != 0)
                    : trunk_bwd_bytes<float>(n, m, mma != 0);
}

// K2f (cls = 0) and K3f (cls = 1). dtype: 0 = fp32, 1 = bf16 compute.
// ptrs: x (B, n, d), 11 weights in the fused-transformer order, out
// (B, n, d) or, with cls, (B, d). mma = 1 runs K2f on the bf16
// tensor-core body, which takes bf16, d = dim_head = 64, n <= 80, mlp a
// multiple of 64 and 16-byte aligned x, out and matrix weights
// (cudaErrorInvalidValue else); mma = 0 the FMA body, any width. Returns a
// cudaError_t (0 = launched).
int block_forward_launch(int dtype, int cls, const void* const* ptrs,
                         int batch, int n, int d, int heads, int dim_head,
                         int mlp, float scale, void* stream, int mma) {
  if (bad_shape(batch, n, d, heads, dim_head, mlp))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.x = ptrs[0];
  for (int i = 0; i < 11; ++i) a.w[i] = ptrs[1 + i];
  a.out = (void*)ptrs[12];
  a.n = n;
  a.m = dims(d, heads, dim_head, mlp, 256, scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (mma) {
    const void* aligned[] = {a.x, a.out, a.w[2], a.w[3], a.w[7], a.w[9]};
    if (dtype != 1 || cls || !mmafwd::takes(n, a.m, aligned, 6))
      return cudaErrorInvalidValue;
    return mmafwd::launch_fwd(block_fwd_mma_kernel, n, batch, s, a, batch);
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

// Bytes of device workspace block_backward_launch needs for these shapes.
size_t block_backward_workspace(int dtype, int cls, int batch, int n, int d,
                                int heads, int dim_head, int mlp) {
  return workspace(cls != 0, dtype == 1 ? 2 : 4, batch, n, d, heads,
                   dim_head, mlp)
      .total;
}

// K2b (cls = 0) and K3b (cls = 1). ptrs: x (B, n, d), dy (B, n, d) or,
// with cls, (B, d), 11 weights, dx (B, n, d), 11 grads (weight shapes, in
// the compute dtype), workspace (block_backward_workspace bytes). mma = 1
// runs the per-frame pass on the bf16 tensor-core body (block_bwd_mma,
// cls_bwd_mma), which takes
// bf16, d = dim_head = 64, n <= 80, mlp a multiple of 64 and 16-byte
// aligned x, dy and matrix weights (cudaErrorInvalidValue else); mma = 0
// the FMA body, any width.
int block_backward_launch(int dtype, int cls, const void* const* ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, float scale, void* stream, int mma) {
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
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_bwd<__nv_bfloat16>(cls != 0, mma != 0, a, g, ws,
                                                batch, s)
                    : launch_bwd<float>(cls != 0, mma != 0, a, g, ws, batch,
                                        s);
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
// (trunk_backward_workspace bytes). final_norm: 0 = rms, 1 = layer. mma
// as block_backward_launch takes it, for the full blocks.
int trunk_backward_launch(int dtype, const void* const* ptrs, int n_ptrs,
                          int batch, int n, int d, int heads, int dim_head,
                          int mlp, int depth, int final_norm, float scale,
                          void* stream, int mma) {
  if (depth < 1 || depth > kMaxTrunkDepth || n_ptrs != 8 + 22 * depth ||
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
