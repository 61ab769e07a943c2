// Whole-trunk GoT forward: one CUDA kernel for the entire inference trunk.
//
// Replaces dgvit_tpu/ops/got_megakernel.py::_mega_kernel (the Pallas TPU
// kernel behind got_forward_fused). Per frame it computes
//   patch-embed matmul + bias -> goal token prepended -> + positional
//   embedding -> depth-1 full pre-norm blocks -> a final block for the CLS
//   (goal) row only -> final RMS or Layer norm,
// with the TPU kernel's numerics: fp32 norm statistics, softmax and
// accumulation; matrix operands in the compute dtype T (bf16 or fp32);
// probabilities cast to T before P.V; the residual stream rounded to T
// after every block; GELU in tanh form for bf16 and as an fp32-accurate
// erf polynomial for fp32.
//
// What bounds it on an H100: at the flagship width a frame costs about
// 150 MFLOP over its 65 tokens and reads 41 KB of bf16 patches, so the
// work is compute-bound from a few dozen frames up (about 3,700 FLOP per
// byte of input against the card's ~295) and launch/latency-bound at one
// frame, where a single thread block runs the whole trunk serially.
//
// Design: one thread block of 256 threads per frame. The fp32 residual
// stream, the normed activations, one head's q/k/v rows, the attention
// output and one MLP hidden chunk all live in dynamic shared memory
// (about 100 KB in bf16, 165 KB in fp32), so no activation touches device
// memory between the patch read and the (64,) latent write. Weights are
// read from device memory, where the whole parameter set (2.7 MB in bf16)
// stays in the 50 MB L2. Matrix products are plain fp32 FMA loops with a
// register tile of 8 rows per thread, which reuses each weight element
// eight times; padded token rows (65 -> 72 on the TPU) are never computed.
// This is the simple correct form: tensor-core (mma/wgmma) tiles and
// several frames per block are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;
constexpr int kMaxDepth = 16;
constexpr int kMaxPtrs = 5 + 11 * kMaxDepth + 3;

struct Args {
  const void* p[kMaxPtrs];  // patches, goal, pe_w, pe_b, pos,
                            // 11 per block, fn_s, fn_b, out
  int n_patch, pd, d, heads, dh, mlp, depth, final_norm, hc;
  float scale;
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T fromf(float x);
template <> __device__ __forceinline__ float fromf<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}
// round an fp32 value through the compute dtype
template <typename T> __device__ __forceinline__ float rt(float x) {
  return tof(fromf<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row stride of the per-head q|k|v buffer: an odd number of 32-bit words,
// so lanes reading different key rows hit different banks.
template <typename T> __host__ __device__ inline int qkv_ld(int dh) {
  return 3 * dh + (sizeof(T) == 2 ? 2 : 1);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared-memory layout, shared by the host (size) and the kernel (offsets).
template <typename T> struct Smem {
  size_t x32, acc, prob, h, scratch, total;
  __host__ __device__ Smem(int n, int d, int heads, int dh, int hc) {
    int inner = heads * dh;
    size_t qkv = (size_t)n * qkv_ld<T>(dh) + (size_t)n * inner;
    size_t hid = (size_t)n * hc;
    x32 = 0;
    acc = align16(x32 + sizeof(float) * n * d);
    prob = align16(acc + sizeof(float) * n * d);
    h = align16(prob + sizeof(float) * kWarps * n);
    scratch = align16(h + sizeof(T) * n * d);
    total = align16(scratch + sizeof(T) * (qkv > hid ? qkv : hid));
  }
};

// C[r][c] = sum_k A[r][k] * W[k][wcol(c)], fp32 accumulation, handed to
// epi(r, c, value). Each thread owns a column and a tile of kRowTile rows,
// so a weight element read once serves kRowTile rows; neighbouring threads
// take neighbouring columns (coalesced weight reads, broadcast A reads).
template <typename TA, typename T, typename ColMap, typename Epi>
__device__ void matmul(const TA* A, int lda, int R, const T* W, int ldw,
                       int K, int N, ColMap wcol, Epi epi) {
  const int groups = (R + kRowTile - 1) / kRowTile;
  for (int t = threadIdx.x; t < groups * N; t += blockDim.x) {
    const int c = t % N;
    const int r0 = (t / N) * kRowTile;
    const T* w = W + wcol(c);
    const TA* a[kRowTile];
    float acc[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      a[i] = A + (size_t)min(r0 + i, R - 1) * lda;
      acc[i] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float wk = tof(w[(size_t)k * ldw]);
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) acc[i] = fmaf(tof(a[i][k]), wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i)
      if (r0 + i < R) epi(r0 + i, c, acc[i]);
  }
}

struct Ident {
  __device__ int operator()(int c) const { return c; }
};

// LayerNorm (eps 1e-5) of R fp32 rows into the compute dtype; one warp a row.
template <typename T>
__device__ void layernorm_rows(const float* x, int R, int d, const T* s,
                               const T* b, T* out) {
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
      out[(size_t)r * d + c] = fromf<T>((xr[c] - m) * inv * tof(s[c]) + tof(b[c]));
  }
}

__device__ __forceinline__ float erf32(float x) {
  // Abramowitz-Stegun 7.1.26, the polynomial the TPU kernel evaluates
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sign * (1.f - poly * expf(-ax * ax));
}

template <typename T> __device__ __forceinline__ float gelu(float x) {
  if (sizeof(T) == 2) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erf32(x * 0.7071067811865476f));
}

// Softmax attention of nq query rows against n key rows for one head.
// qkv rows hold [q | k | v] (dh each) with stride ldq; the head's output
// goes to o[r * ldo + c]. One warp per query row; keys >= n do not exist
// here (the TPU kernel masks them to exp(-inf) = 0).
template <typename T>
__device__ void attend(const T* qkv, int ldq, int nq, int n, int dh,
                       float scale, float* prob_all, T* o, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prob = prob_all + warp * n;
  for (int r = warp; r < nq; r += kWarps) {
    const T* q = qkv + (size_t)r * ldq;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < n; j += 32) {
      const T* k = qkv + (size_t)j * ldq + dh;
      float s = 0.f;
      for (int e = 0; e < dh; ++e) s = fmaf(tof(q[e]), tof(k[e]), s);
      s *= scale;
      prob[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prob[j] - mx);
      prob[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) prob[j] = rt<T>(prob[j] / sum);
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc = fmaf(prob[j], tof(qkv[(size_t)j * ldq + 2 * dh + c]), acc);
      o[(size_t)r * ldo + c] = fromf<T>(acc);
    }
    __syncwarp();
  }
}

// One pre-norm block on the shared fp32 stream x32 (n rows). With
// cls_only, k/v use every row but q, attention, out-proj and MLP run on
// row 0 alone. Leaves x32 (rows updated) unrounded.
template <typename T>
__device__ void block(const Args& a, const void* const* w, int n,
                      bool cls_only, float* x32, float* acc, float* prob,
                      T* h, T* scratch) {
  const T* an_s = (const T*)w[0];
  const T* an_b = (const T*)w[1];
  const T* wqkv = (const T*)w[2];
  const T* wout = (const T*)w[3];
  const T* bout = (const T*)w[4];
  const T* fn_s = (const T*)w[5];
  const T* fn_b = (const T*)w[6];
  const T* w1 = (const T*)w[7];
  const T* b1 = (const T*)w[8];
  const T* w2 = (const T*)w[9];
  const T* b2 = (const T*)w[10];
  const int d = a.d, dh = a.dh, inner = a.heads * a.dh, mlp = a.mlp;
  const int ldq = qkv_ld<T>(dh);
  const int nq = cls_only ? 1 : n;
  T* qkv = scratch;                        // n x ldq, one head
  T* o = scratch + (size_t)n * ldq;        // nq x inner
  T* hid = scratch;                        // nq x hc, after attention

  layernorm_rows<T>(x32, n, d, an_s, an_b, h);
  __syncthreads();
  for (int hd = 0; hd < a.heads; ++hd) {
    // q for the query rows; k and v for every row
    matmul(h, d, nq, wqkv, 3 * inner, d, dh,
           [=](int c) { return hd * dh + c; },
           [=](int r, int c, float v) {
             qkv[(size_t)r * ldq + c] = fromf<T>(v);
           });
    matmul(h, d, n, wqkv, 3 * inner, d, 2 * dh,
           [=](int c) {
             return (c < dh ? inner : 2 * inner - dh) + hd * dh + c;
           },
           [=](int r, int c, float v) {
             qkv[(size_t)r * ldq + dh + c] = fromf<T>(v);
           });
    __syncthreads();
    attend<T>(qkv, ldq, nq, n, dh, a.scale, prob, o + hd * dh, inner);
    __syncthreads();
  }
  // out-projection + bias, added to the residual stream
  matmul(o, inner, nq, wout, d, inner, d, Ident(),
         [=](int r, int c, float v) {
           x32[(size_t)r * d + c] += v + tof(bout[c]);
         });
  __syncthreads();
  layernorm_rows<T>(x32, nq, d, fn_s, fn_b, h);
  for (int i = threadIdx.x; i < nq * d; i += blockDim.x)
    acc[i] = tof(b2[i % d]);
  __syncthreads();
  // MLP, hidden dim in chunks of hc so the (rows, mlp) activation never
  // exists whole
  for (int c0 = 0; c0 < mlp; c0 += a.hc) {
    const int hc = min(a.hc, mlp - c0);
    matmul(h, d, nq, w1, mlp, d, hc,
           [=](int c) { return c0 + c; },
           [=](int r, int c, float v) {
             hid[(size_t)r * hc + c] = fromf<T>(gelu<T>(v + tof(b1[c0 + c])));
           });
    __syncthreads();
    matmul(hid, hc, nq, w2 + (size_t)c0 * d, d, hc, d, Ident(),
           [=](int r, int c, float v) { acc[(size_t)r * d + c] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nq * d; i += blockDim.x) x32[i] += acc[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    got_mega_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n_patch + 1, d = a.d, f = blockIdx.x;
  const Smem<T> L(n, d, a.heads, a.dh, a.hc);
  float* x32 = (float*)(smem_raw + L.x32);
  float* acc = (float*)(smem_raw + L.acc);
  float* prob = (float*)(smem_raw + L.prob);
  T* h = (T*)(smem_raw + L.h);
  T* scratch = (T*)(smem_raw + L.scratch);

  const T* patches = (const T*)a.p[0] + (size_t)f * a.n_patch * a.pd;
  const T* goal = (const T*)a.p[1] + (size_t)f * d;
  const T* pe_w = (const T*)a.p[2];
  const T* pe_b = (const T*)a.p[3];
  const T* pos = (const T*)a.p[4];
  const float* fn_s = (const float*)a.p[5 + 11 * a.depth];
  const float* fn_b = (const float*)a.p[6 + 11 * a.depth];
  T* out = (T*)a.p[7 + 11 * a.depth] + (size_t)f * d;

  // embed: T(T(patches @ pe_w + pe_b) + pos) rows 1.., T(goal + pos) row 0
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    x32[c] = rt<T>(tof(goal[c]) + tof(pos[c]));
  matmul(patches, a.pd, a.n_patch, pe_w, d, a.pd, d, Ident(),
         [=](int r, int c, float v) {
           const float e = rt<T>(v + tof(pe_b[c]));
           x32[(size_t)(r + 1) * d + c] =
               rt<T>(e + tof(pos[(size_t)(r + 1) * d + c]));
         });
  __syncthreads();

  for (int i = 0; i < a.depth; ++i) {
    const bool last = i == a.depth - 1;
    block<T>(a, a.p + 5 + 11 * i, n, last, x32, acc, prob, h, scratch);
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

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const Smem<T> L(a.n_patch + 1, a.d, a.heads, a.dh, a.hc);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (L.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(got_mega_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;
  got_mega_kernel<T><<<batch, kThreads, L.total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 compute. ptrs: patches (B, n_patch, pd),
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
  Args a;
  for (int i = 0; i < n_ptrs; ++i) a.p[i] = ptrs[i];
  a.n_patch = n_patch;
  a.pd = pd;
  a.d = d;
  a.heads = heads;
  a.dh = dim_head;
  a.mlp = mlp;
  a.depth = depth;
  a.final_norm = final_norm;
  a.hc = mlp < 256 ? mlp : 256;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<__nv_bfloat16>(a, batch, s)
                    : launch<float>(a, batch, s);
}

const char* got_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
