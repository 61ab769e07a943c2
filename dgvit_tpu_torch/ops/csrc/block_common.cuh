// Device code shared by the port's transformer kernels: the whole-trunk
// forwards (got_megakernel.cu: K1, K4) and the per-block forward and
// backward kernels of the gradient-bearing trunk (block_grad.cu: K2, K3).
//
// Numerics are the TPU kernel bodies' (dgvit_tpu/ops/fused_transformer.py
// `_block_body`, `_block_bwd_body`): fp32 norm statistics, softmax and
// accumulation; matrix operands in the compute dtype T (bf16 or fp32);
// probabilities cast to T before P.V; GELU in tanh form for bf16 and as an
// fp32-accurate erf polynomial for fp32. Every routine runs on one thread
// block of kThreads threads and synchronises only where it says so.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;

// Widths of one pre-norm block; hc is the MLP hidden chunk.
struct Dims {
  int d, heads, dh, mlp, hc;
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

// Shared-memory layout of `block`, shared by the host (size) and the
// kernels (offsets).
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

// The same product with both operands behind accessors a(r, k) and
// w(k, c) returning fp32, for the transposed operands of the backward
// (p^T do, ds^T q, g1 wout^T, ...). Same tiling and summation order
// (k ascending, one fmaf per term).
template <typename AFn, typename WFn, typename Epi>
__device__ void mm(int R, int N, int K, AFn a, WFn w, Epi epi) {
  const int groups = (R + kRowTile - 1) / kRowTile;
  for (int t = threadIdx.x; t < groups * N; t += blockDim.x) {
    const int c = t % N;
    const int r0 = (t / N) * kRowTile;
    int row[kRowTile];
    float acc[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      row[i] = min(r0 + i, R - 1);
      acc[i] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float wk = w(k, c);
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) acc[i] = fmaf(a(row[i], k), wk, acc[i]);
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

// The row statistics layernorm_rows uses, computed the same way: mean and
// 1 / sqrt(var + 1e-5) of R fp32 rows (for the backward's
// xhat = (x - mean) * rstd). Kept apart from layernorm_rows, as the
// backward's probabilities are kept apart from attend below: nvcc's code
// for the whole-trunk kernel changed with those two functions' shape, and
// K1 ran 18% slower on an H100 with the same arithmetic.
__device__ inline void layernorm_stats(const float* x, int R, int d,
                                       float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x + (size_t)r * d;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += xr[c];
    const float m = warp_sum(sum) / d;
    float sq = 0.f;
    for (int c = lane; c < d; c += 32) sq += (xr[c] - m) * (xr[c] - m);
    const float inv = rsqrtf(warp_sum(sq) / d + 1e-5f);
    if (lane == 0) {
      mean[r] = m;
      rstd[r] = inv;
    }
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

// The CLS row's intermediates a forward of the CLS-only block keeps for
// its backward, one fp32 record a frame (ops/cls_block.py
// `cls_saved_width` mirrors the layout): q (inner, rounded to T), the
// fp32 probabilities (heads x n), o (inner, rounded), x1 (d, the fp32
// stream after the attention), h2 (d, rounded) and the MLP's fp32
// pre-activations z = h2 w1 + b1 (mlp). The forward writes it, every body
// as that body computes the values, when autograd records (a null base:
// nothing written); the backward then reads it in place of the CLS row's
// single-row chains (K3b, K6's last block).
struct ClsSave {
  float* base;
  int stride, p, o, x1, h2, z;
  __host__ __device__ ClsSave()
      : base(nullptr), stride(0), p(0), o(0), x1(0), h2(0), z(0) {}
  __host__ __device__ ClsSave(float* b, int n, int d, int heads, int dh,
                              int mlp)
      : base(b) {
    const int inner = heads * dh;
    p = inner;
    o = p + heads * n;
    x1 = o + inner;
    h2 = x1 + d;
    z = h2 + d;
    stride = z + mlp;
  }
  __device__ float* at(int f) const { return base + (size_t)f * stride; }
};

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

// The probabilities `attend` forms for one query row q against n key rows
// k (stride ldk), left unrounded in p[0..n): the backward needs them
// before the cast. One warp; ends with __syncwarp.
template <typename T>
__device__ void softmax_row(const T* q, const T* k, int ldk, int n, int dh,
                            float scale, float* p) {
  const int lane = threadIdx.x % 32;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = lane; j < n; j += 32) {
    const T* kj = k + (size_t)j * ldk;
    float s = 0.f;
    for (int e = 0; e < dh; ++e) s = fmaf(tof(q[e]), tof(kj[e]), s);
    s *= scale;
    p[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(p[j] - mx);
    p[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32) p[j] = p[j] / sum;
  __syncwarp();
}

// One pre-norm block on the shared fp32 stream x32 (n rows). `w` holds the
// 11 weights in the fused-transformer order. With cls_only, k/v use every
// row but q, attention, out-proj and MLP run on row 0 alone. Leaves x32
// (rows updated) unrounded. kSave, with cls_only and a non-null `save`
// (the frame's ClsSave record): the CLS row's intermediates as this body
// computes them (the probabilities by softmax_row, attend's arithmetic).
template <typename T, bool kSave = false>
__device__ void block(const Dims& m, const void* const* w, int n,
                      bool cls_only, float* x32, float* acc, float* prob,
                      T* h, T* scratch, float* save = nullptr,
                      ClsSave lay = ClsSave()) {
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
  const int d = m.d, dh = m.dh, inner = m.heads * m.dh, mlp = m.mlp;
  const int ldq = qkv_ld<T>(dh);
  const int nq = cls_only ? 1 : n;
  T* qkv = scratch;                        // n x ldq, one head
  T* o = scratch + (size_t)n * ldq;        // nq x inner
  T* hid = scratch;                        // nq x hc, after attention

  layernorm_rows<T>(x32, n, d, an_s, an_b, h);
  __syncthreads();
  for (int hd = 0; hd < m.heads; ++hd) {
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
    attend<T>(qkv, ldq, nq, n, dh, m.scale, prob, o + hd * dh, inner);
    __syncthreads();
    if constexpr (kSave) {
      if (save != nullptr) {  // q and the probabilities of the CLS row
        for (int c = threadIdx.x; c < dh; c += blockDim.x)
          save[hd * dh + c] = tof(qkv[c]);
        if (threadIdx.x < 32)
          softmax_row<T>(qkv, qkv + dh, ldq, n, dh, m.scale,
                         save + lay.p + hd * n);
        __syncthreads();
      }
    }
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
  if constexpr (kSave) {
    if (save != nullptr) {  // o, x1 and h2 of the CLS row
      for (int c = threadIdx.x; c < inner; c += blockDim.x)
        save[lay.o + c] = tof(o[c]);
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        save[lay.x1 + c] = x32[c];
        save[lay.h2 + c] = tof(h[c]);
      }
    }
  }
  // MLP, hidden dim in chunks of hc so the (rows, mlp) activation never
  // exists whole
  for (int c0 = 0; c0 < mlp; c0 += m.hc) {
    const int hc = min(m.hc, mlp - c0);
    matmul(h, d, nq, w1, mlp, d, hc,
           [=](int c) { return c0 + c; },
           [=](int r, int c, float v) {
             const float z = v + tof(b1[c0 + c]);
             if constexpr (kSave)
               if (save != nullptr) save[lay.z + c0 + c] = z;
             hid[(size_t)r * hc + c] = fromf<T>(gelu<T>(z));
           });
    __syncthreads();
    matmul(hid, hc, nq, w2 + (size_t)c0 * d, d, hc, d, Ident(),
           [=](int r, int c, float v) { acc[(size_t)r * d + c] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nq * d; i += blockDim.x) x32[i] += acc[i];
  __syncthreads();
}

// The device's opt-in limit of shared memory a block (*limit), and
// `kernel`'s cap on dynamic shared memory raised to it: queried and set
// once a host thread, device and kernel, not at every launch (each costs
// a round trip into the CUDA runtime, which a launch of a few
// microseconds should not pay).
// Every thread sets the same value, the device's limit, so no thread
// lowers the cap under another's launch. Returns a cudaError_t.
template <typename Kernel>
int smem_opt_in(Kernel kernel, size_t* limit) {
  struct Seen {
    const void* fn;
    int dev;
    size_t limit;
  };
  constexpr int kSeen = 64;
  static thread_local Seen seen[kSeen];
  static thread_local int count = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < count; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev) {
      *limit = seen[i].limit;
      return cudaSuccess;
    }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err != cudaSuccess) return err;
  if (count < kSeen) seen[count++] = {fn, dev, (size_t)max_smem};
  *limit = (size_t)max_smem;
  return cudaSuccess;
}

// Launch a kernel with `bytes` of dynamic shared memory, after checking
// the device allows it. Returns a cudaError_t (0 = launched).
template <typename Kernel, typename... KArgs>
int launch_smem(Kernel kernel, int grid, size_t bytes, cudaStream_t stream,
                const KArgs&... args) {
  size_t limit = 0;
  const int err = smem_opt_in(kernel, &limit);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
