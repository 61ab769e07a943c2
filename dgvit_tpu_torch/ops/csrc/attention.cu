// Attention kernels of the composed GoT route: the fused attention section
// (K7) and exact softmax attention over (B, H, N, D) (K8).
//
// Replaces, in dgvit_tpu/ops:
//   K7 fused_block.py::_fused_attention_section (_attn_block_kernel)
//   K8 attention.py::_attention_pallas (_attn_kernel)
//
// K7: x (B, n, d) @ wqkv (d, 3 inner) -> per frame and head softmax
// attention -> @ wout (inner, d) + bout -> (B, n, d), one launch. Matrix
// operands are values of the compute dtype T (bf16 or fp32) and every sum
// is fp32; q, k, v, the probabilities and each head's output are rounded
// to T, as the TPU kernel rounds them; the output is rounded once, after
// the bias. No q, k, v or head output touches device memory.
// K8: everything in fp32 on q, k, v cast from T (probabilities not
// rounded), the output cast to T.
// The TPU kernels pad rows to 8 (K7) or rows and width to 128 (K8) and
// mask the padded keys; here padded rows are never formed.
//
// What bounds them on an H100: at the flagship width (65 tokens, dim 64,
// 4 heads x 64) a frame of K7 costs 12.9 MFLOP for 17 KB of bf16 moved and
// a (frame, head) of K8 1.1 MFLOP for 33 KB, so against the tensor-core
// rate K7 is bound by operations and K8 by bytes; both run plain fp32 FMA
// loops far below either bound.
//
// Design, both kernels: a thread block serves a tile of query rows of one
// frame (K7) or one (frame, head) (K8). K and V of the head, every row,
// live in shared memory in T with a row stride of an odd number of 32-bit
// words, so that lanes reading different key rows hit different banks;
// one warp owns a query row at a time and computes its scores, the exact
// softmax (max, exp, sum: not the streaming form) and P.V. The scores of a
// whole head (257 x 257 fp32 = 264 KB) do not fit a block's 227 KB, which
// is why rows go by tiles: the host picks the fewest tiles whose shared
// memory fits. K7 projects its tile's q and the head's k/v from x (read
// from device memory, L2-resident) and adds each head's o @ wout slice
// into an fp32 tile that is written once.

#include "block_common.cuh"

namespace {

// Row stride (in elements) of a dh-wide row of T: an odd number of words.
template <typename T> __host__ __device__ inline int row_ld(int dh) {
  const int per_word = 4 / (int)sizeof(T);
  int words = (dh + per_word - 1) / per_word;
  if (words % 2 == 0) ++words;
  return words * per_word;
}

// Exact softmax attention of nq query rows (q, stride ldq) against n key
// and value rows (k, v, stride ldkv), one warp a row; the head's output
// goes to o[r * ldo + c]. With kRoundP the probabilities are rounded to T
// before P.V (K7); without, they stay fp32 (K8).
template <typename T, bool kRoundP>
__device__ void attend_rows(const T* q, int ldq, const T* k, const T* v,
                            int ldkv, int nq, int n, int dh, float scale,
                            float* prob_all, T* o, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prob = prob_all + (size_t)warp * n;
  for (int r = warp; r < nq; r += kWarps) {
    const T* qr = q + (size_t)r * ldq;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < n; j += 32) {
      const T* kj = k + (size_t)j * ldkv;
      float s = 0.f;
      for (int e = 0; e < dh; ++e) s = fmaf(tof(qr[e]), tof(kj[e]), s);
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
    for (int j = lane; j < n; j += 32) {
      const float p = prob[j] / sum;
      prob[j] = kRoundP ? rt<T>(p) : p;
    }
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc = fmaf(prob[j], tof(v[(size_t)j * ldkv + c]), acc);
      o[(size_t)r * ldo + c] = fromf<T>(acc);
    }
    __syncwarp();
  }
}

// ---- K8 ------------------------------------------------------------------

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n, dh, qrows;
  float scale;
};

template <typename T> struct AttnSmem {
  size_t k, v, q, prob, total;
  __host__ __device__ AttnSmem(int n, int dh, int qrows) {
    const size_t kv = sizeof(T) * n * row_ld<T>(dh);
    k = 0;
    v = align16(k + kv);
    q = align16(v + kv);
    prob = align16(q + sizeof(T) * qrows * dh);
    total = align16(prob + sizeof(float) * kWarps * n);
  }
};

// grid (B * H, query tiles): q, k, v, o are (B * H, n, dh) contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, dh = a.dh, ld = row_ld<T>(dh);
  const AttnSmem<T> L(n, dh, a.qrows);
  T* ks = (T*)(smem_raw + L.k);
  T* vs = (T*)(smem_raw + L.v);
  T* qs = (T*)(smem_raw + L.q);
  const size_t head = (size_t)blockIdx.x * n * dh;
  const int r0 = blockIdx.y * a.qrows;
  const int nq = min(a.qrows, n - r0);
  const T* k = (const T*)a.k + head;
  const T* v = (const T*)a.v + head;
  const T* q = (const T*)a.q + head + (size_t)r0 * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh, c = i % dh;
    ks[(size_t)r * ld + c] = k[i];
    vs[(size_t)r * ld + c] = v[i];
  }
  for (int i = threadIdx.x; i < nq * dh; i += blockDim.x) qs[i] = q[i];
  __syncthreads();
  attend_rows<T, false>(qs, dh, ks, vs, ld, nq, n, dh, a.scale,
                        (float*)(smem_raw + L.prob),
                        (T*)a.o + head + (size_t)r0 * dh, dh);
}

// The fewest query tiles whose shared memory fits `limit`; 0 if none does.
template <typename Layout>
int pick_tiles(int n, size_t limit, Layout bytes) {
  for (int tiles = 1; tiles <= n; ++tiles)
    if (bytes((n + tiles - 1) / tiles) <= limit) return tiles;
  return 0;
}

int smem_limit(size_t* limit) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = (size_t)max_smem;
  return err;
}

// Launch with a (x, tiles) grid and `bytes` of dynamic shared memory.
template <typename Kernel, typename KArgs>
int launch_tiles(Kernel kernel, int x, int tiles, size_t bytes,
                 cudaStream_t stream, const KArgs& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(x, tiles), kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
int launch_attention(AttnArgs& a, int bh, cudaStream_t stream) {
  size_t limit;
  const int err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  // tiles of at most 64 rows, also where one tile would fit: more thread
  // blocks in flight
  const int n = a.n, dh = a.dh;
  int tiles = pick_tiles(n, limit, [=](int rows) {
    return AttnSmem<T>(n, dh, rows).total;
  });
  if (tiles == 0) return cudaErrorInvalidValue;
  if (tiles < (n + 63) / 64) tiles = (n + 63) / 64;
  a.qrows = (n + tiles - 1) / tiles;
  tiles = (n + a.qrows - 1) / a.qrows;
  return launch_tiles(attention_kernel<T>, bh, tiles,
                      AttnSmem<T>(n, dh, a.qrows).total, stream, a);
}

// ---- K7 ------------------------------------------------------------------

struct SectionArgs {
  const void* x;
  const void* wqkv;
  const void* wout;
  const void* bout;
  void* y;
  int n, d, heads, dh, qrows;
  float scale;
};

template <typename T> struct SectionSmem {
  size_t k, v, q, o, y, prob, total;
  __host__ __device__ SectionSmem(int n, int d, int dh, int qrows) {
    const size_t kv = sizeof(T) * n * row_ld<T>(dh);
    k = 0;
    v = align16(k + kv);
    q = align16(v + kv);
    o = align16(q + sizeof(T) * qrows * dh);
    y = align16(o + sizeof(T) * qrows * dh);
    prob = align16(y + sizeof(float) * qrows * d);
    total = align16(prob + sizeof(float) * kWarps * n);
  }
};

// grid (B, query tiles)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_section_kernel(const __grid_constant__ SectionArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = a.d, dh = a.dh, inner = a.heads * dh,
            i3 = 3 * inner, ld = row_ld<T>(dh);
  const SectionSmem<T> L(n, d, dh, a.qrows);
  T* ks = (T*)(smem_raw + L.k);
  T* vs = (T*)(smem_raw + L.v);
  T* qs = (T*)(smem_raw + L.q);
  T* os = (T*)(smem_raw + L.o);
  float* ys = (float*)(smem_raw + L.y);
  float* prob = (float*)(smem_raw + L.prob);
  const int r0 = blockIdx.y * a.qrows;
  const int nq = min(a.qrows, n - r0);
  const T* x = (const T*)a.x + (size_t)blockIdx.x * n * d;
  const T* wqkv = (const T*)a.wqkv;
  const T* wout = (const T*)a.wout;
  const T* bout = (const T*)a.bout;
  T* y = (T*)a.y + ((size_t)blockIdx.x * n + r0) * d;

  for (int i = threadIdx.x; i < nq * d; i += blockDim.x) ys[i] = 0.f;
  for (int hd = 0; hd < a.heads; ++hd) {
    // q for the tile's rows; k and v for every row of the frame
    matmul(x + (size_t)r0 * d, d, nq, wqkv, i3, d, dh,
           [=](int c) { return hd * dh + c; },
           [=](int r, int c, float v) {
             qs[(size_t)r * dh + c] = fromf<T>(v);
           });
    matmul(x, d, n, wqkv, i3, d, 2 * dh,
           [=](int c) {
             return (c < dh ? inner : 2 * inner - dh) + hd * dh + c;
           },
           [=](int r, int c, float v) {
             if (c < dh)
               ks[(size_t)r * ld + c] = fromf<T>(v);
             else
               vs[(size_t)r * ld + c - dh] = fromf<T>(v);
           });
    __syncthreads();
    attend_rows<T, true>(qs, dh, ks, vs, ld, nq, n, dh, a.scale, prob, os,
                            dh);
    __syncthreads();
    matmul(os, dh, nq, wout + (size_t)hd * dh * d, d, dh, d, Ident(),
           [=](int r, int c, float v) { ys[(size_t)r * d + c] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nq * d; i += blockDim.x)
    y[i] = fromf<T>(ys[i] + tof(bout[i % d]));
}

template <typename T>
int launch_section(SectionArgs& a, int batch, cudaStream_t stream) {
  size_t limit;
  const int err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int n = a.n, d = a.d, dh = a.dh;
  const int tiles = pick_tiles(n, limit, [=](int rows) {
    return SectionSmem<T>(n, d, dh, rows).total;
  });
  if (tiles == 0) return cudaErrorInvalidValue;
  a.qrows = (n + tiles - 1) / tiles;
  return launch_tiles(attn_section_kernel<T>, batch,
                      (n + a.qrows - 1) / a.qrows,
                      SectionSmem<T>(n, d, dh, a.qrows).total, stream, a);
}

}  // namespace

extern "C" {

// K8. dtype: 0 = fp32, 1 = bf16. q, k, v, o: (bh, n, dh) contiguous.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue when K and V
// of one head do not fit a block's shared memory.
int attention_launch(int dtype, const void* q, const void* k, const void* v,
                     void* o, int bh, int n, int dh, float scale,
                     void* stream) {
  if (bh < 1 || n < 1 || dh < 1) return cudaErrorInvalidValue;
  AttnArgs a = {q, k, v, o, n, dh, 0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_attention<__nv_bfloat16>(a, bh, s)
                    : launch_attention<float>(a, bh, s);
}

// K7. x, y: (batch, n, d); wqkv (d, 3 heads dh); wout (heads dh, d);
// bout (d); all in the compute dtype.
int attention_section_launch(int dtype, const void* x, const void* wqkv,
                             const void* wout, const void* bout, void* y,
                             int batch, int n, int d, int heads, int dh,
                             float scale, void* stream) {
  if (batch < 1 || n < 1 || d < 1 || heads < 1 || dh < 1)
    return cudaErrorInvalidValue;
  SectionArgs a = {x, wqkv, wout, bout, y, n, d, heads, dh, 0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_section<__nv_bfloat16>(a, batch, s)
                    : launch_section<float>(a, batch, s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
