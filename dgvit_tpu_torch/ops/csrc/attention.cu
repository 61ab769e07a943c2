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
// rate K7 is bound by operations and K8 by bytes. The bf16 K8 runs on the
// tensor cores (below), and so does the bf16 K7 at d = dim_head = 64 and
// n <= 80 (attn_section_mma_kernel, at the end: block_mma_fwd.cuh's
// attention half); the fp32 K8 runs on them as 3xTF32
// (attention_tf32_kernel, below: a tile of queries a block, K and V
// streamed); the fp32 K7, and K7 at other widths or longer frames, run
// plain fp32 FMA loops far below either bound.
//
// K7's FMA kernel and the fp32 K8's first design (attention_kernel, kept
// only to be timed beside its replacement): a thread block serves a tile
// of query rows of one frame (K7) or one (frame, head) (K8). K and V of
// the head, every row, live in shared memory in T with a row stride of an odd
// number of 32-bit words, so that lanes reading different key rows hit
// different banks;
// one warp owns a query row at a time and computes its scores, the exact
// softmax (max, exp, sum: not the streaming form) and P.V. The scores of a
// whole head (257 x 257 fp32 = 264 KB) do not fit a block's 227 KB, which
// is why rows go by tiles: the host picks the fewest tiles whose shared
// memory fits. K7 projects its tile's q and the head's k/v from x (read
// from device memory, L2-resident) and adds each head's o @ wout slice
// into an fp32 tile that is written once.
//
// The bf16 K8 (attention_mma_kernel) computes the same function on the
// tensor cores (mma_common.cuh). A work item is a (frame, head) and a tile
// of at most 8 x 16 of its query rows (one tile up to 128 tokens). The
// grid is persistent: each thread block walks items with the grid's
// stride, q, k and v arriving by 16-byte cp.async in tiles that ldmatrix
// reads without bank conflicts (rows padded to a multiple of 16 with
// zeros). With two stages of shared memory the next item's copies run
// while the warps work on this one; a head too long for two thread blocks
// of two stages on an SM (257 tokens) takes one stage, so that two thread
// blocks share the SM. Each warp owns 16 query rows:
//  * S = q k^T by bf16 mma.sync into fp32: bf16 products are exact in
//    fp32, so only the order of the sums differs from fp32 FMA; then the
//    scale, and padded keys masked to -inf before the max.
//  * The exact softmax in registers, quad shuffles for the row max and
//    row sum: p = exp(s - max) times the reciprocal of the sum, the exp
//    taken as exp2 of scores scaled by log2(e) (within a few ulps of the
//    plain version's exp and quotient, far below the split's 2^-17).
//  * P.V keeps p fp32-accurate: p = hi + lo with hi = bf16(p) and
//    lo = bf16(p - hi) (p - hi is exact in fp32), and P.V = hi.V + lo.V,
//    both on the tensor cores into one fp32 sum. hi + lo carries about 16
//    bits of p (|p - hi - lo| <= 2^-17 |p|), far below the output's bf16
//    rounding; p rounded to bf16 once would be another function, and
//    tests/test_torch_attention.py shows that it fails the pooled limit
//    that the split passes.
//  * 80 keys at a time in registers (16 x 80 fp32 scores a warp). Up to
//    80 keys the scores and their exps are formed once and p is the exact
//    softmax above. A longer head takes the
//    streaming softmax in fp32, one walk over its key tiles: the row max
//    grows tile by tile, the sum and the output so far are rescaled by
//    exp(old max - new max), and the output is divided by the sum at the
//    end. That differs from the plain version by fp32 roundings, far below
//    the split's 2^-17, and forms each score once (an exact softmax would
//    form them twice: max and sum first, then P.V).
//  * The output goes 64 columns at a time (D = 160: three walks of P.V),
//    bf16 pairs in 4-byte stores.

#include "block_common.cuh"
#include "block_mma_fwd.cuh"
#include "mma_common.cuh"
#include "tf32_mma.cuh"

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
  int vec16;  // bf16: rows go by 16-byte copies (dh % 8 == 0, aligned)
};

// the fp32 K8's shared memory (the bf16 K8 is attention_mma_kernel)
struct AttnSmem {
  size_t k, v, q, prob, total;
  __host__ __device__ AttnSmem(int n, int dh, int qrows) {
    const size_t kv = sizeof(float) * n * row_ld<float>(dh);
    k = 0;
    v = align16(k + kv);
    q = align16(v + kv);
    prob = align16(q + sizeof(float) * qrows * dh);
    total = align16(prob + sizeof(float) * kWarps * n);
  }
};

// The fp32 K8. grid (B * H, query tiles): q, k, v, o are (B * H, n, dh)
// contiguous.
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __grid_constant__ AttnArgs a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, dh = a.dh, ld = row_ld<T>(dh);
  const AttnSmem L(n, dh, a.qrows);
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

// Launch with a (x, tiles) grid of kThreads threads and `bytes` of dynamic
// shared memory (under the cap smem_opt_in raised).
template <typename Kernel, typename KArgs>
int launch_tiles(Kernel kernel, int x, int tiles, size_t bytes,
                 cudaStream_t stream, const KArgs& args) {
  kernel<<<dim3(x, tiles), kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// The fp32 K8's first design (attention_kernel). No route launches it:
// attention_fma_launch keeps it so that a chip run can time it beside
// attention_tf32_kernel, the fp32 K8.
int launch_attention_fma(AttnArgs& a, int bh, cudaStream_t stream) {
  size_t limit;
  const int err = smem_opt_in(attention_kernel, &limit);
  if (err != cudaSuccess) return err;
  // tiles of at most 64 rows, also where one tile would fit: more thread
  // blocks in flight
  const int n = a.n, dh = a.dh;
  int tiles = pick_tiles(n, limit, [=](int rows) {
    return AttnSmem(n, dh, rows).total;
  });
  if (tiles == 0) return cudaErrorInvalidValue;
  if (tiles < (n + 63) / 64) tiles = (n + 63) / 64;
  a.qrows = (n + tiles - 1) / tiles;
  tiles = (n + a.qrows - 1) / a.qrows;
  return launch_tiles(attention_kernel, bh, tiles,
                      AttnSmem(n, dh, a.qrows).total, stream, a);
}

// ---- K8, fp32, on the tensor cores (3xTF32) ---------------------------------
//
// attention_tf32_kernel: a thread block of 4 warps takes a tile of 64 query
// rows of one (frame, head), 16 rows a warp. K and V stream through shared
// memory in tiles of kt keys (32, or fewer where a head is too wide for
// two stages), by 16-byte cp.async (zero-filled past the head's rows and
// width) in two stages, the next tile's copies in flight while the warps
// work on this one; q's tile arrives once. Per key tile a warp forms its
// 16 x kt scores in registers, S = q k^T on the tensor cores as 3xTF32
// (tf32_mma.cuh: fp32-accurate), its hi x hi products and its two small
// ones summed apart and added once, scaled; keys >= n go to -inf. The
// softmax is the streaming form in fp32, as the bf16 K8 takes it past 80
// keys: the row max grows tile by tile, the sum and the output so far are
// rescaled by exp(old max - new max), p = exp(s - max) joins the sum, and
// the tile's P.V (3xTF32 again, p split as the scores' operands are) is
// summed from zero and added to the output. So no tensor-core sum runs
// longer than one tile (they truncate as they accumulate: one running
// sum over a head of a thousand keys drifted to the edge of the fp32
// check). The output is divided by the sum once, at the
// end. exp is taken as exp2 of scores in base-2 units. A thread block
// writes 64 output columns (D = 160: three thread blocks walk the keys
// for one tile of query rows, side by side); padded query rows and
// columns are never stored.
// So nothing of a head but its 64-row tile and two key tiles is ever
// resident: any head length runs (the first design held K and V of the
// whole head, which capped it).
//
// What bounds it on an H100: at the SimpleViT's (32, 8, 256, 64) the
// function is 4.3 GFLOP over 33.6 MB, bound by operations at the fp32 rate
// (0.064 ms); 3xTF32 spends three tensor-core products a product, so its
// own ceiling is the TF32 rate over three (165 TFLOP/s), above the fp32
// FMA units' 67.

constexpr int kTfRows = 64;                // query rows a thread block
constexpr int kTfThreads = 32 * kTfRows / 16;
// most keys a tile: 64 would hold more scores and products a thread (202
// registers against 160) and fewer thread blocks an SM
constexpr int kTfKeys = 32;
constexpr int kTfOut = 64;                 // output columns a walk

__host__ __device__ inline int round8(int x) { return (x + 7) / 8 * 8; }
// Row strides (in floats) of the fp32 tiles for a head width dp (a
// multiple of 8). Rows of q and k are read as pairs (2t, 2t + 1) of row g,
// 8-byte loads free of bank conflicts at a stride of 8 mod 32; rows of v
// as single values of rows 2t and 2t + 1 at column g, free of them at 4
// mod 32. Both are multiples of 4: 16-byte rows for cp.async.
__host__ __device__ inline int ld_pairs(int dp) {
  return dp + (40 - dp % 32) % 32;
}
__host__ __device__ inline int ld_cols(int dp) {
  return dp + (36 - dp % 32) % 32;
}

// attention_tf32_kernel's shared memory: q's tile, then two stages of a k
// and a v tile of kt keys
struct Tf32Smem {
  size_t q, k, v, stage, total;
  __host__ __device__ Tf32Smem(int dh, int kt) {
    const int dp = round8(dh);
    q = 0;
    k = align16(sizeof(float) * kTfRows * ld_pairs(dp));
    v = align16(k + sizeof(float) * kt * ld_pairs(dp));
    stage = align16(v + sizeof(float) * kt * ld_cols(dp)) - k;
    total = k + 2 * stage;
  }
};

// Rows [r0, r0 + count) of a (n, dh) fp32 head g into a tile (row stride
// ld, dp columns): rows >= n and columns >= dh zero. vec: 16-byte
// cp.async (dh % 4 == 0, g 16-byte aligned; the caller commits), else
// plain loads and stores.
__device__ __forceinline__ void tile_rows(float* s, int ld, const float* g,
                                          int r0, int count, int n, int dh,
                                          int dp, bool vec) {
  if (vec) {
    const int per = dp / 4;
    for (int i = threadIdx.x; i < count * per; i += blockDim.x) {
      const int r = i / per, c = i % per * 4;
      const bool in = r0 + r < n && c < dh;
      cp_async16_zfill(s + (size_t)r * ld + c,
                       in ? g + (size_t)(r0 + r) * dh + c : g, in ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < count * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp;
    s[(size_t)r * ld + c] =
        r0 + r < n && c < dh ? g[(size_t)(r0 + r) * dh + c] : 0.f;
  }
}

// grid: (B * H) x query tiles of kTfRows x walks of kTfOut output
// columns; q, k, v, o are (B * H, n, dh) contiguous fp32. DP: the head
// width fixed at compile time (64, the flagship's and the SimpleViT's), or
// 0 for any width.
template <int DP>
__global__ void __launch_bounds__(kTfThreads)
    attention_tf32_kernel(const __grid_constant__ AttnArgs a, int tiles,
                          int walks, int kt) {
  static_assert(DP % 8 == 0, "a fixed head width is a multiple of 8");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, dh = DP ? DP : a.dh, dp = DP ? DP : round8(dh);
  const int ldq = ld_pairs(dp), ldv = ld_cols(dp);
  const Tf32Smem L(dh, kt);
  const float* qs = (const float*)(smem_raw + L.q);
  // a fixed width of at most kTfOut columns is one walk at column 0, known
  // at compile time (read from the grid, it cost K8 a fifth of its time)
  constexpr bool kOneWalk = DP != 0 && DP <= kTfOut;
  const int dc = kOneWalk ? 0 : blockIdx.x % walks * kTfOut;
  const int item = kOneWalk ? blockIdx.x : blockIdx.x / walks;
  const size_t head = (size_t)(item / tiles) * n * dh;
  const int r0 = item % tiles * kTfRows;
  const float* k = (const float*)a.k + head;
  const float* v = (const float*)a.v + head;
  float* out = (float*)a.o + head;
  const bool vec = a.vec16 != 0;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = threadIdx.x / 32 * 16;
  const int chunks = (n + kt - 1) / kt;
  const float scale = a.scale * 1.4426950408889634f;  // base-2 units
  const float ninf = __int_as_float(0xff800000);
  constexpr int KT = kTfKeys / 8, OT = kTfOut / 8;  // n8 tiles
  auto fetch = [&](int c, int st) {
    unsigned char* base = smem_raw + st * L.stage;
    tile_rows((float*)(base + L.k), ldq, k, c * kt, kt, n, dh, dp, vec);
    tile_rows((float*)(base + L.v), ldv, v, c * kt, kt, n, dh, dp, vec);
  };
  tile_rows((float*)(smem_raw + L.q), ldq, (const float*)a.q + head, r0,
            kTfRows, n, dh, dp, vec);
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mx0 = ninf, mx1 = ninf, sum0 = 0.f, sum1 = 0.f;
  fetch(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      fetch(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile c (and q's) landed
    const unsigned char* base = smem_raw + (c & 1) * L.stage;
    const float* ks = (const float*)(base + L.k);
    const float* vs = (const float*)(base + L.v);
    const int key0 = c * kt, live = min(kt, n - key0);
    // s = q k^T, 16 rows x kt keys a warp: the hi x hi products and the
    // two small ones in accumulators of their own
    float s[KT][4], sl[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll 8
    for (int k0 = 0; k0 < dp; k0 += 8) {
      const float2 qa = *reinterpret_cast<const float2*>(
          qs + (size_t)(m0 + g) * ldq + k0 + 2 * t);
      const float2 qb = *reinterpret_cast<const float2*>(
          qs + (size_t)(m0 + g + 8) * ldq + k0 + 2 * t);
      tf32::A af;
      tf32::frag(af, qa.x, qb.x, qa.y, qb.y);
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (8 * j < live) {
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (size_t)(8 * j + g) * ldq + k0 + 2 * t);
          tf32::mma3(s[j], sl[j], af, kv.x, kv.y);
        }
    }
    // the streaming softmax: the new row max, the rescale, p
    float cm0 = mx0, cm1 = mx1;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 8 * j + 2 * t + (e & 1) < live
                      ? (s[j][e] + sl[j][e]) * scale
                      : ninf;
        if (e < 2)
          cm0 = fmaxf(cm0, s[j][e]);
        else
          cm1 = fmaxf(cm1, s[j][e]);
      }
    cm0 = quad_max(cm0);
    cm1 = quad_max(cm1);
    const float a0 = exp2f(mx0 - cm0), a1 = exp2f(mx1 - cm1);
    mx0 = cm0;
    mx1 = cm1;
    // this tile's p v from zero, its hi x hi products and small ones
    // apart, added to o rescaled
    float pv[OT][4], pl[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = pl[j][e] = 0.f;
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (8 * kk >= live) continue;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[kk][e] - (e < 2 ? mx0 : mx1));
        if (e < 2)
          ts0 += p[e];
        else
          ts1 += p[e];
      }
      tf32::A pa;
      tf32::frag(pa, p);
      const float* v0 = vs + (size_t)(8 * kk + 2 * t) * ldv + dc + g;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        if (dc + 8 * j < dp)
          tf32::mma3(pv[j], pl[j], pa, v0[8 * j], v0[ldv + 8 * j]);
    }
    sum0 = sum0 * a0 + ts0;
    sum1 = sum1 * a1 + ts1;
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = o[j][e] * (e < 2 ? a0 : a1) + (pv[j][e] + pl[j][e]);
    __syncthreads();  // every warp is done with tile c's stage
  }
  sum0 = quad_sum(sum0);
  sum1 = quad_sum(sum1);
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + m0 + g + 8 * h, col = dc + 8 * j + 2 * t;
      if (r >= n || col >= dh) continue;
      const float sum = h ? sum1 : sum0;
      const float o0 = o[j][2 * h] / sum, o1 = o[j][2 * h + 1] / sum;
      float* dst = out + (size_t)r * dh + col;
      if (dh % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        dst[0] = o0;
        if (col + 1 < dh) dst[1] = o1;
      }
    }
}

// the fp32 K8: key tiles of kTfKeys, halved until two stages fit
template <int DP>
int launch_attention_tf32(const AttnArgs& a, int bh, cudaStream_t stream) {
  size_t limit;
  const int err = smem_opt_in(attention_tf32_kernel<DP>, &limit);
  if (err != cudaSuccess) return err;
  int kt = kTfKeys;
  while (kt > 8 && Tf32Smem(a.dh, kt).total > limit) kt /= 2;
  const size_t bytes = Tf32Smem(a.dh, kt).total;
  if (bytes > limit) return cudaErrorInvalidValue;
  const int tiles = (a.n + kTfRows - 1) / kTfRows,
            walks = (round8(a.dh) + kTfOut - 1) / kTfOut;
  attention_tf32_kernel<DP><<<(unsigned)((long)bh * tiles * walks),
                              kTfThreads, bytes, stream>>>(a, tiles, walks,
                                                           kt);
  return cudaGetLastError();
}

// ---- K8, bf16, on the tensor cores ----------------------------------------

constexpr int kKeyTiles = 10;  // n8 key tiles held in registers: 80 keys
constexpr int kOutTiles = 8;   // n8 output tiles of one P.V walk: 64 columns

// bf16 elements of one stage of attention_mma_kernel: k and v of a head
// (every row), q of `rows` query rows, row stride round16(dh) + 8.
__host__ __device__ inline size_t attn_stage(int n, int dh, int rows) {
  return (size_t)(2 * round16(n) + rows) * (round16(dh) + 8);
}

// The scores of one warp's 16 query rows (q tile rows m0..) against key
// tile c (keys 80 c ..): s = (q k^T) * scale, keys >= n at -inf. DP: the
// padded head width if fixed at compile time, else 0 (dp, ld at run time).
template <int DP>
__device__ __forceinline__ void attn_scores(float (&s)[kKeyTiles][4],
                                            const bf16* qs, const bf16* ks,
                                            int ld, int m0, int c, int n,
                                            int np, int dp, float scale) {
  if (DP) dp = DP, ld = DP + 8;
  const int key0 = c * 8 * kKeyTiles, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[4];
    load_a(a, qs, ld, m0, k0);
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2)
      if (key0 + 8 * j < np) {
        uint32_t b[4];
        load_b_nk(b, ks, ld, key0 + 8 * j, k0);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
  }
  const float ninf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = key0 + 8 * j + 2 * t + (e & 1) < n ? s[j][e] * scale : ninf;
}

// The pair (p0, p1) split into bf16 hi and lo halves, packed for an A
// fragment: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// o += p . V for one warp: p holds 16 query rows x 16 keys (k0..) as two
// n8 accumulator tiles, V its rows k0.. and the output columns dc..;
// p goes in as bf16 hi + lo halves.
__device__ __forceinline__ void pv_slice(float (&o)[kOutTiles][4],
                                         const float (&p)[2][4],
                                         const bf16* vs, int ld, int dc,
                                         int dp, int k0) {
  uint32_t hi[4], lo[4];
  split_pair(p[0][0], p[0][1], hi[0], lo[0]);
  split_pair(p[0][2], p[0][3], hi[1], lo[1]);
  split_pair(p[1][0], p[1][1], hi[2], lo[2]);
  split_pair(p[1][2], p[1][3], hi[3], lo[3]);
#pragma unroll
  for (int j = 0; j < kOutTiles; j += 2)
    if (dc + 8 * j < dp) {
      uint32_t b[4];
      load_b_kn(b, vs, ld, dc + 8 * j, k0);
      mma_bf16(o[j], hi, b[0], b[1]);
      mma_bf16(o[j], lo, b[0], b[1]);
      mma_bf16(o[j + 1], hi, b[2], b[3]);
      mma_bf16(o[j + 1], lo, b[2], b[3]);
    }
}

// One warp's output tile times f0 (row g) and f1 (row g + 8) to out (row
// stride dh), rows m0.. below nq and columns dc.. below dh, bf16.
__device__ __forceinline__ void store_out(const float (&o)[kOutTiles][4],
                                          float f0, float f1, bf16* out,
                                          int m0, int nq, int dh, int dc) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h, col = dc + 8 * j + 2 * t;
      if (r >= nq || col >= dh) continue;
      const float v0 = o[j][2 * h] * (h ? f1 : f0);
      const float v1 = o[j][2 * h + 1] * (h ? f1 : f0);
      bf16* dst = out + (size_t)r * dh + col;
      if (dh % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        if (col + 1 < dh) dst[1] = __float2bfloat16(v1);
      }
    }
}

// One warp's 16 query rows m0.. (nq valid) of the head in (qs, ks, vs):
// o = softmax(q k^T scale) v, written to out (row stride dh). DP as in
// attn_scores.
template <int DP>
__device__ __forceinline__ void attn_rows_mma(const bf16* qs, const bf16* ks,
                                              const bf16* vs, int ld, int m0,
                                              int nq, int n, int dh,
                                              float scale, bf16* out) {
  const int np = round16(n), dp = DP ? DP : round16(dh);
  if (DP) ld = DP + 8, dh = DP;
  const int chunks = (np + 8 * kKeyTiles - 1) / (8 * kKeyTiles);
  // scores in base-2 units: exp(s - max) = exp2(s log2(e) - max log2(e))
  scale *= 1.4426950408889634f;
  const float ninf = __int_as_float(0xff800000);
  float s[kKeyTiles][4], o[kOutTiles][4], p[2][4];
  if (chunks == 1) {
    // one key tile: the row max, the exps (kept) and their sum, then
    // p = exp(s - max) times the reciprocal of the sum, 64 columns a walk
    attn_scores<DP>(s, qs, ks, ld, m0, 0, n, np, dp, scale);
    float mx0 = ninf, mx1 = ninf, sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(s[j][i] - (i < 2 ? mx0 : mx1));
        (i < 2 ? sum0 : sum1) += s[j][i];
      }
    const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
    for (int dc = 0; dc < dp; dc += 8 * kOutTiles) {
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        if (16 * kk >= np) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[h][e] = s[2 * kk + h][e] * (e < 2 ? inv0 : inv1);
        pv_slice(o, p, vs, ld, dc, dp, 16 * kk);
      }
      store_out(o, 1.f, 1.f, out, m0, nq, dh, dc);
    }
    return;
  }
  // a longer head, 64 output columns a walk over its key tiles: the
  // streaming softmax in fp32. Per tile the row max grows to m, the sum
  // and o so far are rescaled by exp(old m - m), p = exp(s - m) joins the
  // sum and o; at the end o is divided by the sum.
  for (int dc = 0; dc < dp; dc += 8 * kOutTiles) {
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float mx0 = ninf, mx1 = ninf, sum0 = 0.f, sum1 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      attn_scores<DP>(s, qs, ks, ld, m0, c, n, np, dp, scale);
      float cm0 = mx0, cm1 = mx1;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        cm0 = fmaxf(cm0, fmaxf(s[j][0], s[j][1]));
        cm1 = fmaxf(cm1, fmaxf(s[j][2], s[j][3]));
      }
      cm0 = quad_max(cm0);
      cm1 = quad_max(cm1);
      const float a0 = exp2f(mx0 - cm0), a1 = exp2f(mx1 - cm1);
      mx0 = cm0;
      mx1 = cm1;
      sum0 *= a0;
      sum1 *= a1;
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      const int key0 = c * 8 * kKeyTiles;
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        if (key0 + 16 * kk >= np) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[h][e] = exp2f(s[2 * kk + h][e] - (e < 2 ? mx0 : mx1));
            (e < 2 ? sum0 : sum1) += p[h][e];
          }
        pv_slice(o, p, vs, ld, dc, dp, key0 + 16 * kk);
      }
    }
    store_out(o, 1.f / quad_sum(sum0), 1.f / quad_sum(sum1), out, m0, nq,
              dh, dc);
  }
}

// A persistent grid: each thread block walks work items (frame-head,
// query tile) with a stride of the grid; with two stages in shared memory
// the next item's q, k, v arrive (cp.async) while the warps work on this
// one. One warp per 16 query rows of the tile; q, k, v, o are
// (B * H, n, dh) contiguous bf16. DH: the head width fixed at compile
// time (64, the flagship's: a fifth faster at both main shapes than the
// same code with the width read at run time, on an H100 80GB HBM3 at
// 700 W), or 0 for any width.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    attention_mma_kernel(const __grid_constant__ AttnArgs a, int items,
                         int tiles, int stages) {
  static_assert(DH % 16 == 0, "a fixed head width is a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, dh = DH ? DH : a.dh, np = round16(n),
            ld = round16(dh) + 8, rows = a.qrows;
  const size_t stage = attn_stage(n, dh, rows);
  bf16* base = (bf16*)smem_raw;
  // zeros once: padded key rows and columns past dh are never copied in
  for (size_t i = threadIdx.x; i < stages * stage / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const bool vec = a.vec16 != 0;
  auto copy_rows = [&](bf16* s, const bf16* g, int count) {
    if (vec)
      stage_rows(s, ld, g, dh, count, dh);
    else
      for (int i = threadIdx.x; i < count * dh; i += blockDim.x)
        s[(size_t)(i / dh) * ld + i % dh] = g[i];
  };
  auto fetch = [&](int item, int st) {
    bf16* ks = base + st * stage;
    const size_t head = (size_t)(item / tiles) * n * dh;
    const int r0 = item % tiles * rows;
    copy_rows(ks, (const bf16*)a.k + head, n);
    copy_rows(ks + (size_t)np * ld, (const bf16*)a.v + head, n);
    copy_rows(ks + (size_t)2 * np * ld, (const bf16*)a.q + head +
              (size_t)r0 * dh, min(rows, n - r0));
  };
  const int m0 = threadIdx.x / 32 * 16;
  int st = 0;
  if (stages == 2 && (int)blockIdx.x < items) fetch(blockIdx.x, 0);
  cp_async_commit();
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (stages == 1)
      fetch(item, 0);
    else if (item + (int)gridDim.x < items)
      fetch(item + gridDim.x, st ^ 1);
    cp_async_commit();
    if (stages == 1)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();
    const size_t head = (size_t)(item / tiles) * n * dh;
    const int r0 = item % tiles * rows, nq = min(rows, n - r0);
    const bf16* ks = base + st * stage;
    const bf16* qs = ks + (size_t)2 * np * ld;
    const bf16* vs = ks + (size_t)np * ld;
    bf16* out = (bf16*)a.o + head + (size_t)r0 * dh;
    if (m0 < nq)
      attn_rows_mma<DH>(qs, ks, vs, ld, m0, nq, n, dh, a.scale, out);
    __syncthreads();
    st ^= stages - 1;
  }
}

template <int DH>
int launch_attention_mma(AttnArgs& a, int bh, cudaStream_t stream) {
  // Host queries cached per thread: at the flagship shape the kernel runs
  // ~0.02 ms (an H100 80GB HBM3 at 700 W) and a launch's host path is
  // what a caller waits on. Per
  // device the shared-memory limit, the SM count, and the kernel's
  // dynamic shared-memory cap raised to the limit once (the same value
  // from every thread); per launch shape the blocks that fit an SM.
  struct Cache {
    int dev = -1, sms = 0, threads = 0, per_sm = 0;
    size_t limit = 0, bytes = 0;
  };
  static thread_local Cache c;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (c.dev != dev) {
    const int err = smem_opt_in(attention_mma_kernel<DH>, &c.limit);
    if (err != cudaSuccess) return err;
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    c.dev = dev;
    c.threads = 0;
  }
  // at most 8 warps of 16 query rows a tile, the rows spread evenly
  const int mt = round16(a.n) / 16;
  const int fewest = (mt + kWarps - 1) / kWarps;
  const int per_tile = (mt + fewest - 1) / fewest;
  const int tiles = (mt + per_tile - 1) / per_tile;
  a.qrows = 16 * per_tile;
  // two stages where two thread blocks of two stages fit an SM, else one
  // (a long head: more warps resident matter more than the overlap)
  const size_t stage = sizeof(bf16) * attn_stage(a.n, a.dh, a.qrows);
  const int stages = 4 * stage <= c.limit ? 2 : 1;
  const size_t bytes = stages * stage;
  if (bytes > c.limit) return cudaErrorInvalidValue;
  const int threads = 32 * per_tile;
  if (c.threads != threads || c.bytes != bytes) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.per_sm, attention_mma_kernel<DH>, threads, bytes);
    if (e != cudaSuccess) return e;
    c.threads = threads;
    c.bytes = bytes;
  }
  const long items = (long)bh * tiles;
  const long resident = (long)c.sms * (c.per_sm > 0 ? c.per_sm : 1);
  attention_mma_kernel<DH><<<(unsigned)(items < resident ? items : resident),
                             threads, bytes, stream>>>(a, (int)items, tiles,
                                                       stages);
  return cudaGetLastError();
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
  const int err = smem_opt_in(attn_section_kernel<T>, &limit);
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

// ---- K7, bf16, on the tensor cores -----------------------------------------
//
// At d = dim_head = 64 and n <= 80 the bf16 K7 is the attention half of
// block_mma_fwd.cuh's body without the norm and the residual, on the same
// parts: two frames a thread block, one warp a 16-row tile of a frame (65
// rows: 10 warps). A warp's rows of x go straight into A fragments (x is
// bf16 already). Head by head, the head's q|k|v columns of wqkv and its
// rows of wout arrive by cp.async into one of two stages (the next head's
// while this one runs); the warp projects its q into fragments and its k
// and v into the frame's tiles (project), attends (attend_head: scores,
// exact softmax, p rounded to bf16, P.V, o rounded to bf16), and adds o @
// the head's wout rows, summed from a zero accumulator, into its fp32
// output rows. The bias is added last and the output rounded once, the
// TPU kernel's rounding points. Every product is a bf16 mma.sync into
// fp32: it differs from the FMA kernel only in the order of its sums.
// K7 keeps this head loop as its own copy rather than sharing one with
// block_fwd: nvcc's code for K1, K4 and K2f is sensitive to how their
// bodies are factored.

struct SectionMmaSmem {
  size_t k, v, wqkv, wout, total;
  __host__ __device__ explicit SectionMmaSmem(int n) {
    using namespace mmafwd;
    const size_t tile = sizeof(bf16) * kFrames * round16(n) * kLd;
    size_t o = 0;
    k = take(o, tile);  // every frame's k of one head
    v = take(o, tile);
    wqkv = take(o, 2 * sizeof(bf16) * D * kLdQkv);  // two heads' slices
    wout = take(o, 2 * sizeof(bf16) * D * kLd);
    total = o;
  }
};

// head hd's q|k|v columns of wqkv and its rows of wout into stage hd % 2
__device__ __forceinline__ void stage_section_head(unsigned char* smem,
                                                   const SectionMmaSmem& L,
                                                   const bf16* wqkv,
                                                   const bf16* wout,
                                                   int heads, int hd) {
  using namespace mmafwd;
  const int inner = heads * D;
  bf16* wq = (bf16*)(smem + L.wqkv) + (hd & 1) * D * kLdQkv;
  for (int part = 0; part < 3; ++part)
    stage_rows(wq + part * D, kLdQkv, wqkv + part * inner + hd * D,
               3 * inner, D, D);
  stage_rows((bf16*)(smem + L.wout) + (hd & 1) * D * kLd, kLd,
             wout + (size_t)hd * D * D, D, D, D);
}

__global__ void __launch_bounds__(mmafwd::kMaxThreads, 1)
    attn_section_mma_kernel(const __grid_constant__ SectionArgs a,
                            int batch) {
  using namespace mmafwd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  const SectionMmaSmem L(n);
  const Place p(n, batch);
  const size_t frame = (size_t)p.f * n * D;
  const bf16* wqkv = (const bf16*)a.wqkv;
  const bf16* wout = (const bf16*)a.wout;
  const bf16* bout = (const bf16*)a.bout;
  bf16* ks = (bf16*)(smem_raw + L.k) + (size_t)p.fl * p.np * kLd;
  bf16* vs = (bf16*)(smem_raw + L.v) + (size_t)p.fl * p.np * kLd;
  stage_section_head(smem_raw, L, wqkv, wout, a.heads, 0);
  cp_async_commit();
  Frag xa;
  {
    Rows x;
    read_rows(x, (const bf16*)a.x + frame, p, n);
    to_frag(x, xa);  // exact: x is bf16
  }
  float y[8][4];
  zero(y);
  for (int hd = 0; hd < a.heads; ++hd) {
    cp_async_wait<0>();
    __syncthreads();  // head hd's weights landed; the last head's k, v read
    if (hd + 1 < a.heads) {
      stage_section_head(smem_raw, L, wqkv, wout, a.heads, hd + 1);
      cp_async_commit();
    }
    const bf16* wq = (const bf16*)(smem_raw + L.wqkv) + (hd & 1) * D * kLdQkv;
    const bf16* wo = (const bf16*)(smem_raw + L.wout) + (hd & 1) * D * kLd;
    Frag q, o;
    project<false>(xa, wq, ks, vs, nullptr, p.r0, true, q);
    __syncthreads();  // the frame's k and v of this head are in place
    attend_head(q, ks, vs, n, p.np, a.scale, o);
    float acc[8][4];
    zero(acc);
    frag_mma<8>(acc, o, wo, kLd, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += acc[j][e];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] += tof(bout[col_of(j, e)]);
  write_rows(y, (bf16*)a.y + frame, p, n);
}

}  // namespace

extern "C" {

// K8. dtype: 0 = fp32 (attention_tf32_kernel), 1 = bf16
// (attention_mma_kernel). q, k, v, o: (bh, n, dh) contiguous. Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue when a key tile of 8
// rows does not fit a block's shared memory (fp32) or K and V of one head
// do not (bf16).
int attention_launch(int dtype, const void* q, const void* k, const void* v,
                     void* o, int bh, int n, int dh, float scale,
                     void* stream) {
  if (bh < 1 || n < 1 || dh < 1) return cudaErrorInvalidValue;
  const bool aligned =
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  AttnArgs a = {q, k, v, o, n, dh, 0, scale,
                aligned && dh % (dtype == 1 ? 8 : 4) == 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1)
    return dh == 64 ? launch_attention_tf32<64>(a, bh, s)
                    : launch_attention_tf32<0>(a, bh, s);
  return dh == 64 ? launch_attention_mma<64>(a, bh, s)
                  : launch_attention_mma<0>(a, bh, s);
}

// The fp32 K8's first design, attention_kernel (FMA loops, K and V of the
// whole head in shared memory), on the same arguments as attention_launch
// with fp32 tensors. No route calls it: it is kept to be timed beside the
// kernel that replaced it.
int attention_fma_launch(const void* q, const void* k, const void* v,
                         void* o, int bh, int n, int dh, float scale,
                         void* stream) {
  if (bh < 1 || n < 1 || dh < 1) return cudaErrorInvalidValue;
  AttnArgs a = {q, k, v, o, n, dh, 0, scale, 0};
  return launch_attention_fma(a, bh, (cudaStream_t)stream);
}

// Bytes of dynamic shared memory of K7 for a tile of qrows query rows of
// n-row frames; the launch takes the fewest tiles whose bytes fit, so it
// runs wherever qrows = 1 fits. mma = 1: the tensor-core form (every row
// of two frames; qrows is not read).
size_t attention_section_smem(int dtype, int n, int d, int dim_head,
                              int qrows, int mma) {
  if (mma) return SectionMmaSmem(n).total;
  return dtype == 1 ? SectionSmem<__nv_bfloat16>(n, d, dim_head, qrows).total
                    : SectionSmem<float>(n, d, dim_head, qrows).total;
}

// K7. x, y: (batch, n, d); wqkv (d, 3 heads dh); wout (heads dh, d);
// bout (d); all in the compute dtype. mma = 1 runs the bf16 tensor-core
// form (attn_section_mma_kernel), which takes bf16, d = dim_head = 64,
// n <= 80 and 16-byte aligned x, wqkv, wout and y (cudaErrorInvalidValue
// else); mma = 0 the FMA kernel, any width.
int attention_section_launch(int dtype, const void* x, const void* wqkv,
                             const void* wout, const void* bout, void* y,
                             int batch, int n, int d, int heads, int dh,
                             float scale, void* stream, int mma) {
  if (batch < 1 || n < 1 || d < 1 || heads < 1 || dh < 1)
    return cudaErrorInvalidValue;
  SectionArgs a = {x, wqkv, wout, bout, y, n, d, heads, dh, 0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (mma) {
    const bool aligned =
        ((uintptr_t)x | (uintptr_t)wqkv | (uintptr_t)wout | (uintptr_t)y) %
            16 == 0;
    if (dtype != 1 || d != mmafwd::D || dh != mmafwd::D ||
        n > mmafwd::kMaxRows || !aligned)
      return cudaErrorInvalidValue;
    return mmafwd::launch_fwd(attn_section_mma_kernel, n, batch,
                              SectionMmaSmem(n).total, s, a, batch);
  }
  return dtype == 1 ? launch_section<__nv_bfloat16>(a, batch, s)
                    : launch_section<float>(a, batch, s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
