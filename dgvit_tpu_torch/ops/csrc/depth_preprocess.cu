// Fused depth ingest for the 512x640 camera: raw float depth frames ->
// (128, 160) policy states. Replaces the Pallas TPU kernel
// dgvit_tpu/ops/pallas_preprocess.py::preprocess_depth_pallas (`_kernel`,
// `_add_noise`, `_fold_matrices`).
//
// Per frame: min-max normalise to 0..255 with the u8 truncation kept as
// floor(), Irwin-Hall(12) noise sigma*z from a counter-based generator
// keyed by seed + frame, clip to [0, 255], 5x5 Gaussian blur
// (REFLECT_101 at the image edges), 11x11 Gaussian blur of the centre
// band (rows 205..306, extracted first: REFLECT_101 at the band's own
// top and bottom, at the image's left and right), 4x bilinear downscale
// (the average of source rows/cols 4i+1, 4i+2), /255.
//
// What bounds the function on an H100: bytes, then the noise. A frame is
// 1.31 MB in and 82 KB out; of the operations, the generator's integer
// hashes (four 32-bit mixes a pixel, about 35 integer instructions, at the
// SM's 64 lanes a clock) weigh most, the blurs little once they run only
// where a state reads them.
//
// Design: one launch, one thread-block cluster of RANKS = 16 CTAs per
// frame (a non-portable cluster size; an H100 80GB HBM3 holds 14 such
// clusters at once), two CTAs an SM, the frame in the cluster's
// distributed shared memory, so it is read from device memory exactly
// once and no intermediate reaches it:
//  1. each CTA copies its slice of ROWS rows (80 KB) into shared memory
//     with bulk asynchronous copies (cp.async.bulk), CHUNKS of them, each
//     completing on its own mbarrier, and reduces its min and max over
//     each chunk as it lands;
//  2. the CTAs' min and max are combined through distributed shared
//     memory (cluster.sync, then map_shared_rank): no partials go through
//     device memory;
//  3. normalise and add noise in place, then cluster.sync: every slice
//     is final and readable from the other CTAs;
//  4. every read of another CTA's slice at once, all loads in flight (a
//     remote load's round trip is long): the rows above and below the
//     slice (the halo, REFLECT_101 at the image's edges) and the noisy
//     band rows under this CTA's W_OUT / RANKS band columns; then
//     cluster.sync, after which no CTA reads another's shared memory;
//  5. outside the band, each state reads only the 5x5 blur at two rows
//     and two columns: a warp takes 32 states of one output row, a lane
//     loads the six rows under its state as float4s (columns 4j..4j+3,
//     the two neighbouring columns from its neighbour lanes);
//  6. in the band, where the 11-tap passes read the 5x5 blur everywhere,
//     on tiles laid over the slice (now free): the 5-tap pass down the
//     gathered rows, the 5-tap pass along them, the 11-tap pass down the
//     sampled rows (a thread a column and a block of rows, so that its
//     sums are independent), then the 11-tap pass at the sampled columns
//     and the average.
// Every state is computed once; the blur values under it are the same
// sums as the plain version's, whichever CTA computes them. The noise
// takes the most of a CTA's time, then the gathers; clusters of 8 CTAs
// (the portable size, one CTA an SM) were slower.
//
// Arithmetic is fp32 with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA) and taken in the
// order of the plain PyTorch chain (ops/preprocess.py), so the kernel
// agrees with its plain version to the last bit. The generator is the
// one of ops/fused_preprocess.py::irwin_hall_noise, bit for bit.
//
// Plain C interface for ctypes; the launch goes to the given stream and
// neither synchronises nor allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int H_IN = 512, W_IN = 640, H_OUT = 128, W_OUT = 160;
constexpr int BAND_Y1 = 205, BAND_Y2 = 307;        // centre band rows [Y1, Y2)
constexpr int BAND_OUT0 = 51, BAND_OUT1 = 76;      // output rows it covers
constexpr int RANKS = 16;                // CTAs a frame's cluster
constexpr int ROWS = H_IN / RANKS;       // source rows a CTA holds
constexpr int OUT_ROWS = H_OUT / RANKS;  // output rows under them
constexpr int THREADS = 384;             // 24 warps an SM (two CTAs)
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_ROWS = 8;            // rows a bulk copy (and barrier)
constexpr int CHUNKS = ROWS / CHUNK_ROWS;
constexpr int CHUNK_FLOATS = CHUNK_ROWS * W_IN;
constexpr int SLICE = ROWS * W_IN;       // floats
// the band: SJ output columns a CTA
constexpr int SJ = W_OUT / RANKS;
constexpr int BAND_ROWS = BAND_Y2 - BAND_Y1;
constexpr int BAND_SAMPLED = 2 * (BAND_OUT1 - BAND_OUT0 + 1);
constexpr int B5_COLS = 4 * SJ + 8;      // the 11-tap pass's reach
constexpr int V5_COLS = B5_COLS + 4;     // and the 5-tap pass's under it
// the noisy rows under the band's 5-tap pass, gathered from the CTAs that
// hold them: columns from a multiple of 4 on, as float4s
constexpr int STAGE_ROWS = BAND_ROWS + 4, STAGE_COLS = V5_COLS + 8;
constexpr int STAGE = STAGE_ROWS * STAGE_COLS, HALO = 2 * W_IN;
// the band's passes, over the slice once the states outside the band
// are done
constexpr int TILES = BAND_ROWS * V5_COLS + BAND_ROWS * B5_COLS
                      + BAND_SAMPLED * B5_COLS;
// shared memory: the slice, the gathered band rows, the halo rows, the
// barriers, the CTA's min and max, the warps' partial min and max, the
// frame's lo and scale
constexpr size_t SMEM = (size_t)(SLICE + STAGE + HALO) * sizeof(float)
                        + CHUNKS * sizeof(uint64_t)
                        + (2 + 2 * WARPS + 2) * sizeof(float);

static_assert(H_IN % RANKS == 0 && ROWS % CHUNK_ROWS == 0, "slices");
static_assert(W_OUT % RANKS == 0 && W_OUT % 32 == 0, "columns");
static_assert(TILES <= SLICE, "the band's tiles over the slice");
static_assert((SLICE + STAGE + HALO) % 4 == 0, "alignment");

struct Taps {
  float k5[5];
  float k11[11];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int reflect(int q, int n) {
  q = q < 0 ? -q : q;
  return q >= n ? 2 * (n - 1) - q : q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// row q (0 <= q < H_IN) of the frame in the slice of the CTA that holds
// it, through distributed shared memory
__device__ __forceinline__ const float* cluster_row(cg::cluster_group& cluster,
                                                    float* slice, int q) {
  const int owner = q / ROWS;
  return cluster.map_shared_rank(slice, owner) + (q - owner * ROWS) * W_IN;
}

// dst[i] = src(i) for i < count, every thread's loads issued before any
// of its stores (a remote load's round trip is long, and a store between
// two loads through generic pointers would order them): float4 i of the
// copy is thread tid + k THREADS's k-th
template <int kMax, typename Src>
__device__ __forceinline__ void gather4(float4* dst, int count, Src src) {
  float4 v[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < count) v[k] = src(i);
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < count) dst[i] = v[k];
  }
}

// the 2x2 average of cv2's bilinear 4x downscale, /255
__device__ __forceinline__ float state(const float (&px)[2][2]) {
  const float left = __fadd_rn(
      px[0][0], __fmul_rn(__fsub_rn(px[1][0], px[0][0]), 0.5f));
  const float right = __fadd_rn(
      px[0][1], __fmul_rn(__fsub_rn(px[1][1], px[0][1]), 0.5f));
  const float v = __fadd_rn(left, __fmul_rn(__fsub_rn(right, left), 0.5f));
  return __fdiv_rn(v, 255.0f);
}

__global__ void __launch_bounds__(THREADS, 2)  // two CTAs an SM
    preprocess_cluster_kernel(const float* __restrict__ raw,
                              float* __restrict__ out, uint32_t seed,
                              float sigma, Taps taps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.x / RANKS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* slice = (float*)smem_raw;                  // [ROWS][W_IN]
  float* stage = slice + SLICE;               // [STAGE_ROWS][STAGE_COLS]
  float* halo = stage + STAGE;                      // [2][W_IN]
  uint64_t* bars = (uint64_t*)(halo + HALO);
  float* mm = (float*)(bars + CHUNKS);              // this CTA's min, max
  float* red = mm + 2;                              // [2][WARPS]
  float* stat = red + 2 * WARPS;                    // the frame's lo, scale

  // 1. the slice into shared memory, its min and max chunk by chunk
  const float* src = raw + (size_t)f * H_IN * W_IN + (size_t)rank * SLICE;
  if (tid == 0) {
    for (int c = 0; c < CHUNKS; ++c) mbar_init(&bars[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_expect_tx(&bars[c], CHUNK_FLOATS * sizeof(float));
      bulk_copy(slice + c * CHUNK_FLOATS, src + c * CHUNK_FLOATS,
                CHUNK_FLOATS * sizeof(float), &bars[c]);
    }
  float lo = INFINITY, hi = -INFINITY;
  for (int c = 0; c < CHUNKS; ++c) {
    mbar_wait(&bars[c], 0);
    const float4* p = (const float4*)(slice + c * CHUNK_FLOATS);
    for (int i = tid; i < CHUNK_FLOATS / 4; i += THREADS) {
      const float4 v = p[i];
      lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
      hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffU, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffU, hi, o));
  }
  if (lane == 0) {
    red[warp] = lo;
    red[WARPS + warp] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = fminf(lo, red[w]);
      hi = fmaxf(hi, red[WARPS + w]);
    }
    mm[0] = lo;
    mm[1] = hi;
  }

  // 2. the frame's min and max over the cluster's CTAs; the scale, once
  cluster.sync();
  if (warp == 0) {
    lo = INFINITY;
    hi = -INFINITY;
    for (int r = lane; r < RANKS; r += 32) {
      const float* m = cluster.map_shared_rank(mm, r);
      lo = fminf(lo, m[0]);
      hi = fmaxf(hi, m[1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffU, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffU, hi, o));
    }
    if (lane == 0) {
      stat[0] = lo;
      stat[1] = __fdiv_rn(255.0f, fmaxf(__fsub_rn(hi, lo), 1e-20f));
    }
  }
  __syncthreads();
  lo = stat[0];
  const float scale = stat[1];

  // 3. normalise, truncate, add noise, clip: in place, 4 pixels a step
  {
    const uint32_t key = mix32(seed + (uint32_t)f);
    const uint32_t key0 = mix32(key), key1 = mix32(key + 1U),
                   key2 = mix32(key + 2U);
    const float inv_std = (float)(1.0 / 255.9980469);
    const uint32_t p0 = (uint32_t)(rank * SLICE);
    float4* s4 = (float4*)slice;
    for (int i = tid; i < SLICE / 4; i += THREADS) {
      const float4 v = s4[i];
      float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float u = floorf(__fmul_rn(__fsub_rn(e[k], lo), scale));
        u = fminf(fmaxf(u, 0.0f), 255.0f);
        if (sigma > 0.0f) {
          const uint32_t m = mix32(p0 + (uint32_t)(4 * i + k));
          // the 12 bytes of the three words summed (dp4a against ones)
          const uint32_t acc = __dp4a(
              mix32(m ^ key2), 0x01010101U,
              __dp4a(mix32(m ^ key1), 0x01010101U,
                     __dp4a(mix32(m ^ key0), 0x01010101U, 0U)));
          // (float)acc - 1530, exactly: 2^23 + acc as a float, less
          // 2^23 + 1530 (both exact below 2^24)
          const float z = __fmul_rn(
              __fsub_rn(__uint_as_float(0x4B000000U + acc), 8390138.0f),
              inv_std);
          u = fminf(fmaxf(__fadd_rn(u, __fmul_rn(sigma, z)), 0.0f), 255.0f);
        }
        e[k] = u;
      }
      s4[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  cluster.sync();  // every slice final, readable across the cluster

  // 4. every read of another CTA's slice, all loads in flight at once: the
  // rows above and below the slice (REFLECT_101 at the image's top and
  // bottom), and the noisy rows BAND_Y1 - 2 .. BAND_Y2 + 1 under this
  // CTA's band columns, from column cs on
  const int j0 = rank * SJ;
  const int cb0 = max(4 * j0 - 4, 0), cb1 = min(4 * (j0 + SJ) + 3, W_IN - 1);
  const int cv0 = max(cb0 - 2, 0), cv1 = min(cb1 + 2, W_IN - 1);
  const int nb = cb1 - cb0 + 1, nv = cv1 - cv0 + 1;
  const int cs = cv0 & ~3, n4 = (cv1 - cs) / 4 + 1;
  {
    const float4* above = (const float4*)cluster_row(
        cluster, slice, reflect(rank * ROWS - 1, H_IN));
    const float4* below = (const float4*)cluster_row(
        cluster, slice, reflect((rank + 1) * ROWS, H_IN));
    constexpr int kFirst = (BAND_Y1 - 2) / ROWS;  // the CTAs of the band
    constexpr int kOwners = (BAND_Y2 + 1) / ROWS - kFirst + 1;
    const float* owner[kOwners];
#pragma unroll
    for (int o = 0; o < kOwners; ++o)
      owner[o] = cluster.map_shared_rank(slice, kFirst + o) + cs;
    constexpr int kQ = STAGE_COLS / 4, kStage = STAGE_ROWS * kQ;
    // float4 i < kStage: stage row i / kQ; then the halo rows
    gather4<(kStage + HALO / 4 + THREADS - 1) / THREADS>(
        (float4*)stage, kStage + HALO / 4, [=](int i) {
          if (i >= kStage) {
            i -= kStage;
            return i < W_IN / 4 ? above[i] : below[i - W_IN / 4];
          }
          const int y = i / kQ, x = i - y * kQ, q = BAND_Y1 - 2 + y;
          const int o = q / ROWS;
          return x < n4 ? ((const float4*)(owner[o - kFirst]
                                           + (q - o * ROWS) * W_IN))[x]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        });
  }
  cluster.sync();  // no CTA reads another's slice past this point

  float* dst = out + (size_t)f * H_OUT * W_OUT;
  // 5. states outside the band: a warp a task of 32 states of one row
  for (int task = warp; task < OUT_ROWS * (W_OUT / 32); task += WARPS) {
    const int i = rank * OUT_ROWS + task / (W_OUT / 32);
    if (i >= BAND_OUT0 && i <= BAND_OUT1) continue;
    const int j = task % (W_OUT / 32) * 32 + lane;
    // rows 4i-1 .. 4i+4 at columns 4j-1 .. 4j+4 (reflected at the edges)
    float n[6][6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int q = 4 * i - 1 + d - rank * ROWS;  // -1 .. ROWS
      const float* row = q < 0 ? halo : q >= ROWS ? halo + W_IN
                                                  : slice + q * W_IN;
      const float4 v = ((const float4*)row)[j];
      float left = __shfl_up_sync(0xffffffffU, v.w, 1);
      float right = __shfl_down_sync(0xffffffffU, v.x, 1);
      if (lane == 0) left = j == 0 ? v.y : row[4 * j - 1];
      if (lane == 31) right = j == W_OUT - 1 ? v.z : row[4 * j + 4];
      n[d][0] = left;
      n[d][1] = v.x;
      n[d][2] = v.y;
      n[d][3] = v.z;
      n[d][4] = v.w;
      n[d][5] = right;
    }
    float px[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float col[6];  // the 5-tap pass down the rows at row 4i+1+s
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 5; ++t)
          acc = __fadd_rn(acc, __fmul_rn(taps.k5[t], n[s + t][c]));
        col[c] = acc;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // along it at column 4j+1+u
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 5; ++t)
          acc = __fadd_rn(acc, __fmul_rn(taps.k5[t], col[u + t]));
        px[s][u] = acc;
      }
    }
    dst[i * W_OUT + j] = state(px);
  }
  __syncthreads();  // the slice is free for the band's tiles

  // 6. the band, this CTA's SJ output columns. Each pass gives a thread
  // one column of its tile and blocks of kRb rows, so that its sums are
  // independent of one another (a warp's lanes on neighbouring columns).
  float* v5 = slice;                                 // [BAND_ROWS][V5_COLS]
  float* b5 = v5 + BAND_ROWS * V5_COLS;              // [BAND_ROWS][B5_COLS]
  float* v11 = b5 + BAND_ROWS * B5_COLS;             // [BAND_SAMPLED][B5_COLS]
  // the 5-tap pass down the band's rows, the stage's column in registers
  {
    constexpr int kGroups = THREADS / V5_COLS, kRb = 13;
    const int x = tid % V5_COLS;
    if (tid < kGroups * V5_COLS && x < nv)
      for (int y0 = tid / V5_COLS * kRb; y0 < BAND_ROWS;
           y0 += kGroups * kRb) {
        const float* col = stage + (cv0 - cs) + x;
        float w[kRb + 4];
#pragma unroll
        for (int k = 0; k < kRb + 4; ++k)
          w[k] = y0 + k < STAGE_ROWS ? col[(y0 + k) * STAGE_COLS] : 0.0f;
#pragma unroll
        for (int k = 0; k < kRb; ++k) {
          if (y0 + k >= BAND_ROWS) break;
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 5; ++t)
            acc = __fadd_rn(acc, __fmul_rn(taps.k5[t], w[k + t]));
          v5[(y0 + k) * V5_COLS + x] = acc;
        }
      }
  }
  __syncthreads();
  // the 5-tap pass along them (reflected at the image's sides)
  {
    constexpr int kGroups = THREADS / B5_COLS, kRb = 11;
    const int x = tid % B5_COLS;
    if (tid < kGroups * B5_COLS && x < nb) {
      int at[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) at[t] = reflect(cb0 + x + t - 2, W_IN) - cv0;
      for (int y0 = tid / B5_COLS * kRb; y0 < BAND_ROWS;
           y0 += kGroups * kRb)
#pragma unroll
        for (int k = 0; k < kRb; ++k) {
          if (y0 + k >= BAND_ROWS) break;
          const float* row = v5 + (y0 + k) * V5_COLS;
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 5; ++t)
            acc = __fadd_rn(acc, __fmul_rn(taps.k5[t], row[at[t]]));
          b5[(y0 + k) * B5_COLS + x] = acc;
        }
    }
  }
  __syncthreads();
  // the 11-tap pass down the sampled band rows, reflected at the band's
  // own edges
  {
    constexpr int kGroups = THREADS / B5_COLS, kRb = 6;
    const int x = tid % B5_COLS;
    if (tid < kGroups * B5_COLS && x < nb)
      for (int k0 = tid / B5_COLS * kRb; k0 < BAND_SAMPLED;
           k0 += kGroups * kRb)
#pragma unroll
        for (int kk = 0; kk < kRb; ++kk) {
          const int k = k0 + kk;
          if (k >= BAND_SAMPLED) break;
          const int r = 4 * (BAND_OUT0 + (k >> 1)) + 1 + (k & 1);
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 11; ++t) {
            int q = r + t - 5;
            q = q < BAND_Y1 ? 2 * BAND_Y1 - q : q;
            q = q >= BAND_Y2 ? 2 * (BAND_Y2 - 1) - q : q;
            acc = __fadd_rn(acc, __fmul_rn(
                taps.k11[t], b5[(q - BAND_Y1) * B5_COLS + x]));
          }
          v11[k * B5_COLS + x] = acc;
        }
  }
  __syncthreads();
  // the 11-tap pass at the sampled columns, the average, /255
  for (int idx = tid; idx < (BAND_OUT1 - BAND_OUT0 + 1) * SJ;
       idx += THREADS) {
    const int ti = idx / SJ, j = j0 + idx % SJ;
    float px[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* row = v11 + (2 * ti + s) * B5_COLS;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 4 * j + 1 + u;
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 11; ++t)
          acc = __fadd_rn(acc, __fmul_rn(
              taps.k11[t], row[reflect(c + t - 5, W_IN) - cb0]));
        px[s][u] = acc;
      }
    }
    dst[(BAND_OUT0 + ti) * W_OUT + j] = state(px);
  }
}

// the kernel's launch configuration for b frames (cluster dimension in
// attr)
cudaLaunchConfig_t launch_config(int b, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * RANKS, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's shared memory and its cluster size (past the portable 8)
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(preprocess_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

extern "C" {

// raw (b, 512, 640) fp32, 16-byte aligned -> out (b, 128, 160) fp32.
// taps: 16 host floats, the 5-tap then the 11-tap Gaussian. One launch of
// b clusters of RANKS CTAs. Returns the CUDA error of the launch (0 on
// success).
int depth_preprocess_launch(const void* raw, void* out, int b, int seed,
                            float sigma, const float* taps, void* stream) {
  if (b <= 0 || (uintptr_t)raw % 16 != 0) return (int)cudaErrorInvalidValue;
  Taps k;
  for (int i = 0; i < 5; ++i) k.k5[i] = taps[i];
  for (int i = 0; i < 11; ++i) k.k11[i] = taps[5 + i];
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(b, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, preprocess_cluster_kernel,
                           static_cast<const float*>(raw),
                           static_cast<float*>(out), (uint32_t)seed, sigma,
                           k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's shape: the CTAs of a frame's cluster, the bytes of dynamic
// shared memory a CTA asks for, and how many clusters the device holds at
// once (0 when the query fails). Returns the CUDA error of the query.
int depth_preprocess_occupancy(int* ranks, size_t* bytes, int* clusters) {
  *ranks = RANKS;
  *bytes = SMEM;
  *clusters = 0;
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(64, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (void*)preprocess_cluster_kernel, &cfg);
}

const char* depth_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
