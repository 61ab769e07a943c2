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
// What bounds the function on an H100: bytes. A frame is 1.31 MB in and
// 82 KB out against about 13 M operations that the states really need
// (normalisation and noise on every pixel, the blurs only where a state
// reads them), so the card's least time is the one read of the frame. As
// written the kernel does several times those operations: an integer
// hash of four 32-bit mixes a pixel, both 5-tap passes on every pixel of
// a tile, the halo again in each neighbouring tile. The TPU kernel folded the
// linear tail into dense matrix pairs to feed its matrix unit; here the
// tail stays the separable stencil it is, on shared-memory tiles with a
// halo, so no intermediate reaches device memory. Two launches per call:
// a per-frame min/max reduction into partials (normalisation needs both
// before the first pixel is scaled), then the fused pass, one block per
// 8x40 tile of the output. The frame is therefore read twice (the second
// time from L2 while a batch fits there).
//
// Arithmetic is fp32 with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA) and taken in the
// order of the plain PyTorch chain (ops/preprocess.py), so the kernel
// agrees with its plain version to the last bit or nearly. The generator
// is the one of ops/fused_preprocess.py::irwin_hall_noise, bit for bit.
//
// Plain C interface for ctypes; the launch goes to the given stream and
// neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H_IN = 512, W_IN = 640, H_OUT = 128, W_OUT = 160;
constexpr int BAND_Y1 = 205, BAND_Y2 = 307;        // centre band rows [Y1, Y2)
constexpr int BAND_OUT0 = 51, BAND_OUT1 = 76;      // output rows it covers
constexpr int NPART = 40;                          // min/max partials per frame
constexpr int TH = 8, TW = 40;                     // output tile
constexpr int THREADS = 256;
// largest regions of a tile (a band tile: halo 5 for the 11-tap blur, and
// 2 more for the 5-tap blur under it)
constexpr int B5_ROWS = 4 * TH - 2 + 10, B5_COLS = 4 * TW - 2 + 10;
constexpr int V5_COLS = B5_COLS + 4;
constexpr int N_ROWS = B5_ROWS + 4;
constexpr int V11_ROWS = 2 * TH;
constexpr int SMEM_FLOATS = N_ROWS * V5_COLS + B5_ROWS * V5_COLS
                            + B5_ROWS * B5_COLS + V11_ROWS * B5_COLS;

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

__device__ __forceinline__ int byte_sum(uint32_t w) {
  return (int)(w & 255U) + (int)((w >> 8) & 255U) + (int)((w >> 16) & 255U)
         + (int)(w >> 24);
}

__device__ __forceinline__ int reflect(int q, int n) {
  q = q < 0 ? -q : q;
  return q >= n ? 2 * (n - 1) - q : q;
}

__global__ void __launch_bounds__(THREADS)
minmax_kernel(const float* __restrict__ raw, float* __restrict__ partial) {
  const int f = blockIdx.y, p = blockIdx.x;
  constexpr int PER = H_IN * W_IN / NPART;           // 8192 floats
  const float4* src = reinterpret_cast<const float4*>(
      raw + (size_t)f * H_IN * W_IN + (size_t)p * PER);
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < PER / 4; i += THREADS) {
    const float4 v = src[i];
    lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
    hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffU, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffU, hi, o));
  }
  __shared__ float slo[THREADS / 32], shi[THREADS / 32];
  if ((threadIdx.x & 31) == 0) {
    slo[threadIdx.x >> 5] = lo;
    shi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      lo = fminf(lo, slo[w]);
      hi = fmaxf(hi, shi[w]);
    }
    partial[((size_t)f * NPART + p) * 2] = lo;
    partial[((size_t)f * NPART + p) * 2 + 1] = hi;
  }
}

__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const float* __restrict__ raw,
                  const float* __restrict__ partial, float* __restrict__ out,
                  uint32_t seed, float sigma, Taps taps) {
  extern __shared__ float smem[];
  float* noisy = smem;                               // [N_ROWS][V5_COLS]
  float* v5 = noisy + N_ROWS * V5_COLS;              // [B5_ROWS][V5_COLS]
  float* b5 = v5 + B5_ROWS * V5_COLS;                // [B5_ROWS][B5_COLS]
  float* v11 = b5 + B5_ROWS * B5_COLS;               // [V11_ROWS][B5_COLS]
  __shared__ float s_lo, s_scale;

  const int f = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const bool band = i0 <= BAND_OUT1 && i0 + TH - 1 >= BAND_OUT0;
  const int h = band ? 5 : 0;

  // the tile's regions, in image coordinates (inclusive bounds)
  const int rb0 = max(4 * i0 + 1 - h, 0);
  const int rb1 = min(4 * (i0 + TH - 1) + 2 + h, H_IN - 1);
  const int cb0 = max(4 * j0 + 1 - h, 0);
  const int cb1 = min(4 * (j0 + TW - 1) + 2 + h, W_IN - 1);
  const int cv0 = max(cb0 - 2, 0), cv1 = min(cb1 + 2, W_IN - 1);
  const int rn0 = max(rb0 - 2, 0), rn1 = min(rb1 + 2, H_IN - 1);
  const int nb_rows = rb1 - rb0 + 1, nb_cols = cb1 - cb0 + 1;
  const int nv_cols = cv1 - cv0 + 1, nn_rows = rn1 - rn0 + 1;

  // 1. the frame's min and max from the partials; the scale, once
  if (tid < 32) {
    const float* pf = partial + (size_t)f * NPART * 2;
    float lo = INFINITY, hi = -INFINITY;
    for (int p = tid; p < NPART; p += 32) {
      lo = fminf(lo, pf[2 * p]);
      hi = fmaxf(hi, pf[2 * p + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffU, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffU, hi, o));
    }
    if (tid == 0) {
      s_lo = lo;
      s_scale = __fdiv_rn(255.0f, fmaxf(__fsub_rn(hi, lo), 1e-20f));
    }
  }
  __syncthreads();
  const float lo = s_lo, scale = s_scale;

  // 2. normalise, truncate, add noise, clip: the noisy region
  const float* frame = raw + (size_t)f * H_IN * W_IN;
  const uint32_t key = mix32(seed + (uint32_t)f);
  const uint32_t key0 = mix32(key), key1 = mix32(key + 1U),
                 key2 = mix32(key + 2U);
  const float inv_std = (float)(1.0 / 255.9980469);
  // Each warp walks whole rows of a region and its lanes the columns, so
  // a row's reflected neighbours are found once a row, not once a pixel.
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int WARPS = THREADS / 32;
  for (int y = warp; y < nn_rows; y += WARPS) {
    const int r = rn0 + y;
    const float* src = frame + r * W_IN + cv0;
    const uint32_t p0 = (uint32_t)(r * W_IN + cv0);
    for (int x = lane; x < nv_cols; x += 32) {
      float v = floorf(__fmul_rn(__fsub_rn(src[x], lo), scale));
      v = fminf(fmaxf(v, 0.0f), 255.0f);
      if (sigma > 0.0f) {
        const uint32_t m = mix32(p0 + (uint32_t)x);
        const int acc = byte_sum(mix32(m ^ key0)) + byte_sum(mix32(m ^ key1))
                        + byte_sum(mix32(m ^ key2));
        const float z = __fmul_rn(__fsub_rn((float)acc, 1530.0f), inv_std);
        v = fminf(fmaxf(__fadd_rn(v, __fmul_rn(sigma, z)), 0.0f), 255.0f);
      }
      noisy[y * V5_COLS + x] = v;
    }
  }
  __syncthreads();

  // 3. 5-tap blur down the rows (reflect at the image's top and bottom)
  for (int y = warp; y < nb_rows; y += WARPS) {
    const int r = rb0 + y;
    const float* rows[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      rows[t] = noisy + (reflect(r + t - 2, H_IN) - rn0) * V5_COLS;
    for (int x = lane; x < nv_cols; x += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t)
        acc = __fadd_rn(acc, __fmul_rn(taps.k5[t], rows[t][x]));
      v5[y * V5_COLS + x] = acc;
    }
  }
  __syncthreads();

  // 4. 5-tap blur along the columns (reflect at the image's sides)
  for (int y = warp; y < nb_rows; y += WARPS) {
    const float* row = v5 + y * V5_COLS;
    for (int x = lane; x < nb_cols; x += 32) {
      const int c = cb0 + x;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t)
        acc = __fadd_rn(acc, __fmul_rn(
            taps.k5[t], row[reflect(c + t - 2, W_IN) - cv0]));
      b5[y * B5_COLS + x] = acc;
    }
  }
  __syncthreads();

  // 5. band rows the tile samples: 11-tap blur down the rows, reflected
  //    at the band's own edges
  if (band) {
    for (int k = warp; k < V11_ROWS; k += WARPS) {
      const int i = i0 + (k >> 1);
      if (i < BAND_OUT0 || i > BAND_OUT1) continue;
      const int r = 4 * i + 1 + (k & 1);
      const float* rows[11];
#pragma unroll
      for (int t = 0; t < 11; ++t) {
        int q = r + t - 5;
        q = q < BAND_Y1 ? 2 * BAND_Y1 - q : q;
        q = q >= BAND_Y2 ? 2 * (BAND_Y2 - 1) - q : q;
        rows[t] = b5 + (q - rb0) * B5_COLS;
      }
      for (int x = lane; x < nb_cols; x += 32) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 11; ++t)
          acc = __fadd_rn(acc, __fmul_rn(taps.k11[t], rows[t][x]));
        v11[k * B5_COLS + x] = acc;
      }
    }
    __syncthreads();
  }

  // 6. the band's 11-tap blur along the columns at the sampled columns,
  //    the 2x2 average as cv2's bilinear form, /255
  float* dst = out + (size_t)f * H_OUT * W_OUT;
  for (int idx = tid; idx < TH * TW; idx += THREADS) {
    const int ti = idx / TW, tj = idx - ti * TW;
    const int i = i0 + ti, j = j0 + tj;
    const bool in_band = i >= BAND_OUT0 && i <= BAND_OUT1;
    float px[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 4 * j + 1 + u;
        if (in_band) {
          const float* row = v11 + (2 * ti + s) * B5_COLS;
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 11; ++t) {
            const int q = reflect(c + t - 5, W_IN) - cb0;
            acc = __fadd_rn(acc, __fmul_rn(taps.k11[t], row[q]));
          }
          px[s][u] = acc;
        } else {
          px[s][u] = b5[(4 * i + 1 + s - rb0) * B5_COLS + (c - cb0)];
        }
      }
    }
    const float left = __fadd_rn(
        px[0][0], __fmul_rn(__fsub_rn(px[1][0], px[0][0]), 0.5f));
    const float right = __fadd_rn(
        px[0][1], __fmul_rn(__fsub_rn(px[1][1], px[0][1]), 0.5f));
    const float v = __fadd_rn(left, __fmul_rn(__fsub_rn(right, left), 0.5f));
    dst[i * W_OUT + j] = __fdiv_rn(v, 255.0f);
  }
}

}  // namespace

extern "C" {

// Floats of scratch the caller provides for `b` frames (the min/max
// partials).
int depth_preprocess_workspace(int b) { return b * NPART * 2; }

// raw (b, 512, 640) fp32 -> out (b, 128, 160) fp32. taps: 16 host floats,
// the 5-tap then the 11-tap Gaussian. Returns the CUDA error of the
// launches (0 on success).
int depth_preprocess_launch(const void* raw, void* out, void* workspace,
                            int b, int seed, float sigma, const float* taps,
                            void* stream) {
  if (b <= 0) return (int)cudaErrorInvalidValue;
  Taps k;
  for (int i = 0; i < 5; ++i) k.k5[i] = taps[i];
  for (int i = 0; i < 11; ++i) k.k11[i] = taps[5 + i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  minmax_kernel<<<dim3(NPART, b), THREADS, 0, st>>>(
      static_cast<const float*>(raw), static_cast<float*>(workspace));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  preprocess_kernel<<<dim3(W_OUT / TW, H_OUT / TH, b), THREADS, smem, st>>>(
      static_cast<const float*>(raw), static_cast<const float*>(workspace),
      static_cast<float*>(out), (uint32_t)seed, sigma, k);
  return (int)cudaGetLastError();
}

const char* depth_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
