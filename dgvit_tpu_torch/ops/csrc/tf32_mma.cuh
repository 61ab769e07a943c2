// fp32 products on the H100's tensor cores as three TF32 products
// (3xTF32), for the fp32 kernels that run there: K8's fp32 form
// (attention.cu: attention_tf32_kernel) and the fp32 cluster block body
// (tf32_block.cuh) of K1's, K2f's and K2b's fp32 forms.
//
// Each fp32 operand x is split as hi = tf32(x) (rounded to nearest) and
// lo = tf32(x - hi); x - hi is exact in fp32, so x - hi - lo is at most
// 2^-22 |x|. A product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b
// (the small terms first) by `mma.sync.m16n8k8` into fp32 accumulators;
// each TF32 product is exact in fp32, and the dropped lo_a lo_b is below
// 2^-21 |a b|: about what fp32 FMA loops lose to their own roundings, at
// three tensor-core products where one bf16 product went.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A holds rows g
// and g + 8 at depth t and t + 4; B column g at depth t and t + 4; the
// accumulator rows g and g + 8, columns 2t and 2t + 1. The kernels order
// each 8-deep step so that depth t is element 2t of the step and depth
// t + 4 element 2t + 1 (a sum does not depend on the order of its terms):
// then an accumulator tile (rows g, g + 8; columns 2t, 2t + 1) is the A
// fragment of the next product with no exchange between lanes (`frag`),
// and B's two values are elements 2t and 2t + 1 of one column.

#pragma once

#include <cstdint>

namespace {
namespace tf32 {

// x rounded to TF32 (10 bits of mantissa) by integer arithmetic: half an
// ulp of TF32 added to the bits, the 13 low bits cleared (to nearest, ties
// away from zero). An H100 converts 16 values a clock an SM with
// cvt.rna.tf32.f32 and adds and masks integers at four times that rate,
// and the splits are most of a 3xTF32 product's instructions.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (+ at most 2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col); TF32 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its TF32 halves
struct A {
  uint32_t hi[4], lo[4];
};

// The A fragment of rows (g, g + 8) x elements (2t, 2t + 1) of one 8-wide
// step: (a0, a1) the element 2t of rows g and g + 8, (a2, a3) element 2t + 1
__device__ __forceinline__ void frag(A& a, float g0, float g8, float g0n,
                                     float g8n) {
  split(g0, a.hi[0], a.lo[0]);
  split(g8, a.hi[1], a.lo[1]);
  split(g0n, a.hi[2], a.lo[2]);
  split(g8n, a.hi[3], a.lo[3]);
}

// ... from an accumulator tile (c0, c1: row g; c2, c3: row g + 8)
__device__ __forceinline__ void frag(A& a, const float (&c)[4]) {
  frag(a, c[0], c[2], c[1], c[3]);
}

// c += a b as 3xTF32; b0, b1: B's elements 2t and 2t + 1 of column g
__device__ __forceinline__ void mma3(float (&c)[4], const A& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(c, a.lo, h0, h1);
  mma(c, a.hi, l0, l1);
  mma(c, a.hi, h0, h1);
}

// The same with the terms kept apart: big += hi_a hi_b, small += lo_a hi_b
// + hi_a lo_b. The tensor cores truncate as they accumulate, so a long
// chain of 3xTF32 steps into one accumulator loses about an fp32 ulp of
// the running sum a step; two accumulators make big's chain a third as
// long, small's truncation 2^-11 times smaller, and the two chains
// independent of each other.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const A& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(small, a.lo, h0, h1);
  mma(small, a.hi, l0, l1);
  mma(big, a.hi, h0, h1);
}

// c += a b as 3xTF32, the three products summed from zero and then added
// to c in fp32 (rounded to nearest). The tensor cores truncate as they
// accumulate: a chain of steps into one accumulator loses up to an fp32
// ulp of the running sum at each step, always toward zero, so the loss
// grows with the chain's length; summed from zero, a step loses at most
// an ulp of its own sum, and the running sum rounds as an fp32 FMA loop's
// does. K2's forms of the fp32 cluster block body (tf32_block.cuh:
// cl32::Exact) sum every product so.
__device__ __forceinline__ void mma_add(float (&c)[4], const A& a, float b0,
                                        float b1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(s, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}

// x split exactly into three TF32 parts, x = hi + mid + lo: x - hi has at
// most 13 significant bits, mid keeps 11 of them and lo (at most 2) is
// exact in TF32.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = round_tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = round_tf32(r);
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// An A fragment split exactly into three TF32 parts
struct A3 {
  uint32_t hi[4], mid[4], lo[4];
};

__device__ __forceinline__ void frag(A3& a, float g0, float g8, float g0n,
                                     float g8n) {
  split3(g0, a.hi[0], a.mid[0], a.lo[0]);
  split3(g8, a.hi[1], a.mid[1], a.lo[1]);
  split3(g0n, a.hi[2], a.mid[2], a.lo[2]);
  split3(g8n, a.hi[3], a.mid[3], a.lo[3]);
}

__device__ __forceinline__ void frag(A3& a, const float (&c)[4]) {
  frag(a, c[0], c[2], c[1], c[3]);
}

// c += a b from the exact split, the six TF32 products down to 2^-24 of
// a b (mid mid, hi lo, lo hi, hi mid, mid hi, hi hi, the small first)
// summed from zero and added to c in fp32: each product as exact as fp32's
// own, where 3xTF32 leaves up to about 2^-21 of it. The attention's
// products take it: a trained model's attention can be one-hot (score
// spreads of thousands), and there the softmax and its backward magnify
// every error of the scores and of dp.
__device__ __forceinline__ void mma_add(float (&c)[4], const A3& a, float b0,
                                        float b1) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split3(b0, h0, m0, l0);
  split3(b1, h1, m1, l1);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma(s, a.mid, m0, m1);
  mma(s, a.hi, l0, l1);
  mma(s, a.lo, h0, h1);
  mma(s, a.hi, m0, m1);
  mma(s, a.mid, h0, h1);
  mma(s, a.hi, h0, h1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}

}  // namespace tf32
}  // namespace
