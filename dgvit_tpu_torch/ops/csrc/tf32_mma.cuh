// fp32 products on the H100's tensor cores as three TF32 products
// (3xTF32), for the fp32 kernels that run there: K8's fp32 form
// (attention.cu: attention_tf32_kernel) and K1's fp32 cluster form
// (got_megakernel.cu: k1_cluster_fp32_kernel).
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

}  // namespace tf32
}  // namespace
