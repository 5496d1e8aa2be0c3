// 3xTF32 on the tensor cores, shared by K2 (linf_info.cu) and the wide
// levels of K5 (flow_step.cu, and the folds of flow_step_bf16.cu): an f32
// operand split into a TF32 big part and the rest, and one
// mma.sync.m16n8k8 with TF32 inputs and f32 sums.
#pragma once

#include <cstdint>

namespace {

// x = big + small to ~2^-21 of |x|: big is x rounded to TF32 (half a
// TF32 ulp added to the magnitude, the 13 low mantissa bits cleared:
// cvt.rna's rounding in two integer ops), small = x - big, exact in f32;
// the tensor cores read a TF32 operand's top 19 bits, so they truncate
// small to TF32 (CUTLASS's OpMultiplyAddFastF32 rounds the same way)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// the same split with small rounded to TF32 as well (to nearest, ties
// away), not truncated by the tensor cores: x = big + small to ~2^-22 of |x|
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& big,
                                              uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col) in TF32, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
