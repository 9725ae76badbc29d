// Warp-level tensor-core products (mma.sync) over PTX, for fused_ngp.cu:
// m16n8k8 with TF32 operands and m16n8k16 with bf16 operands, both into f32
// accumulators, and the operand conversions they need.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   C/D (16 x 8, f32): c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row
//     g + 8, the same columns.
//   TF32 A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
//   TF32 B (8 x 8): b0 (k = t, n = g), b1 (k = t + 4, n = g).
//   bf16 A (16 x 16), two values a register, the lower index in the low half:
//     a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//     a3 (g + 8, 2t+8..2t+9).
//   bf16 B (16 x 8): b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mma {

// f32 -> TF32, to nearest with ties away from zero: the low 13 bits of the
// result are zero, so it is also an f32 value.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as a TF32 pair whose sum is v to about 2^-22 of v: big = tf32(v),
// small = tf32(v - big) (the subtraction is exact).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// Two f32 values rounded to bf16 (nearest, ties to even), `lo` in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d += a . b, m16n8k8, TF32 x TF32 -> f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k16, bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
