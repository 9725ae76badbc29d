// The bricked multi-level hash-grid encode of one point, shared by
// brick_encode_eval.cu and fused_ngp.cu.
//
// The arithmetic of nerf_replication_tpu/ops/pallas/hashgrid_kernel.py
// (_level_geometry, compute_brick_ids) on the packed eval table of
// ops/pallas/eval_encode.py: one 32-bit word per brick vertex holds feature
// 0's bf16 bits in its high half and feature 1's in its low half, so each
// trilinear corner is one 4-byte load (8 a level). The TPU kernels fetch
// whole brick rows, by one-hot matmuls on the MXU or by scalar row copies;
// on the card a corner load is a gather that the L2 serves (the hard_ngp
// table is 2.8 MB of the 50 MB L2).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), in the order of the plain version in
// ops/eval_encode.py, so kernel and plain version agree bit for bit. Never
// build with --use_fast_math.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace brick {

constexpr int kMaxLevels = 16;
constexpr int kRowWords = 128;   // packed words per table row
constexpr int kBrick = 4;        // cells per brick side
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

// The table layout per level (ops/eval_encode.py kernel_levels).
struct Levels {
  float res[kMaxLevels];            // cells per side
  int offset[kMaxLevels];           // first table row
  int bside[kMaxLevels];            // bricks per side (dense levels)
  uint32_t hash_mask[kMaxLevels];   // hash range - 1; 0 for a dense level
};

// Features (f0, f1) of one level at point p in [0,1]^3.
__device__ __forceinline__ float2 encode_level(const float (&p)[3], float res,
                                               int offset, int bside,
                                               uint32_t hash_mask,
                                               const uint32_t* __restrict__ table) {
  float frac[3];
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(p[a], res);
    // clip(floor(pos), 0, res - 1); a NaN lands on cell 0
    const float c = fminf(fmaxf(floorf(pos), 0.0f), res - 1.0f);
    frac[a] = __fsub_rn(pos, c);
    cell[a] = static_cast<int>(c);
  }
  const int b0 = cell[0] / kBrick, b1 = cell[1] / kBrick, b2 = cell[2] / kBrick;
  uint32_t bid;
  if (hash_mask) {
    bid = (static_cast<uint32_t>(b0) ^ (static_cast<uint32_t>(b1) * kPrime1) ^
           (static_cast<uint32_t>(b2) * kPrime2)) & hash_mask;
  } else {
    bid = static_cast<uint32_t>((b0 * bside + b1) * bside + b2);
  }
  const uint32_t* __restrict__ row =
      table + (static_cast<size_t>(offset) + bid) * kRowWords;
  const int lx = cell[0] % kBrick, ly = cell[1] % kBrick, lz = cell[2] % kBrick;
  uint32_t bits[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
    bits[c] = __ldg(row + (lx + dx) * 25 + (ly + dy) * 5 + (lz + dz));
  }
  float w0[3], w1[3];   // weight of the lower / upper corner along each axis
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w0[a] = __fsub_rn(1.0f, frac[a]);
    w1[a] = frac[a];
  }
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = __fmul_rn(__fmul_rn((c & 4) ? w1[0] : w0[0],
                                        (c & 2) ? w1[1] : w0[1]),
                              (c & 1) ? w1[2] : w0[2]);
    f0 = __fadd_rn(f0, __fmul_rn(w, __uint_as_float(bits[c] & 0xFFFF0000u)));
    f1 = __fadd_rn(f1, __fmul_rn(w, __uint_as_float(bits[c] << 16)));
  }
  return make_float2(f0, f1);
}

// All levels of one point: x[2l], x[2l + 1] = (f0, f1) of level l for
// l < n_levels, zeros up to 2 * kLevels.
template <int kLevels>
__device__ __forceinline__ void encode_point(const float (&p)[3],
                                             const uint32_t* __restrict__ table,
                                             const Levels& lv, int n_levels,
                                             float (&x)[2 * kLevels]) {
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    float2 f = make_float2(0.0f, 0.0f);
    if (l < n_levels)
      f = encode_level(p, lv.res[l], lv.offset[l], lv.bside[l], lv.hash_mask[l],
                       table);
    x[2 * l] = f.x;
    x[2 * l + 1] = f.y;
  }
}

}  // namespace brick
