// The bricked multi-level hash-grid encode of one point, shared by
// brick_encode_eval.cu, fused_ngp.cu and brick_hash_encode.cu.
//
// The arithmetic of nerf_replication_tpu/ops/pallas/hashgrid_kernel.py
// (_level_geometry, compute_brick_ids): locate() and the corner helpers
// serve every kernel; encode_level() applies them to the packed eval table
// of ops/pallas/eval_encode.py: one 32-bit word per brick vertex holds feature
// 0's bf16 bits in its high half and feature 1's in its low half, so each
// trilinear corner is one 4-byte load (8 a level, over ~3.5 of the L2's
// 32-byte sectors). encode_level_cells() reads the same words from the
// cell-corner table, where a level's 8 corners are one sector. The TPU
// kernels fetch whole brick rows, by one-hot matmuls on the MXU or by
// scalar row copies; on the card a corner load is a gather that the L2
// serves (the hard_ngp table is 2.8 MB of the 50 MB L2 packed, 11.3 MB as
// cells).
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

// The table layout per level (ops/hashgrid_kernel.py kernel_levels).
struct Levels {
  float res[kMaxLevels];            // cells per side
  int offset[kMaxLevels];           // first table row
  int bside[kMaxLevels];            // bricks per side (dense levels)
  uint32_t hash_mask[kMaxLevels];   // hash range - 1; 0 for a dense level
};

// Where point p in [0,1]^3 falls in one level: its brick's table row, the
// lane of its cell's lowest corner in that row, and the trilinear weights
// of the lower and upper corner along each axis.
struct Cell {
  uint32_t row;          // table row: the level's offset + the brick id
  int lane;              // lx * 25 + ly * 5 + lz of the in-brick cell
  float w0[3], w1[3];    // 1 - fraction, fraction
};

__device__ __forceinline__ Cell locate(const float (&p)[3], float res,
                                       int offset, int bside,
                                       uint32_t hash_mask) {
  Cell cell;
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(p[a], res);
    // clip(floor(pos), 0, res - 1); a NaN lands on cell 0
    const float f = fminf(fmaxf(floorf(pos), 0.0f), res - 1.0f);
    cell.w1[a] = __fsub_rn(pos, f);
    cell.w0[a] = __fsub_rn(1.0f, cell.w1[a]);
    c[a] = static_cast<int>(f);
  }
  const int b0 = c[0] / kBrick, b1 = c[1] / kBrick, b2 = c[2] / kBrick;
  uint32_t bid;
  if (hash_mask) {
    bid = (static_cast<uint32_t>(b0) ^ (static_cast<uint32_t>(b1) * kPrime1) ^
           (static_cast<uint32_t>(b2) * kPrime2)) & hash_mask;
  } else {
    bid = static_cast<uint32_t>((b0 * bside + b1) * bside + b2);
  }
  cell.row = static_cast<uint32_t>(offset) + bid;
  cell.lane = (c[0] % kBrick) * 25 + (c[1] % kBrick) * 5 + (c[2] % kBrick);
  return cell;
}

// Corner c = 4 dx + 2 dy + dz: its lane offset from the cell's lowest
// corner, and its weight, multiplied in the order x, y, z.
__device__ __forceinline__ int corner_lane(int c) {
  return ((c >> 2) & 1) * 25 + ((c >> 1) & 1) * 5 + (c & 1);
}

__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  return __fmul_rn(__fmul_rn((c & 4) ? cell.w1[0] : cell.w0[0],
                             (c & 2) ? cell.w1[1] : cell.w0[1]),
                   (c & 1) ? cell.w1[2] : cell.w0[2]);
}

// Features (f0, f1) of one level at point p in [0,1]^3, from the packed
// eval table.
__device__ __forceinline__ float2 encode_level(const float (&p)[3], float res,
                                               int offset, int bside,
                                               uint32_t hash_mask,
                                               const uint32_t* __restrict__ table) {
  const Cell cell = locate(p, res, offset, bside, hash_mask);
  const uint32_t* __restrict__ row =
      table + static_cast<size_t>(cell.row) * kRowWords + cell.lane;
  uint32_t bits[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) bits[c] = __ldg(row + corner_lane(c));
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(cell, c);
    f0 = __fadd_rn(f0, __fmul_rn(w, __uint_as_float(bits[c] & 0xFFFF0000u)));
    f1 = __fadd_rn(f1, __fmul_rn(w, __uint_as_float(bits[c] << 16)));
  }
  return make_float2(f0, f1);
}

// The cell-corner table of ops/eval_encode.py (pack_cell_table): row r
// holds, for each cell k = lx * 16 + ly * 4 + lz of brick r, the packed
// words of its 8 corners (c = 0..7) at words 8k .. 8k + 7. A level's
// corners are then one aligned 32-byte sector, two 16-byte loads.
constexpr int kCellWords = 512;   // words per cell-table row

// The in-brick cell k of a lane lx * 25 + ly * 5 + lz (each in 0..3):
// lane - 9 lx - ly = lx * 16 + ly * 4 + lz.
__device__ __forceinline__ int cell_index(int lane) {
  const int lx = lane / 25;
  return lane - 9 * lx - (lane - 25 * lx) / 5;
}

// encode_level() from the cell-corner table: the same words, weights,
// products and sums in the same order, so the same bits.
__device__ __forceinline__ float2 encode_level_cells(
    const float (&p)[3], float res, int offset, int bside, uint32_t hash_mask,
    const uint32_t* __restrict__ cells) {
  const Cell cell = locate(p, res, offset, bside, hash_mask);
  const uint4* __restrict__ at = reinterpret_cast<const uint4*>(
      cells + static_cast<size_t>(cell.row) * kCellWords +
      8 * cell_index(cell.lane));
  const uint4 lo = __ldg(at), hi = __ldg(at + 1);
  const uint32_t bits[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(cell, c);
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
