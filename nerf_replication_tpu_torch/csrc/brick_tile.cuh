// The thread map and the staged loads and stores of the two brick gather
// kernels, brick_encode_eval.cu and the forward of brick_hash_encode.cu:
// points x (N, 3) in [0,1] -> features out (N, 2L) f32, out[i, 2l .. 2l + 1]
// the two features of level l at point i.
//
// A block takes a tile of kTile consecutive points and blockDim.x / kTile
// groups of levels. Thread t takes point t % kTile of the tile and the
// levels t / kTile, t / kTile + groups, ..., one at a time, so the 32
// lanes of a table load are 32 consecutive points (neighbouring samples of
// one ray) at one level: on the coarse levels they share cells, rows and
// sectors, and the L2 serves one sector for all of them. The tile's points
// are read once, coalesced, into shared memory; each (point, level) writes
// its two features into a shared (tile x stride) buffer, stride = 2L
// padded to an odd count of 8-byte words, so that the float2 stores of 32
// consecutive points fall on different banks; then the block writes the
// tile's tile x 2L contiguous floats with 16-byte stores. Lanes past N
// read and write nothing. Each kernel fixes its own shape: the eval encode
// 64-point tiles and two level groups, the training forward 32-point tiles
// and a warp a level.
//
// ops/brick_tile.py models this map (tests/test_torch_brick_gathers.py
// checks that it covers every (point, level) once): keep the two in step.

#pragma once

#include <cuda_runtime.h>

#include "brick_encode.cuh"

namespace brick {

// floats between two points' features in the staged tile
__host__ __device__ constexpr int tile_stride(int n_levels) {
  return 2 * (n_levels | 1);
}

// the points, then the features
inline size_t tile_shared_bytes(int tile, int n_levels) {
  return static_cast<size_t>(3 + tile_stride(n_levels)) * tile * 4;
}

// One tile of points; level(p, l) -> float2 gives the features of level l
// at point p.
template <int kTile, class LevelFn>
__device__ __forceinline__ void encode_tile(const float* __restrict__ x,
                                            float* __restrict__ out, int n,
                                            int n_levels, LevelFn level) {
  extern __shared__ float4 tile_shared[];
  float* const sx = reinterpret_cast<float*>(tile_shared);
  float* const so = sx + 3 * kTile;
  const int groups = blockDim.x / kTile;
  const int first = blockIdx.x * kTile;
  const int count = min(kTile, n - first);
  const float* __restrict__ xs = x + 3 * static_cast<size_t>(first);
  for (int i = threadIdx.x; i < 3 * count; i += blockDim.x) sx[i] = xs[i];
  __syncthreads();

  const int stride = tile_stride(n_levels);
  const int slot = threadIdx.x % kTile;
  if (slot < count) {
    const float p[3] = {sx[3 * slot], sx[3 * slot + 1], sx[3 * slot + 2]};
    float2* const dst = reinterpret_cast<float2*>(so + slot * stride);
#pragma unroll 4
    for (int l = threadIdx.x / kTile; l < n_levels; l += groups)
      dst[l] = level(p, l);
  }
  __syncthreads();

  // element e of the tile's output is point e / 2L, feature e % 2L; 2L is
  // even, so a 16-byte group is two float2 of the staged tile
  const int feats = 2 * n_levels;
  const int total = count * feats;
  float* __restrict__ o = out + static_cast<size_t>(first) * feats;
  for (int v = threadIdx.x; v < total / 4; v += blockDim.x) {
    int q = 4 * v / feats, j = 4 * v - q * feats;
    const float2 a = *reinterpret_cast<const float2*>(so + q * stride + j);
    j += 2;
    if (j == feats) j = 0, ++q;
    const float2 b = *reinterpret_cast<const float2*>(so + q * stride + j);
    reinterpret_cast<float4*>(o)[v] = make_float4(a.x, a.y, b.x, b.y);
  }
  if ((total & 3) != 0 && threadIdx.x == 0) {   // total % 4 == 2
    const int e = total - 2, q = e / feats;
    *reinterpret_cast<float2*>(o + e) =
        *reinterpret_cast<const float2*>(so + q * stride + e - q * feats);
  }
}

}  // namespace brick
