// Frequency encoding into a warpgroup's activation tile, shared by the
// kernels that encode their inputs on chip: fused_nerf_mlp.cu (points and
// directions, 3-D) and fused_deform_mlp.cu (points, 3-D, and times, 1-D).
//
// The encoding uses the precise sincosf: the top band reaches |2^9 x| ~ 3000
// rad, where the fast intrinsics lose all accuracy, so no source that
// includes this may be built with --use_fast_math.
#pragma once

#include "nerf_mlp_tile.cuh"

namespace nerf {

// Frequency encoding of a warpgroup's 64 rows of a row-major (n, kDims) f32
// input into its tile, freq_encode's layout: [x, sin(2^0 x), cos(2^0 x),
// sin(2^1 x), ...], each over all kDims dims. Columns past the encoded width
// and rows past n are zero. A work item is a row and either the raw
// coordinates (with the zero padding) or one (band, dim): one precise
// sincosf gives both of its columns. A warp shares its item kind, so it
// takes one branch.
template <int kDims = 3>
__device__ __forceinline__ void encode(const float* __restrict__ src, int n,
                                       int row0, int freqs,
                                       unsigned char* tile, int cols, int t) {
  const int dim = kDims * (1 + 2 * freqs), units = 1 + kDims * freqs;
  for (int e = t; e < kWgRows * units; e += kWgThreads) {
    const int p = e % kWgRows, u = e / kWgRows;
    const int gp = row0 + p;
    const bool valid = gp < n;
    unsigned char* row = tile + (p >> 3) * kCore + (p & 7) * 16;
    auto put = [&](int j, float val) {
      *reinterpret_cast<bf16*>(row + (j >> 3) * kALbo + (j & 7) * 2) =
          __float2bfloat16_rn(val);
    };
    if (u == 0) {
      for (int d = 0; d < kDims; ++d)
        put(d, valid ? src[static_cast<size_t>(gp) * kDims + d] : 0.0f);
      for (int j = dim; j < cols; ++j) put(j, 0.0f);
    } else {
      const int band = (u - 1) / kDims, d = (u - 1) % kDims;
      float sn = 0.0f, cs = 0.0f;
      // scaling by 2^band is exact in f32, as in the reference
      if (valid)
        sincosf(src[static_cast<size_t>(gp) * kDims + d] *
                    static_cast<float>(1 << band),
                &sn, &cs);
      put(kDims + 2 * kDims * band + d, sn);
      put(2 * kDims + 2 * kDims * band + d, cs);
    }
  }
}

}  // namespace nerf
