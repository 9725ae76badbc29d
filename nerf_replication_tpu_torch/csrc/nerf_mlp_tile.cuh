// Tile machinery shared by fused_nerf_mlp.cu (forward) and
// fused_nerf_mlp_bwd.cu (backward): constants, shared-memory tiles, wmma
// products and the forward pass of one 64-point tile.
//
// Numerics follow the TPU kernels: bf16 operands, f32 accumulation, f32
// bias + ReLU, rounded to bf16 before each next matmul; the density comes
// from the f32 accumulator.
//
// Layout of the weight pack (bf16 for the kernels, row-major (in, out), in
// order):
//   W0 [64 x 256]; for i in 1..depth-1: (i == skip + 1: W_ix [64 x 256]),
//   W_i [256 x 256]; W_feat [256 x 256]; w_alpha [256];
//   Wv_f [256 x 128]; Wv_d [32 x 128]; W_rgb [128 x 16].
// Bias pack (f32): b_0..b_{depth-1} [256 each]; b_feat [256];
//   b_alpha [16, first used]; b_v [128]; b_rgb [16, first 3 used].
// nerf_replication_tpu_torch/ops/mlp_kernel.py builds both packs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace nerf {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kTileM = 64;           // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWidth = 256;          // trunk width
constexpr int kHalf = 128;           // view layer width
constexpr int kXDim = 64;            // encoded point features, padded to 16s
constexpr int kVDim = 32;            // encoded direction features, padded
constexpr int kRgbCols = 16;         // RGB head, padded
constexpr int kAlphaPad = 16;        // density-head bias, padded
// shared-memory row pitches, skewed by 16 bytes against bank conflicts
constexpr int kLdH = kWidth + 8;
constexpr int kLdX = kXDim + 8;
constexpr int kLdV = kVDim + 8;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Offsets into the packs (elements).
__host__ __device__ inline size_t w_trunk_offset(int i, int skip) {
  // W_i (the h part for the skip layer), i >= 1
  size_t off = static_cast<size_t>(kXDim) * kWidth;
  for (int j = 1; j <= i; ++j) {
    if (j == skip + 1) off += static_cast<size_t>(kXDim) * kWidth;
    if (j < i) off += static_cast<size_t>(kWidth) * kWidth;
  }
  return off;
}
__host__ __device__ inline size_t w_feat_offset(int depth, int skip) {
  return w_trunk_offset(depth - 1, skip) + static_cast<size_t>(kWidth) * kWidth;
}
__host__ __device__ inline size_t w_alpha_offset(int depth, int skip) {
  return w_feat_offset(depth, skip) + static_cast<size_t>(kWidth) * kWidth;
}
__host__ __device__ inline size_t w_view_offset(int depth, int skip) {
  return w_alpha_offset(depth, skip) + kWidth;
}
__host__ __device__ inline size_t w_view_dir_offset(int depth, int skip) {
  return w_view_offset(depth, skip) + static_cast<size_t>(kWidth) * kHalf;
}
__host__ __device__ inline size_t w_rgb_offset(int depth, int skip) {
  return w_view_dir_offset(depth, skip) + static_cast<size_t>(kVDim) * kHalf;
}
__host__ __device__ inline size_t w_pack_size(int depth, int skip) {
  return w_rgb_offset(depth, skip) + static_cast<size_t>(kHalf) * kRgbCols;
}
__host__ __device__ inline int b_feat_offset(int depth) { return depth * kWidth; }
__host__ __device__ inline int b_alpha_offset(int depth) {
  return (depth + 1) * kWidth;
}
__host__ __device__ inline int b_view_offset(int depth) {
  return (depth + 1) * kWidth + kAlphaPad;
}
__host__ __device__ inline int b_rgb_offset(int depth) {
  return b_view_offset(depth) + kHalf;
}
__host__ __device__ inline int b_pack_size(int depth) {
  return b_rgb_offset(depth) + kRgbCols;
}

template <int MT, int NT>
__device__ __forceinline__ void zero(FragC (&acc)[MT][NT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc[i][j] += A[16i.., 0:K] @ B[0:K, 16j..]. A lies in shared memory
// (pitch lda, offset to the warp's first row). B lies in global memory:
// with wmma::row_major it is a (K, N) matrix of pitch ldb, offset to the
// warp's first column; with wmma::col_major it is the transpose of a
// row-major (N, K) matrix W of pitch ldb, offset to W's row of the warp's
// first column (B[k][n] = W[n][k]).
template <int MT, int NT, typename Layout = wmma::row_major>
__device__ __forceinline__ void mma_tiles(FragC (&acc)[MT][NT], const bf16* A,
                                          int lda, const bf16* __restrict__ B,
                                          int ldb, int K) {
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, Layout> FragB;
  constexpr bool kRow = std::is_same<Layout, wmma::row_major>::value;
  for (int k = 0; k < K; k += 16) {
    FragA a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      wmma::load_matrix_sync(a[i], A + i * 16 * lda + k, lda);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB b;
      const size_t at = kRow ? static_cast<size_t>(k) * ldb + j * 16
                             : static_cast<size_t>(j) * 16 * ldb + k;
      wmma::load_matrix_sync(b, B + at, ldb);
#pragma unroll
      for (int i = 0; i < MT; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

// f32 bias (+ ReLU), rounded to bf16 into shared memory: the value the next
// layer's matmul reads. The accumulator goes through the warp's staging
// tile because the fragment's element order is opaque.
template <int MT, int NT, bool kRelu>
__device__ __forceinline__ void store_bf16(FragC (&acc)[MT][NT], float* stage,
                                           const float* __restrict__ bias,
                                           bf16* dst, int ldd, int lane) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        float val = stage[e] + __ldg(bias + j * 16 + c);
        if (kRelu) val = fmaxf(val, 0.0f);
        dst[(i * 16 + r) * ldd + j * 16 + c] = __float2bfloat16_rn(val);
      }
      __syncwarp();
    }
}

// Rows [row0, row0 + 64) of a row-major bf16 (n, cols) matrix into shared
// memory (pitch ld); rows past n are zero. cols is a multiple of 8 and
// both pitches keep 16-byte alignment.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, int n,
                                          int row0, int cols, bf16* dst,
                                          int ld, int tid) {
  const int vecs = cols / 8;
  for (int e = tid; e < kTileM * vecs; e += kThreads) {
    const int p = e / vecs, q = e % vecs;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + p < n)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + p) * cols + q * 8);
    *reinterpret_cast<uint4*>(dst + p * ld + q * 8) = val;
  }
}

// Columns [0, cols) of the 64 rows of a shared-memory tile (pitch ld) into
// rows [row0, row0 + 64) of a row-major bf16 matrix of pitch ldg in global
// memory.
__device__ __forceinline__ void store_rows(const bf16* src, int ld, int cols,
                                           bf16* __restrict__ dst, int ldg,
                                           int row0, int tid) {
  const int vecs = cols / 8;
  for (int e = tid; e < kTileM * vecs; e += kThreads) {
    const int p = e / vecs, q = e % vecs;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + p) * ldg +
                              q * 8) =
        *reinterpret_cast<const uint4*>(src + p * ld + q * 8);
  }
}

struct Smem {
  bf16 h[kTileM * kLdH];             // activations, updated in place
  bf16 x[kTileM * kLdX];             // encoded points (the skip input too)
  bf16 v[kTileM * kLdV];             // encoded directions
  float stage[kWarps * 256];         // one 16x16 f32 tile per warp
  float sigma[kTileM];
};

// The forward pass of one tile whose encoded inputs are in s.x and s.v,
// through the view layer: afterwards s.h holds the view activations
// (columns 0..127) and, with kSigma, s.sigma the raw density. hook(l) runs
// after every layer's activations are complete in s.h (l = 0..depth-1 for
// the trunk, depth for the feature layer, depth + 1 for the view layer),
// with all threads synchronised.
template <bool kSigma, typename Hook>
__device__ __forceinline__ void forward_tile(Smem& s, const bf16* __restrict__ w,
                                             const float* __restrict__ b,
                                             int depth, int skip, Hook hook) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* stage = s.stage + warp * 256;
  // each warp owns 32 of the 256 output columns, for all 64 rows
  const int n0 = warp * 32;
  FragC acc[4][2];

  zero(acc);
  mma_tiles<4, 2>(acc, s.x, kLdX, w + n0, kWidth, kXDim);
  w += kXDim * kWidth;
  store_bf16<4, 2, true>(acc, stage, b + n0, s.h + n0, kLdH, lane);
  b += kWidth;
  __syncthreads();
  hook(0);

  for (int i = 1; i < depth; ++i) {
    zero(acc);
    if (i == skip + 1) {  // the [x, h] concat as a split matmul
      mma_tiles<4, 2>(acc, s.x, kLdX, w + n0, kWidth, kXDim);
      w += kXDim * kWidth;
    }
    mma_tiles<4, 2>(acc, s.h, kLdH, w + n0, kWidth, kWidth);
    w += kWidth * kWidth;
    __syncthreads();  // every warp has read h before it is overwritten
    store_bf16<4, 2, true>(acc, stage, b + n0, s.h + n0, kLdH, lane);
    b += kWidth;
    __syncthreads();
    hook(i);
  }

  if (kSigma) {
    // density head: an f32 dot of the bf16 activations, 4 threads per point
    const bf16* __restrict__ wa = w + kWidth * kWidth;
    const int p = tid >> 2, q = tid & 3;
    const bf16* hp = s.h + p * kLdH + q * 64;
    float sum = 0.0f;
    for (int k = 0; k < 64; ++k)
      sum += __bfloat162float(hp[k]) * __bfloat162float(wa[q * 64 + k]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (q == 0) s.sigma[p] = sum + b[kWidth];
  }
  // feature head: no ReLU
  zero(acc);
  mma_tiles<4, 2>(acc, s.h, kLdH, w + n0, kWidth, kWidth);
  w += kWidth * kWidth + kWidth;
  __syncthreads();
  store_bf16<4, 2, false>(acc, stage, b + n0, s.h + n0, kLdH, lane);
  b += kWidth + kAlphaPad;
  __syncthreads();
  hook(depth);

  // view layer: relu(feat @ Wv_f + v @ Wv_d + b_v), 16 columns per warp
  const int nv = warp * 16;
  FragC accv[4][1];
  zero(accv);
  mma_tiles<4, 1>(accv, s.h, kLdH, w + nv, kHalf, kWidth);
  w += kWidth * kHalf;
  mma_tiles<4, 1>(accv, s.v, kLdV, w + nv, kHalf, kVDim);
  __syncthreads();
  store_bf16<4, 1, true>(accv, stage, b + nv, s.h + nv, kLdH, lane);
  __syncthreads();
  hook(depth + 1);
}

}  // namespace nerf
