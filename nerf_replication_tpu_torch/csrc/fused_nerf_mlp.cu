// Canonical NeRF MLP forward for Hopper (sm_90a), with the frequency
// encoding fused in (fused_nerf_mlp_enc) or from encoded features
// (fused_nerf_mlp).
//
// Replaces the TPU Pallas kernels fused_nerf_mlp_enc_t and fused_nerf_mlp_enc
// (nerf_replication_tpu/ops/pallas/mlp_kernel.py, _kernel_enc +
// _kernel_body), and fused_nerf_mlp (mlp_kernel.py, _kernel) with the
// training forward that runs the same body (ops/pallas/mlp_train.py,
// _fwd_impl).
//
// What bounds it: per point the MLP costs about 1.19 MFLOP against 24 bytes
// of input (or 192 bytes of bf16 features) and 16 bytes of output, so it is
// compute-bound on the tensor cores. The design keeps every activation on
// chip: one block takes a tile of 64 points, encodes or loads them into
// shared memory and runs all layers on that tile, so device memory sees only
// the inputs and the (N, 4) result. The bf16 weight pack (about 1.2 MB) is
// read from global memory and stays resident in the 50 MB L2.
//
// The encoding uses precise sinf/cosf: the top band reaches |2^9 x| ~ 3000
// rad, where the fast intrinsics lose all accuracy, so this file must never
// be built with --use_fast_math. Packs and numerics: nerf_mlp_tile.cuh.

#include "nerf_mlp_tile.cuh"

namespace {

using namespace nerf;

// Frequency encoding of a tile, freq_encode's layout: [x, sin(2^0 x),
// cos(2^0 x), sin(2^1 x), ...], each over all three dims. Columns past the
// encoded width and rows past n are zero.
__device__ __forceinline__ void encode(const float* __restrict__ src, int n,
                                       int row0, int freqs, bf16* dst, int ld,
                                       int cols, int tid) {
  const int dim = 3 * (1 + 2 * freqs);
  for (int e = tid; e < kTileM * cols; e += kThreads) {
    const int p = e / cols, j = e % cols;
    const int gp = row0 + p;
    float val = 0.0f;
    if (j < dim && gp < n) {
      if (j < 3) {
        val = src[static_cast<size_t>(gp) * 3 + j];
      } else {
        const int m = j - 3, band = m / 6, w = m % 6;
        // scaling by 2^band is exact in f32, as in the reference
        const float xb = src[static_cast<size_t>(gp) * 3 + w % 3] *
                         static_cast<float>(1 << band);
        val = (w < 3) ? sinf(xb) : cosf(xb);
      }
    }
    dst[p * ld + j] = __float2bfloat16_rn(val);
  }
}

struct NoHook {
  __device__ void operator()(int) const {}
};

// Runs the MLP on the tile in s.x / s.v and writes out = [rgb, sigma].
__device__ __forceinline__ void mlp_tile_out(Smem& s, float* __restrict__ out,
                                             int n, int row0,
                                             const bf16* __restrict__ w,
                                             const float* __restrict__ b,
                                             int depth, int skip) {
  forward_tile<true>(s, w, b, depth, skip, NoHook());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* stage = s.stage + warp * 256;
  // RGB head: warps 0..3 take 16 rows each; out = [rgb, sigma]
  if (warp < 4) {
    const bf16* __restrict__ wr = w + w_rgb_offset(depth, skip);
    const float* __restrict__ br = b + b_rgb_offset(depth);
    FragC accr[1][1];
    zero(accr);
    mma_tiles<1, 1>(accr, s.h + warp * 16 * kLdH, kLdH, wr, kRgbCols, kHalf);
    wmma::store_matrix_sync(stage, accr[0][0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * 4; e += 32) {
      const int r = e >> 2, c = e & 3;
      const int gp = row0 + warp * 16 + r;
      if (gp < n)
        out[static_cast<size_t>(gp) * 4 + c] =
            c < 3 ? stage[r * 16 + c] + br[c] : s.sigma[warp * 16 + r];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_nerf_mlp_enc_kernel(const float* __restrict__ pts,
                          const float* __restrict__ dirs,
                          float* __restrict__ out, int n,
                          const bf16* __restrict__ w,
                          const float* __restrict__ b, int depth, int skip,
                          int xyz_freqs, int view_freqs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int row0 = blockIdx.x * kTileM;
  encode(pts, n, row0, xyz_freqs, s.x, kLdX, kXDim, threadIdx.x);
  encode(dirs, n, row0, view_freqs, s.v, kLdV, kVDim, threadIdx.x);
  __syncthreads();
  mlp_tile_out(s, out, n, row0, w, b, depth, skip);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_nerf_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v,
                      float* __restrict__ out, int n,
                      const bf16* __restrict__ w, const float* __restrict__ b,
                      int depth, int skip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int row0 = blockIdx.x * kTileM;
  load_rows(x, n, row0, kXDim, s.x, kLdX, threadIdx.x);
  load_rows(v, n, row0, kVDim, s.v, kLdV, threadIdx.x);
  __syncthreads();
  mlp_tile_out(s, out, n, row0, w, b, depth, skip);
}

template <typename Kernel>
int set_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem))));
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int fused_nerf_mlp_enc(const float* pts, const float* dirs, float* out, int n,
                       const void* w, const float* b, int depth, int skip,
                       int xyz_freqs, int view_freqs, void* stream) {
  if (n <= 0) return 0;
  if (int err = set_smem(fused_nerf_mlp_enc_kernel)) return err;
  const int blocks = (n + kTileM - 1) / kTileM;
  fused_nerf_mlp_enc_kernel<<<blocks, kThreads, sizeof(Smem),
                              static_cast<cudaStream_t>(stream)>>>(
      pts, dirs, out, n, static_cast<const bf16*>(w), b, depth, skip,
      xyz_freqs, view_freqs);
  return static_cast<int>(cudaGetLastError());
}

// x (n, 64) and v (n, 32) bf16 encoded features, zero-padded columns.
int fused_nerf_mlp(const void* x, const void* v, float* out, int n,
                   const void* w, const float* b, int depth, int skip,
                   void* stream) {
  if (n <= 0) return 0;
  if (int err = set_smem(fused_nerf_mlp_kernel)) return err;
  const int blocks = (n + kTileM - 1) / kTileM;
  fused_nerf_mlp_kernel<<<blocks, kThreads, sizeof(Smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(v), out, n,
      static_cast<const bf16*>(w), b, depth, skip);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
