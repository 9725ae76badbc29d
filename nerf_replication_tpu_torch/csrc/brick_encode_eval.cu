// Forward-only bricked hash-grid encode for Hopper (sm_90a): x (N, 3) in
// [0,1] and the packed eval table -> features (N, 2L) f32.
//
// Replaces the TPU Pallas kernels of brick_encode_eval
// (nerf_replication_tpu/ops/pallas/eval_encode.py): _eval_kernel_v2, the
// all-"mxu" lane-parallel variant, and _eval_kernel, which copies rows of
// large levels one by one. Those are two fetch strategies of the TPU's
// memory system for one function; here one design covers both: a thread
// per point, 8 four-byte corner loads a level from the packed table
// (csrc/brick_encode.cuh), each giving both features.
//
// What bounds it: per point 12 bytes in and 8 bytes a level out, plus the
// table read once (2.8 MB for hard_ngp, resident in the 50 MB L2), against
// ~57 f32 operations a level, so device-memory bytes.

#include "brick_encode.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
brick_encode_eval_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ table,
                         float* __restrict__ out, int n, const brick::Levels lv,
                         int n_levels) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  float f[2 * brick::kMaxLevels];
  brick::encode_point<brick::kMaxLevels>(p, table, lv, n_levels, f);
  float2* __restrict__ dst =
      reinterpret_cast<float2*>(out + static_cast<size_t>(i) * 2 * n_levels);
#pragma unroll
  for (int l = 0; l < brick::kMaxLevels; ++l)
    if (l < n_levels) dst[l] = make_float2(f[2 * l], f[2 * l + 1]);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int brick_encode_eval(const float* x, const void* table, float* out, int n,
                      const brick::Levels* levels, int n_levels,
                      void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > brick::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  brick_encode_eval_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint32_t*>(table), out, n, *levels, n_levels);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
