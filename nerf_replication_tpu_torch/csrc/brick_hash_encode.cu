// Training encode of the bricked hash grid and its table gradient for
// Hopper (sm_90a).
//
//   forward:  x (N, 3) in [0,1], table (n_rows, 256) f32 -> out (N, 2L) f32
//   backward: x, g (N, 2L) f32 -> dtable (n_rows, 256) f32
//
// Replaces the TPU Pallas kernels of brick_hash_encode
// (nerf_replication_tpu/ops/pallas/hashgrid_kernel.py): _fwd_kernel, which
// fetches each point's brick row by a one-hot bf16 matmul (small levels) or
// a scalar row copy (large levels) and picks the 8 corners with a lane
// gather, and _bwd_kernel, which scatters the per-corner updates into a
// contribution row and adds it by the transposed one-hot matmul or a
// serial read-modify-write, race-free on its single-threaded grid. None of
// that carries over: here a thread takes one (point, level), the level
// running fastest, and reads 16 four-byte entries of the f32 parameter
// table (8 corners x 2 features) or adds 16 with atomicAdd.
//
// Numerics are the TPU kernels': on the levels flagged in bf16_levels (at
// most 4096 rows) the forward rounds each table read to bf16 and the
// backward rounds each contribution w * g to bf16, both to nearest even;
// the other levels stay f32; weights and sums are f32. Products and sums
// are rounded one by one in the plain version's order (brick_encode.cuh),
// so the forward equals ops/hashgrid_kernel.brick_encode_reference bit for
// bit. The backward's atomic sums come in an order that differs from run
// to run: it agrees with the plain backward to f32 summation order and is
// not bit-reproducible.
//
// What bounds them: 12 bytes a point in, 8 bytes a level out (forward) or
// in (backward), the touched table entries read or written once and, for
// the backward, the zeroing of the whole dtable, against 57 f32 operations
// a level: device-memory bytes. The design spends far more than that: each
// corner is its own 4-byte access that the L2 serves (the hard_ngp table is
// 35 MB of the 50 MB L2), and on the coarse levels many points add to one
// address (level 0 of hard_ngp has 8000 live addresses a feature).
// Interleaving the levels across neighbouring threads spreads those
// collisions over the run; a shared-memory pre-reduction is not done.

#include <cuda_bf16.h>

#include "brick_encode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 256;   // f32 lanes per table row: f0 at v, f1 at 128 + v

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
brick_hash_encode_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             float* __restrict__ out, int n,
                             const brick::Levels lv, int n_levels,
                             uint32_t bf16_levels) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_levels) return;
  const int i = static_cast<int>(t / n_levels);
  const int l = static_cast<int>(t - static_cast<long long>(i) * n_levels);
  const float p[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const brick::Cell cell =
      brick::locate(p, lv.res[l], lv.offset[l], lv.bside[l], lv.hash_mask[l]);
  const float* __restrict__ row =
      table + static_cast<size_t>(cell.row) * kRow + cell.lane;
  const bool bf16 = (bf16_levels >> l) & 1u;
  float v0[8], v1[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    v0[c] = __ldg(row + brick::corner_lane(c));
    v1[c] = __ldg(row + 128 + brick::corner_lane(c));
  }
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = brick::corner_weight(cell, c);
    const float a = bf16 ? round_bf16(v0[c]) : v0[c];
    const float b = bf16 ? round_bf16(v1[c]) : v1[c];
    f0 = __fadd_rn(f0, __fmul_rn(w, a));
    f1 = __fadd_rn(f1, __fmul_rn(w, b));
  }
  // out[i, 2l .. 2l + 1]: neighbouring threads write neighbouring pairs
  reinterpret_cast<float2*>(out)[t] = make_float2(f0, f1);
}

__global__ void __launch_bounds__(kThreads)
brick_hash_encode_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ g, long long g_stride0,
                             long long g_stride1, float* __restrict__ dtable,
                             int n, const brick::Levels lv, int n_levels,
                             uint32_t bf16_levels) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_levels) return;
  const int i = static_cast<int>(t / n_levels);
  const int l = static_cast<int>(t - static_cast<long long>(i) * n_levels);
  const float p[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const brick::Cell cell =
      brick::locate(p, lv.res[l], lv.offset[l], lv.bside[l], lv.hash_mask[l]);
  float* __restrict__ row =
      dtable + static_cast<size_t>(cell.row) * kRow + cell.lane;
  const float* gi = g + i * g_stride0 + 2 * l * g_stride1;
  const float g0 = gi[0], g1 = gi[g_stride1];
  const bool bf16 = (bf16_levels >> l) & 1u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = brick::corner_weight(cell, c);
    const float c0 = __fmul_rn(w, g0), c1 = __fmul_rn(w, g1);
    atomicAdd(row + brick::corner_lane(c), bf16 ? round_bf16(c0) : c0);
    atomicAdd(row + 128 + brick::corner_lane(c), bf16 ? round_bf16(c1) : c1);
  }
}

int blocks_for(int n, int n_levels) {
  const long long threads = static_cast<long long>(n) * n_levels;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the CUDA error code (0 on success).

int brick_hash_encode_fwd(const float* x, const float* table, float* out,
                          int n, const brick::Levels* levels, int n_levels,
                          uint32_t bf16_levels, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > brick::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  brick_hash_encode_fwd_kernel<<<blocks_for(n, n_levels), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, table, out, n, *levels, n_levels, bf16_levels);
  return static_cast<int>(cudaGetLastError());
}

// Zeroes dtable (table_floats values), then adds every contribution.
int brick_hash_encode_bwd(const float* x, const float* g, long long g_stride0,
                          long long g_stride1, float* dtable,
                          long long table_floats, int n,
                          const brick::Levels* levels, int n_levels,
                          uint32_t bf16_levels, void* stream) {
  if (n_levels < 1 || n_levels > brick::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(dtable, 0, static_cast<size_t>(table_floats) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  brick_hash_encode_bwd_kernel<<<blocks_for(n, n_levels), kThreads, 0, s>>>(
      x, g, g_stride0, g_stride1, dtable, n, *levels, n_levels, bf16_levels);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
