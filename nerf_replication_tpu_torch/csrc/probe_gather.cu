// Gather and scatter probes for Hopper (sm_90a): what a row fetch, an element
// fetch, a lane gather and an atomic add cost on this card, the questions
// scripts/probe_pallas_gather.py (dyn, dyn3, dma, lane) put to the TPU when
// the brick hash-grid kernels were designed. scripts/probe_cuda_gather.py
// holds each against PyTorch indexing and times it.
//
// Every probe moves data and does no arithmetic beyond addresses, so
// device-memory bytes bound them all.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 256;     // f32 lanes per table row
constexpr int kPairs = 8;     // elements a point, as 8 trilinear corners
constexpr int kLanes = 128;   // lane-gather width

// (a) out[i, :] = table[idx[i], :]: a warp a row, two 16-byte loads a lane.
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                  float4* __restrict__ out, int n) {
  const int i = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (i >= n) return;
  const float4* src = table + static_cast<size_t>(idx[i]) * (kRow / 4);
  float4* dst = out + static_cast<size_t>(i) * (kRow / 4);
  dst[lane] = __ldg(src + lane);
  dst[lane + 32] = __ldg(src + lane + 32);
}

// (b) out[i, k] = table[idx[i], lanes[i, k]]: a 4-byte load a (row, lane)
// pair, a thread a point, as the encode kernels read their corners.
__global__ void __launch_bounds__(kThreads)
elem_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   const int* __restrict__ lanes, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* row = table + static_cast<size_t>(idx[i]) * kRow;
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    out[i * kPairs + k] = __ldg(row + lanes[i * kPairs + k]);
}

// (c) out[i, j] = x[i, gidx[i, j]]: two rows a block staged in shared
// memory, then a dynamic shared-memory read a lane (take_along_axis).
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ gidx,
                   float* __restrict__ out, int n) {
  __shared__ float rows[kThreads];
  const size_t at = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = at < static_cast<size_t>(n) * kLanes;
  if (live) rows[threadIdx.x] = x[at];
  __syncthreads();
  if (live) out[at] = rows[(threadIdx.x / kLanes) * kLanes + gidx[at]];
}

// (d) table[idx[i], lanes[i, k]] += val[i, k] with atomicAdd, a thread a
// point, as the table-gradient kernel adds its corners.
__global__ void __launch_bounds__(kThreads)
atomic_add_kernel(float* __restrict__ table, const int* __restrict__ idx,
                  const int* __restrict__ lanes, const float* __restrict__ val,
                  int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float* row = table + static_cast<size_t>(idx[i]) * kRow;
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
    atomicAdd(row + lanes[i * kPairs + k], val[i * kPairs + k]);
}

int blocks(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).

int probe_row_gather(const void* table, const int* idx, void* out, int n,
                     void* stream) {
  row_gather_kernel<<<blocks(32LL * n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), idx, static_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int probe_elem_gather(const float* table, const int* idx, const int* lanes,
                      float* out, int n, void* stream) {
  elem_gather_kernel<<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(table, idx, lanes,
                                                            out, n);
  return static_cast<int>(cudaGetLastError());
}

int probe_lane_gather(const float* x, const int* gidx, float* out, int n,
                      void* stream) {
  lane_gather_kernel<<<blocks(static_cast<long long>(n) * kLanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, gidx, out, n);
  return static_cast<int>(cudaGetLastError());
}

int probe_atomic_add(float* table, const int* idx, const int* lanes,
                     const float* val, int n, void* stream) {
  atomic_add_kernel<<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(table, idx, lanes,
                                                           val, n);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
