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
// that carries over. Both give a warp 32 consecutive points at one level.
// The forward (the thread map of csrc/brick_tile.cuh) reads the 16 f32
// entries of a (point, level) (8 corners x 2 features) of the parameter
// table as corner pairs, stages its outputs in shared memory and stores
// them coalesced. The backward adds with atomicAdd (float2 for a pair of
// neighbouring corners where it can) after merging, within the warp, the
// contributions that go to one address.
//
// Numerics are the TPU kernels': on the levels flagged in bf16_levels (at
// most 4096 rows) the forward rounds each table read to bf16 and the
// backward rounds each contribution w * g to bf16 (before any merge), both
// to nearest even; the other levels stay f32; weights and sums are f32.
// Products and sums are rounded one by one in the plain version's order
// (brick_encode.cuh), so the forward equals
// ops/hashgrid_kernel.brick_encode_reference bit for bit. The backward's
// atomic sums come in an order that differs from run to run: it agrees with
// the plain backward to f32 summation order and is not bit-reproducible.
//
// What bounds them: 12 bytes a point in, 8 bytes a level out (forward) or
// in (backward), the touched table entries read or written once and, for
// the backward, the zeroing of the whole dtable, against 57 f32 operations
// a level: device-memory bytes. The gathers spend far more than that: the
// L2 (the hard_ngp table is 35 MB of its 50 MB) serves them in 32-byte
// sectors, and a (point, level)'s 16 entries span ~7 of them. The
// forward's first design gave a thread one (point, level), the level
// running fastest, so the lanes of a load spread over ~3 points and 12
// levels and never shared a sector; now the lanes of a load are 32
// consecutive points of one level, which share sectors on the coarse
// levels, and a lane reads an 8-byte-aligned corner pair in one load. It
// runs at the first design's speed (chip_smoke.py --first): the
// SM's L1 had already served the first design's neighbouring points their
// shared sectors. What sets the time is the table's layout, f0 and f1 of
// a vertex 512 bytes apart: with the two side by side the same kernel ran
// 1.4x faster, but #7, Adam's state and the checkpoint share the layout.
// The backward's first version issued one atomicAdd a contribution (22.0M
// on a 114,688-point batch) and ran at the rate of one index_add_ over
// them: the count of atomics, not their contention, set its time. Points
// come ray-major, so on the coarse levels neighbouring samples of one ray
// share a cell: the warp merge removes those atomics, and a float2 atomic
// adds two corners at once where they are aligned.

#include <cuda_bf16.h>

#include "brick_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 256;   // f32 lanes per table row: f0 at v, f1 at 128 + v

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Corners c and c + 1 (dz = 0, 1) of one feature: two neighbouring floats
// of a row, at p and p + 1. Every lane loads the 8-byte-aligned float2
// that holds p: where p is aligned that is the pair, one sector; where it
// is not, its second value is corner c and one more 4-byte load reads
// corner c + 1.
__device__ __forceinline__ float2 corner_pair(const float* __restrict__ p) {
  const bool odd = reinterpret_cast<uintptr_t>(p) & 4u;
  const float2 v = __ldg(reinterpret_cast<const float2*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t{7}));
  return odd ? make_float2(v.y, __ldg(p + 1)) : v;
}

// Features (f0, f1) of level l at point p, from the f32 training table:
// the plain version's reads, roundings, products and sums.
__device__ __forceinline__ float2 train_level(const float (&p)[3], int l,
                                              const float* __restrict__ table,
                                              const brick::Levels& lv,
                                              uint32_t bf16_levels) {
  const brick::Cell cell =
      brick::locate(p, lv.res[l], lv.offset[l], lv.bside[l], lv.hash_mask[l]);
  const float* __restrict__ row =
      table + static_cast<size_t>(cell.row) * kRow + cell.lane;
  float v0[8], v1[8];
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    const float2 a = corner_pair(row + brick::corner_lane(c));
    const float2 b = corner_pair(row + 128 + brick::corner_lane(c));
    v0[c] = a.x, v0[c + 1] = a.y, v1[c] = b.x, v1[c + 1] = b.y;
  }
  const bool bf16 = (bf16_levels >> l) & 1u;
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = brick::corner_weight(cell, c);
    const float a = bf16 ? round_bf16(v0[c]) : v0[c];
    const float b = bf16 ? round_bf16(v1[c]) : v1[c];
    f0 = __fadd_rn(f0, __fmul_rn(w, a));
    f1 = __fadd_rn(f1, __fmul_rn(w, b));
  }
  return make_float2(f0, f1);
}

// The thread map of csrc/brick_tile.cuh at 32-point tiles and a warp a
// level (blockDim.x = 32 L): each warp takes 32 consecutive points at one
// level, the map of the table gradient below.
constexpr int kFwdTile = 32;

__global__ void __launch_bounds__(kFwdTile * brick::kMaxLevels)
brick_hash_encode_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             float* __restrict__ out, int n,
                             const __grid_constant__ brick::Levels lv,
                             int n_levels, uint32_t bf16_levels) {
  brick::encode_tile<kFwdTile>(x, out, n, n_levels,
                               [&](const float (&p)[3], int l) {
    return train_level(p, l, table, lv, bf16_levels);
  });
}

// Sums v over the lanes of `peers` (the lanes that add to this lane's
// addresses, this one among them) into the group's lowest lane: a pairwise
// tree over the group's lanes in lane order, log2(group size) rounds of
// shuffles. Every lane of the warp takes part.
__device__ __forceinline__ void merge_peers(unsigned peers, int lane,
                                            float (&v)[4]) {
  int rank = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  peers &= ~((2u << lane) - 1u);                    // peers above it
  while (__any_sync(0xffffffffu, peers != 0)) {
    const int next = __ffs(peers) - 1;              // the next peer, or -1
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t[k] = __shfl_sync(0xffffffffu, v[k], next & 31);
    if (next >= 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] += t[k];
    }
    // the odd ranks have handed their sums on: drop them from every mask
    peers &= __ballot_sync(0xffffffffu, (rank & 1) == 0);
    rank >>= 1;
  }
}

// A warp takes 32 consecutive points at one level (blockIdx.y). Points come
// ray-major, so on the coarse levels neighbouring samples of a ray fall in
// one cell. Corners c and c + 1 (dz = 0, 1) sit on neighbouring lanes of a
// row, so they go together: per pair, the lanes that add to the same
// addresses are found (__match_any_sync), their contributions summed by
// shuffles, and one lane a group adds them, as one float2 atomicAdd a
// feature where the pair is 8-byte aligned, else as two.
__global__ void __launch_bounds__(kThreads)
brick_hash_encode_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ g, long long g_stride0,
                             long long g_stride1, float* __restrict__ dtable,
                             int n, const brick::Levels lv,
                             uint32_t bf16_levels) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;   // the others take part in the warp's merges
  brick::Cell cell{};
  float g0 = 0.0f, g1 = 0.0f;
  if (live) {
    const float p[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
    cell = brick::locate(p, lv.res[l], lv.offset[l], lv.bside[l],
                         lv.hash_mask[l]);
    const float* gi = g + i * g_stride0 + 2 * l * g_stride1;
    g0 = gi[0];
    g1 = gi[g_stride1];
  }
  const bool bf16 = (bf16_levels >> l) & 1u;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    // feature 0 of corners c, c + 1, then feature 1 of both
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t at = 0xffffffffu;   // corner c's feature-0 index in dtable
    if (live) {
      const float w0 = brick::corner_weight(cell, c);
      const float w1 = brick::corner_weight(cell, c + 1);
      v[0] = __fmul_rn(w0, g0);
      v[1] = __fmul_rn(w1, g0);
      v[2] = __fmul_rn(w0, g1);
      v[3] = __fmul_rn(w1, g1);
      if (bf16) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = round_bf16(v[k]);
      }
      at = cell.row * kRow + cell.lane + brick::corner_lane(c);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, at);
    merge_peers(peers, lane, v);
    const bool leader = live && (peers & ((1u << lane) - 1u)) == 0;
    if (leader && (at & 1u) == 0) {
      atomicAdd(reinterpret_cast<float2*>(dtable + at), make_float2(v[0], v[1]));
      atomicAdd(reinterpret_cast<float2*>(dtable + at + 128),
                make_float2(v[2], v[3]));
    } else if (leader) {
      atomicAdd(dtable + at, v[0]);
      atomicAdd(dtable + at + 1, v[1]);
      atomicAdd(dtable + at + 128, v[2]);
      atomicAdd(dtable + at + 129, v[3]);
    }
  }
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the CUDA error code (0 on success).

int brick_hash_encode_fwd(const float* x, const float* table, float* out,
                          int n, const brick::Levels* levels, int n_levels,
                          uint32_t bf16_levels, void* stream) {
  if (n_levels < 1 || n_levels > brick::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  brick_hash_encode_fwd_kernel<<<(n + kFwdTile - 1) / kFwdTile,
                                 kFwdTile * n_levels,
                                 brick::tile_shared_bytes(kFwdTile, n_levels),
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
  // 32-bit table indices: the merge keys
  if (n_levels < 1 || n_levels > brick::kMaxLevels ||
      table_floats >= 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(dtable, 0, static_cast<size_t>(table_floats) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, n_levels);
  brick_hash_encode_bwd_kernel<<<grid, kThreads, 0, s>>>(
      x, g, g_stride0, g_stride1, dtable, n, *levels, bf16_levels);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
