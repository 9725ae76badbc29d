// Forward-only bricked hash-grid encode for Hopper (sm_90a): x (N, 3) in
// [0,1] and the cell-corner table -> features (N, 2L) f32.
//
// Replaces the TPU Pallas kernels of brick_encode_eval
// (nerf_replication_tpu/ops/pallas/eval_encode.py): _eval_kernel_v2, the
// all-"mxu" lane-parallel variant, and _eval_kernel, which copies rows of
// large levels one by one. Those are two fetch strategies of the TPU's
// memory system for one function; here one design covers both.
//
// What bounds it: per point 12 bytes in and 8 bytes a level out, plus the
// table read once, against ~57 f32 operations a level: device-memory
// bytes. What held the first design (a thread a point, eight 4-byte corner
// loads a level from the packed table, a float2 store a level at a 2L x 4
// byte stride) back was the L2's 32-byte sectors: a level's 8 corners span
// ~3.5 sectors of the packed table, and each warp-wide store touched 32
// sectors for 256 bytes. This design reads the cell-corner table of
// ops/eval_encode.pack_cell_table, where a level's 8 corners are one
// aligned sector (two 16-byte loads, brick::encode_level_cells), takes the
// thread map of csrc/brick_tile.cuh (a warp's lanes are 32 consecutive
// points at one level) and stages the tile's output in shared memory for
// 16-byte stores. The cell table is 4x the packed one (11.3 MB for
// hard_ngp_b9, resident in the 50 MB L2).

#include "brick_tile.cuh"

namespace {

constexpr int kTile = 64;    // points a block
constexpr int kGroups = 2;   // level groups a block: two threads a point

__global__ void __launch_bounds__(kTile * kGroups)
brick_encode_eval_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ cells,
                         float* __restrict__ out, int n,
                         const __grid_constant__ brick::Levels lv,
                         int n_levels) {
  brick::encode_tile<kTile>(x, out, n, n_levels,
                            [&](const float (&p)[3], int l) {
    return brick::encode_level_cells(p, lv.res[l], lv.offset[l], lv.bside[l],
                                     lv.hash_mask[l], cells);
  });
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code (0 on success).
int brick_encode_eval(const float* x, const void* cells, float* out, int n,
                      const brick::Levels* levels, int n_levels,
                      void* stream) {
  if (n_levels < 1 || n_levels > brick::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  brick_encode_eval_kernel<<<(n + kTile - 1) / kTile, kTile * kGroups,
                             brick::tile_shared_bytes(kTile, n_levels),
                             static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint32_t*>(cells), out, n, *levels, n_levels);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
