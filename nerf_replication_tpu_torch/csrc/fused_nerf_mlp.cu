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
// of input (or 192 bytes of bf16 features) and 16 bytes of output, so the
// tensor cores are the limit. The design (nerf_mlp_tile.cuh): persistent
// blocks of two consumer warpgroups and a producer, 128 points a tile, every
// activation kept in shared memory in the order wgmma reads it, the weights
// streamed through a four-stage shared-memory ring by bulk copies that run
// ahead of the products, the epilogues on registers, the warpgroups taking
// turns so that one's epilogue hides under the other's products. Device
// memory sees only the inputs and the (N, 4) result. The two entries differ
// in how a warpgroup's inputs arrive: encoded here into shared memory (one
// precise sincosf per band and dimension), or loaded as bf16 features.
//
// The encoding (mlp_encode.cuh) uses the precise sincosf, so this file must
// never be built with --use_fast_math. Packs, images and numerics:
// nerf_mlp_tile.cuh.

#include "mlp_encode.cuh"

namespace {

using namespace nerf;

constexpr int kStages = 4;   // 128 KB of weight ring: a whole 256-row product

struct Smem {
  Ring<kStages> ring;
  alignas(128) unsigned char h[2][kHBytes];   // activations, in place
  alignas(128) unsigned char x[2][kXBytes];   // encoded points (skip input too)
  alignas(128) unsigned char v[2][kVBytes];   // encoded directions
  float bias[2][2 * kWidth];                   // the running layer's biases
  bf16 wa[kWidth];                            // w_alpha
};

// A consumer warpgroup's share of a block: its 64 rows of every tile the
// block takes, loaded with load(x tile, v tile, first row, thread), through
// the MLP, out = [rgb, sigma].
template <typename Load>
__device__ __forceinline__ void mlp_tiles(Smem& s, Pipe<kStages>& pipe,
                                          int rounds, Load load,
                                          float* __restrict__ out, int n,
                                          const float* __restrict__ b,
                                          int depth, int skip) {
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31, bar_id = 1 + wg;
  const float* __restrict__ br = b + b_rgb_offset(depth);
  turn_start(pipe, wg);
  for (int k = 0; k < rounds; ++k) {
    const int row0 =
        (static_cast<int>(blockIdx.x + k * gridDim.x)) * kTileM + wg * kWgRows;
    load(s.x[wg], s.v[wg], row0, t);
    tile_sync(bar_id);
    float sigma[2] = {0.0f, 0.0f};
    forward_tile<kStages, true, false>(s.ring, pipe, s.h[wg], s.x[wg], s.v[wg],
                                       b, s.bias[wg], s.wa, depth, skip,
                                       nullptr, sigma, warp, lane, bar_id,
                                       NoHook());
    // RGB head on the view activations; out = [rgb, sigma]
    float accr[kRgbCols / 2] = {};
    bool fresh = true;
    consume<kRgbCols>(accr, s.ring, pipe, smem_addr(s.h[wg]), kHalf, kHalf,
                      fresh, lane);
    drain(accr, s.ring, pipe, lane);
    const int q = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gp = row0 + warp * 16 + (lane >> 2) + 8 * half;
      if (gp >= n || q > 1) continue;
      // registers 2 half, 2 half + 1: columns 2 q, 2 q + 1
      float2 val;
      val.x = accr[2 * half] + br[2 * q];
      val.y = q == 0 ? accr[2 * half + 1] + br[1]
                     : sigma[half] + b[b_alpha_offset(depth)];
      *reinterpret_cast<float2*>(out + static_cast<size_t>(gp) * 4 + 2 * q) =
          val;
    }
  }
}

// One block: a thread of the producer warpgroup streams the weight image
// for every tile the block takes; the consumer warpgroups run mlp_tiles.
template <typename Load>
__device__ __forceinline__ void mlp_block(Load load, float* __restrict__ out,
                                          int n, const bf16* __restrict__ img,
                                          const float* __restrict__ b,
                                          int depth, int skip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(s.ring);
  if (tid < kWidth) s.wa[tid] = img[w_alpha_offset(depth, skip) + tid];
  __syncthreads();
  const int rounds = tile_rounds((n + kTileM - 1) / kTileM);
  Pipe<kStages> pipe;

  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int k = 0; k < rounds; ++k)
        produce_forward(s.ring, pipe, img, depth, skip, true);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    mlp_tiles(s, pipe, rounds, load, out, n, b, depth, skip);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_mlp_enc_kernel(const float* __restrict__ pts,
                          const float* __restrict__ dirs,
                          float* __restrict__ out, int n,
                          const bf16* __restrict__ img,
                          const float* __restrict__ b, int depth, int skip,
                          int xyz_freqs, int view_freqs) {
  mlp_block(
      [&](unsigned char* x, unsigned char* v, int row0, int t) {
        encode(pts, n, row0, xyz_freqs, x, kXDim, t);
        encode(dirs, n, row0, view_freqs, v, kVDim, t);
      },
      out, n, img, b, depth, skip);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_mlp_kernel(const bf16* __restrict__ xf, const bf16* __restrict__ vf,
                      float* __restrict__ out, int n,
                      const bf16* __restrict__ img,
                      const float* __restrict__ b, int depth, int skip) {
  mlp_block(
      [&](unsigned char* x, unsigned char* v, int row0, int t) {
        load_rows(xf, n, row0, kXDim, x, t);
        load_rows(vf, n, row0, kVDim, v, t);
      },
      out, n, img, b, depth, skip);
}

// Launches `kernel` (whose launches keep `cache`) on n points: persistent
// blocks, one an SM, or fewer when there are fewer tiles. Returns a CUDA
// error code.
template <typename... Params, typename... Args>
int launch(LaunchCache& cache, void (*kernel)(Params...), int n,
           cudaStream_t stream, Args... args) {
  int sms = 0;
  if (cudaError_t err = prepare_launch(cache, kernel, sizeof(Smem), &sms))
    return static_cast<int>(err);
  const int tiles = (n + kTileM - 1) / kTileM;
  kernel<<<tiles < sms ? tiles : sms, kThreads, sizeof(Smem), stream>>>(
      static_cast<Params>(args)...);
  return static_cast<int>(cudaGetLastError());
}

LaunchCache enc_cache, features_cache;

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). img is the
// forward image of the weight pack (nerf_mlp_tile.cuh).
int fused_nerf_mlp_enc(const float* pts, const float* dirs, float* out, int n,
                       const void* img, const float* b, int depth, int skip,
                       int xyz_freqs, int view_freqs, void* stream) {
  if (n <= 0) return 0;
  return launch(enc_cache, fused_nerf_mlp_enc_kernel, n,
                static_cast<cudaStream_t>(stream), pts, dirs, out, n,
                static_cast<const bf16*>(img), b, depth, skip, xyz_freqs,
                view_freqs);
}

// x (n, 64) and v (n, 32) bf16 encoded features, zero-padded columns.
int fused_nerf_mlp(const void* x, const void* v, float* out, int n,
                   const void* img, const float* b, int depth, int skip,
                   void* stream) {
  if (n <= 0) return 0;
  return launch(features_cache, fused_nerf_mlp_kernel, n,
                static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                static_cast<const bf16*>(v), out, n,
                static_cast<const bf16*>(img), b, depth, skip);
}

// Blocks the kernels launch for n points (or minus a CUDA error code).
int fused_nerf_mlp_grid(int n) {
  int sms = 0;
  if (cudaError_t err = prepare_launch(enc_cache, fused_nerf_mlp_enc_kernel,
                                       sizeof(Smem), &sms))
    return -static_cast<int>(err);
  const int tiles = (n + kTileM - 1) / kTileM;
  return tiles < sms ? tiles : sms;
}

// Dynamic shared memory of a block of either kernel.
int fused_nerf_mlp_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
