// Fused brick encode + NGP MLP eval for Hopper (sm_90a): points (N, 3) in
// [0,1], per-point direction features (N, 16) and one branch's weights ->
// raw (N, 4) = [rgb, sigma] f32.
//
// Replaces the TPU Pallas kernel _fused_kernel of fused_ngp_eval
// (nerf_replication_tpu/ops/pallas/fused_ngp.py). As there, the encode
// (csrc/brick_encode.cuh) feeds the MLP without leaving the chip, the skip
// concat [x, h] and the view concat [feature, sh] are split matmuls, and
// the MLP is float32 throughout (the TPU kernel's precision=HIGHEST): every
// product is an fmaf on the CUDA cores, never TF32 or bf16 tensor cores.
//
// What bounds it: the hard_ngp MLP (D=3, W=64, skip [1], a 32-wide view
// layer) costs 36,160 FLOP a point against 92 bytes of input and output, so
// the f32 rate of the CUDA cores (67 TFLOP/s on an H100 SXM). The design:
// one branch's weights (~73.6 KB of f32, beyond __constant__'s 64 KB) are
// staged once per block in dynamic shared memory; persistent blocks walk
// over the points, one point a thread, with the features and both
// activation vectors of the current layer in registers (all loops over
// widths are unrolled, so every index is static). Each weight row is read
// as float4 broadcasts (every thread of a warp reads the same address), one
// load for four FMAs. The ragged tail is the loop bound.
//
// Weight pack (ops/fused_ngp.py pack_mlp_weights), f32, every matrix (in,
// out) row-major followed by its bias; x rows padded with zeros to kF:
//   layer 0: W0 (kF, 64), b0 (64)
//   layer i = 1..depth-1: [Wx (kF, 64) if it reads [x, h]], Wh (64, 64), b (64)
//   density head: [ax (kF) if head_split], ah (64), b (1, padded to 4)
//   feature: [Fx (kF, 64) if head_split], Fh (64, 64), b (64)
//   view layer: Vf (64, 32), Vs (16, 32), b (32)
//   RGB head: R (32, 4; column 3 zero), b (4)

#include <algorithm>

#include "brick_encode.cuh"

namespace {

constexpr int kF = 24;        // the pack's x rows: 12 levels x 2 features
constexpr int kW = 64;        // MLP width
constexpr int kV = kW / 2;    // view layer width
constexpr int kSH = 16;       // direction features (degree-4 SH)
constexpr int kRgb = 4;       // RGB head columns, padded
constexpr int kBias1 = 4;     // the density head's bias, padded
constexpr int kThreads = 128;

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

// acc[j] += sum_k in[k] * w[k * OUT + j], k in order.
template <int IN, int OUT>
__device__ __forceinline__ void mac(float (&acc)[OUT], const float (&in)[IN],
                                    const float* __restrict__ w) {
  static_assert(OUT % 4 == 0, "rows are read as float4");
#pragma unroll
  for (int k = 0; k < IN; ++k) {
#pragma unroll
    for (int j = 0; j < OUT; j += 4) {
      const float4 m = *reinterpret_cast<const float4*>(w + k * OUT + j);
      acc[j] = fmaf(in[k], m.x, acc[j]);
      acc[j + 1] = fmaf(in[k], m.y, acc[j + 1]);
      acc[j + 2] = fmaf(in[k], m.z, acc[j + 2]);
      acc[j + 3] = fmaf(in[k], m.w, acc[j + 3]);
    }
  }
}

// acc + sum_k in[k] * w[k], k in order.
template <int IN>
__device__ __forceinline__ float dot(const float (&in)[IN],
                                     const float* __restrict__ w, float acc) {
  static_assert(IN % 4 == 0, "read as float4");
#pragma unroll
  for (int k = 0; k < IN; k += 4) {
    const float4 m = *reinterpret_cast<const float4*>(w + k);
    acc = fmaf(in[k], m.x, acc);
    acc = fmaf(in[k + 1], m.y, acc);
    acc = fmaf(in[k + 2], m.z, acc);
    acc = fmaf(in[k + 3], m.w, acc);
  }
  return acc;
}

template <int N>
__device__ __forceinline__ void add_bias(float (&a)[N],
                                         const float* __restrict__ b,
                                         bool relu) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 m = *reinterpret_cast<const float4*>(b + j);
    a[j] += m.x;
    a[j + 1] += m.y;
    a[j + 2] += m.z;
    a[j + 3] += m.w;
  }
  if (relu) {
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = fmaxf(a[j], 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_ngp_kernel(const float* __restrict__ pts, const float* __restrict__ sh,
                 float* __restrict__ out, int n,
                 const uint32_t* __restrict__ table, const brick::Levels lv,
                 int n_levels, const float* __restrict__ weights,
                 int n_weights, int depth, unsigned split_mask,
                 int head_split) {
  extern __shared__ float4 smem[];
  {
    const float4* __restrict__ src = reinterpret_cast<const float4*>(weights);
    for (int i = threadIdx.x; i < n_weights / 4; i += kThreads)
      smem[i] = __ldg(src + i);
  }
  __syncthreads();
  const float* __restrict__ sw = reinterpret_cast<const float*>(smem);

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    float x[kF];
    brick::encode_point<kF / 2>(p, table, lv, n_levels, x);

    const float* __restrict__ w = sw;
    float h[kW];
    zero(h);
    mac<kF, kW>(h, x, w);
    w += kF * kW;
    add_bias(h, w, true);
    w += kW;
    float sigma = 0.0f;
    // layers 1..depth-1 of the trunk, then (layer == depth) the density
    // head and the feature layer, which read the trunk's last output
    for (int layer = 1; layer <= depth; ++layer) {
      const bool head = layer == depth;
      const bool split =
          head ? head_split != 0 : ((split_mask >> (layer - 1)) & 1u) != 0;
      if (head) {
        if (split) {
          sigma = dot<kF>(x, w, sigma);
          w += kF;
        }
        sigma = dot<kW>(h, w, sigma);
        w += kW;
        sigma += w[0];
        w += kBias1;
      }
      float o[kW];
      zero(o);
      if (split) {
        mac<kF, kW>(o, x, w);
        w += kF * kW;
      }
      mac<kW, kW>(o, h, w);
      w += kW * kW;
      add_bias(o, w, !head);   // the feature layer has no ReLU
      w += kW;
#pragma unroll
      for (int j = 0; j < kW; ++j) h[j] = o[j];
    }

    float s[kSH];
    const float4* __restrict__ s4 =
        reinterpret_cast<const float4*>(sh + static_cast<size_t>(i) * kSH);
#pragma unroll
    for (int q = 0; q < kSH / 4; ++q) {
      const float4 v = __ldg(s4 + q);
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
    float g[kV];
    zero(g);
    mac<kW, kV>(g, h, w);
    w += kW * kV;
    mac<kSH, kV>(g, s, w);
    w += kSH * kV;
    add_bias(g, w, true);
    w += kV;
    float rgb[kRgb];
    zero(rgb);
    mac<kV, kRgb>(rgb, g, w);
    w += kV * kRgb;
    add_bias(rgb, w, false);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(rgb[0], rgb[1], rgb[2], sigma);
  }
}

int launch(const float* pts, const float* sh, float* out, int n,
           const uint32_t* table, const brick::Levels& lv, int n_levels,
           const float* weights, int n_weights, int depth,
           unsigned split_mask, int head_split, cudaStream_t stream) {
  const auto kernel = fused_ngp_kernel;
  const int smem = n_weights * static_cast<int>(sizeof(float));
  if (int err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  int device = 0, sms = 0, per_sm = 0;
  if (int err = cudaGetDevice(&device)) return err;
  if (int err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device))
    return err;
  if (int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem))
    return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min((n + kThreads - 1) / kThreads, per_sm * sms);
  kernel<<<blocks, kThreads, smem, stream>>>(pts, sh, out, n, table, lv,
                                             n_levels, weights, n_weights,
                                             depth, split_mask, head_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a CUDA error code (0 on success). n_feat_pad
// is the pack's x rows (kF); depth the trunk's layers; bit i - 1 of
// split_mask says trunk layer i reads [x, h]; head_split that the heads do.
int fused_ngp_eval(const float* pts, const float* sh, float* out, int n,
                   const void* table, const brick::Levels* levels,
                   int n_levels, const float* weights, int n_weights,
                   int n_feat_pad, int depth, unsigned split_mask,
                   int head_split, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || 2 * n_levels > n_feat_pad || depth < 1 || depth > 32 ||
      n_weights % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_feat_pad != kF) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pts, sh, out, n, static_cast<const uint32_t*>(table), *levels,
                n_levels, weights, n_weights, depth, split_mask, head_split,
                static_cast<cudaStream_t>(stream));
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
