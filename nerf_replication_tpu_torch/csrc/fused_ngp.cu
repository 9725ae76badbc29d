// Fused brick encode + NGP MLP eval for Hopper (sm_90a): points (N, 3) in
// [0,1], per-point direction features (N, 16) and one branch's weights ->
// raw (N, 4) = [rgb, sigma] f32.
//
// Replaces the TPU Pallas kernel _fused_kernel of fused_ngp_eval
// (nerf_replication_tpu/ops/pallas/fused_ngp.py), both of its arms. As
// there, the encode (csrc/brick_encode.cuh) feeds the MLP without leaving
// the chip, and the skip concat [x, h] and the view concat [feature, sh]
// are split matmuls.
//   f32 arm (the TPU kernel's precision=HIGHEST): every product of the
//     trunk, feature and view layers is 3xTF32 on the tensor cores. Each
//     operand v is split into TF32 parts big = tf32(v), small = tf32(v -
//     big) (to nearest, ties away); a product sums small.big + big.small,
//     then big.big, in f32 accumulators, which keeps about f32's accuracy
//     (the dropped small.small is ~2^-22 of a product). The weights are
//     split on the host, the activations in registers.
//   bf16 arm (mlp_bf16): every weight, bias, activation, feature and SH
//     operand rounded to bf16 (nearest, even), products on the tensor cores
//     with f32 accumulation, as the TPU kernel's bf16 dot_generals.
// The density head (64 -> 1) and the RGB head (32 -> 3) are dot products in
// f32 fmaf (on the bf16 arm's rounded operands), reduced over the four
// lanes that hold a row's columns.
//
// What bounds it: the hard_ngp MLP (D=3, W=64, skip [1], a 32-wide view
// layer) is 18,112 multiply-adds a point against 92 bytes of input and
// output, so the tensor cores: three TF32 products each (0.20 ms at 896,000
// points at 494.7 TFLOP/s), one bf16 product on the bf16 arm; the encode's
// 96-128 table gathers a point come on top. The design: persistent blocks
// of 8 warps, one an SM; the block stages one branch's weight image (145-
// 154 KB on the f32 arm) in shared memory once; a warp takes 32 points at a
// time. Each lane encodes one point into the warp's tile in shared memory,
// with the point's SH; then the warp runs the whole MLP on two m16 row
// blocks, each B fragment it loads from shared memory (one 16-byte load a
// lane) feeding both. Activations stay in the accumulators from layer to
// layer: on the f32 arm an m16n8 accumulator holds columns 2t, 2t + 1 of an
// n8 tile and a k8 A fragment wants columns t, t + 4, so the host permutes
// each group of eight K rows of every matrix that reads an activation as
// [0, 2, 4, 6, 1, 3, 5, 7]; on the bf16 arm two n8 accumulators are one k16
// A fragment as they stand. Biases start the accumulators; ReLU runs on
// them. The ragged tail is masked at the loads and the stores.
//
// Weight image (ops/fused_ngp.py weight_image), 32-bit words in the order
// of the f32 pack (pack_mlp_weights): every matrix that the tensor cores
// read becomes fragments, every vector stays f32 (bf16-rounded on the bf16
// arm):
//   layer 0: W0 (kX, 64), b0 (64)
//   layer i = 1..depth-1: [Wx (kX, 64) if it reads [x, h]], Wh (64, 64), b (64)
//   density head: [ax (KF) if head_split], ah (64), b (1, padded to 4)
//   feature: [Fx (kX, 64) if head_split], Fh (64, 64), b (64)
//   view layer: Vf (64, 32), Vs (16, 32), b (32)
//   RGB head: R (32, 4; column 3 zero), b (4)
// A (K, N) matrix on the f32 arm: [K / 8][N / 8][lane] float4 {big(b0),
// big(b1), small(b0), small(b1)}; on the bf16 arm: [K / 16][N / 16][lane]
// uint4 {b0, b1 of n-tile 2j, b0, b1 of n-tile 2j + 1}. kX, the x rows, is
// KF (24 or 32 encoded features, zero-padded) on the f32 arm and 32 on the
// bf16 arm.

#include <algorithm>
#include <cstdint>

#include "brick_encode.cuh"
#include "launch_cache.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kW = 64;        // MLP width
constexpr int kV = kW / 2;    // view layer width
constexpr int kSH = 16;       // direction features (degree-4 SH)
constexpr int kBias1 = 4;     // the density head's bias, padded
constexpr int kRgb = 4;       // RGB head columns, padded
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;     // points a warp takes at a time: 2 m16 blocks

template <int KF, bool kBf16>
struct Arm {
  static constexpr int kX = kBf16 ? 32 : KF;       // x columns of the tile
  static constexpr int kStride = kX + kSH + 4;     // words a point in it
  // words of a (k, n) matrix in the image
  __host__ __device__ static constexpr int mat(int k, int n) {
    return kBf16 ? k * n / 2 : 2 * k * n;
  }
};

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? mma::round_bf16(v) : v;
}

// acc[rb][nt] = the bias of its columns.
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[2][NT][4],
                                          const float* __restrict__ b, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * nt + 2 * t);
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      acc[rb][nt][0] = v.x;
      acc[rb][nt][1] = v.y;
      acc[rb][nt][2] = v.x;
      acc[rb][nt][3] = v.y;
    }
  }
}

template <int NT>
__device__ __forceinline__ void relu(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rb][nt][i] = fmaxf(acc[rb][nt][i], 0.0f);
}

// acc += A . B for one K block of A (both row blocks) and every n-tile of
// B; `frag` is this lane's first fragment of the block in the image.
template <int NT, bool kBf16>
__device__ __forceinline__ void product(float (&acc)[2][NT][4],
                                        const uint32_t (&big)[2][4],
                                        const uint32_t (&small)[2][4],
                                        const float* __restrict__ frag) {
  if constexpr (kBf16) {
    const uint4* f = reinterpret_cast<const uint4*>(frag);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint4 b = f[32 * j];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        mma::mma_bf16(acc[rb][2 * j], big[rb], b.x, b.y);
        mma::mma_bf16(acc[rb][2 * j + 1], big[rb], b.z, b.w);
      }
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(frag);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = f[32 * nt];
      const uint32_t b0 = __float_as_uint(b.x), b1 = __float_as_uint(b.y);
      const uint32_t s0 = __float_as_uint(b.z), s1 = __float_as_uint(b.w);
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        mma::mma_tf32(acc[rb][nt], small[rb], b0, b1);
        mma::mma_tf32(acc[rb][nt], big[rb], s0, s1);
        mma::mma_tf32(acc[rb][nt], big[rb], b0, b1);
      }
    }
  }
}

// acc += tile[:, col0 : col0 + K] . W, W (K, 8 NT) in the image at w.
template <int K, int NT, bool kBf16>
__device__ __forceinline__ void from_tile(float (&acc)[2][NT][4],
                                          const float* __restrict__ tile,
                                          int stride, int col0,
                                          const float* __restrict__ w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kStep = kBf16 ? 16 : 8;
#pragma unroll
  for (int kb = 0; kb < K / kStep; ++kb) {
    uint32_t big[2][4], small[2][4];
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      const float* r0 = tile + (16 * rb + g) * stride + col0 + kStep * kb;
      const float* r1 = r0 + 8 * stride;
      if constexpr (kBf16) {
        const float2 v0 = *reinterpret_cast<const float2*>(r0 + 2 * t);
        const float2 v1 = *reinterpret_cast<const float2*>(r1 + 2 * t);
        const float2 v2 = *reinterpret_cast<const float2*>(r0 + 2 * t + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(r1 + 2 * t + 8);
        big[rb][0] = mma::pack_bf16(v0.x, v0.y);
        big[rb][1] = mma::pack_bf16(v1.x, v1.y);
        big[rb][2] = mma::pack_bf16(v2.x, v2.y);
        big[rb][3] = mma::pack_bf16(v3.x, v3.y);
      } else {
        mma::split_tf32(r0[t], big[rb][0], small[rb][0]);
        mma::split_tf32(r1[t], big[rb][1], small[rb][1]);
        mma::split_tf32(r0[t + 4], big[rb][2], small[rb][2]);
        mma::split_tf32(r1[t + 4], big[rb][3], small[rb][3]);
      }
    }
    product<NT, kBf16>(acc, big, small,
                       w + (kb * (NT / (kBf16 ? 2 : 1)) * 32 + lane) * 4);
  }
}

// acc += h . W, h an activation of 8 NTIN columns in accumulators, W (8
// NTIN, 8 NT) in the image at w (rows permuted on the f32 arm).
template <int NTIN, int NT, bool kBf16>
__device__ __forceinline__ void from_act(float (&acc)[2][NT][4],
                                         const float (&h)[2][NTIN][4],
                                         const float* __restrict__ w, int lane) {
  if constexpr (kBf16) {
#pragma unroll
    for (int kb = 0; kb < NTIN / 2; ++kb) {
      uint32_t a[2][4];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        const float(&c0)[4] = h[rb][2 * kb];
        const float(&c1)[4] = h[rb][2 * kb + 1];
        a[rb][0] = mma::pack_bf16(c0[0], c0[1]);
        a[rb][1] = mma::pack_bf16(c0[2], c0[3]);
        a[rb][2] = mma::pack_bf16(c1[0], c1[1]);
        a[rb][3] = mma::pack_bf16(c1[2], c1[3]);
      }
      product<NT, true>(acc, a, a, w + (kb * (NT / 2) * 32 + lane) * 4);
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < NTIN; ++kb) {
      uint32_t big[2][4], small[2][4];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        // columns 2t, 2t + 1 of the n-tile stand at K rows t, t + 4 of the
        // permuted block
        const float(&c)[4] = h[rb][kb];
        mma::split_tf32(c[0], big[rb][0], small[rb][0]);
        mma::split_tf32(c[2], big[rb][1], small[rb][1]);
        mma::split_tf32(c[1], big[rb][2], small[rb][2]);
        mma::split_tf32(c[3], big[rb][3], small[rb][3]);
      }
      product<NT, false>(acc, big, small, w + (kb * NT * 32 + lane) * 4);
    }
  }
}

// s[rb][half] += this lane's share of h . v over its columns (row g + 8 half
// of row block rb); v (8 NT) f32.
template <int NT, bool kBf16>
__device__ __forceinline__ void dot_part(float (&s)[2][2],
                                         const float (&h)[2][NT][4],
                                         const float* __restrict__ v, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 m = *reinterpret_cast<const float2*>(v + 8 * nt + 2 * t);
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[rb][half] = fmaf(operand(h[rb][nt][2 * half], kBf16), m.x, s[rb][half]);
        s[rb][half] =
            fmaf(operand(h[rb][nt][2 * half + 1], kBf16), m.y, s[rb][half]);
      }
  }
}

// Sum over the four lanes of a row (t = 0..3), left in all four.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int KF, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
fused_ngp_kernel(const float* __restrict__ pts, const float* __restrict__ sh,
                 float* __restrict__ out, int n,
                 const uint32_t* __restrict__ table, const brick::Levels lv,
                 int n_levels, const float4* __restrict__ image, int n_vec4,
                 int depth, unsigned split_mask, int head_split) {
  using A = Arm<KF, kBf16>;
  constexpr int kX = A::kX, kS = A::kStride;
  extern __shared__ float4 smem[];
  for (int i = threadIdx.x; i < n_vec4; i += kThreads) smem[i] = __ldg(image + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* __restrict__ sw = reinterpret_cast<const float*>(smem);
  float* tile = reinterpret_cast<float*>(smem + n_vec4) + warp * kTile * kS;
  const int tiles = (n + kTile - 1) / kTile;

  for (int ti = blockIdx.x * kWarps + warp; ti < tiles;
       ti += gridDim.x * kWarps) {
    const int base = ti * kTile;
    __syncwarp();   // the previous tile's reads are done
    {
      // this lane's point: its features and SH into row `lane` of the tile
      const int i = base + lane;
      float x[KF];
      float4 s[kSH / 4];
      if (i < n) {
        const float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
        brick::encode_point<KF / 2>(p, table, lv, n_levels, x);
        const float4* s4 =
            reinterpret_cast<const float4*>(sh + static_cast<size_t>(i) * kSH);
#pragma unroll
        for (int q = 0; q < kSH / 4; ++q) s[q] = __ldg(s4 + q);
      } else {
#pragma unroll
        for (int k = 0; k < KF; ++k) x[k] = 0.0f;
#pragma unroll
        for (int q = 0; q < kSH / 4; ++q) s[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float* row = tile + lane * kS;
#pragma unroll
      for (int k = 0; k < KF; k += 2)
        *reinterpret_cast<float2*>(row + k) = make_float2(x[k], x[k + 1]);
#pragma unroll
      for (int k = KF; k < kX; k += 2)
        *reinterpret_cast<float2*>(row + k) = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kSH / 4; ++q)
        reinterpret_cast<float4*>(row + kX)[q] = s[q];
    }
    __syncwarp();

    // layer 0
    const float* __restrict__ w = sw;
    float h[2][8][4];
    init_bias(h, w + A::mat(kX, kW), t);
    from_tile<kX, 8, kBf16>(h, tile, kS, 0, w, lane);
    relu(h);
    w += A::mat(kX, kW) + kW;
    // layers 1..depth-1 of the trunk
    for (int layer = 1; layer < depth; ++layer) {
      const bool split = ((split_mask >> (layer - 1)) & 1u) != 0;
      const float* wx = w;
      if (split) w += A::mat(kX, kW);
      float o[2][8][4];
      init_bias(o, w + A::mat(kW, kW), t);
      if (split) from_tile<kX, 8, kBf16>(o, tile, kS, 0, wx, lane);
      from_act<8, 8, kBf16>(o, h, w, lane);
      relu(o);
      w += A::mat(kW, kW) + kW;
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) h[rb][nt][i] = o[rb][nt][i];
    }

    // density head: [x,] h . a + b
    float sigma[2][2] = {};
    if (head_split) {
#pragma unroll
      for (int j = 0; j < KF / 4; ++j)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            sigma[rb][half] = fmaf(
                operand(tile[(16 * rb + 8 * half + g) * kS + 4 * j + t], kBf16),
                w[4 * j + t], sigma[rb][half]);
      w += KF;
    }
    dot_part<8, kBf16>(sigma, h, w, t);
    w += kW;
    const float b_sigma = w[0];
    w += kBias1;

    // feature layer (no ReLU)
    float f[2][8][4];
    {
      const float* wx = w;
      if (head_split) w += A::mat(kX, kW);
      init_bias(f, w + A::mat(kW, kW), t);
      if (head_split) from_tile<kX, 8, kBf16>(f, tile, kS, 0, wx, lane);
      from_act<8, 8, kBf16>(f, h, w, lane);
      w += A::mat(kW, kW) + kW;
    }

    // view layer: relu(feature . Vf + sh . Vs + b)
    float v[2][4][4];
    init_bias(v, w + A::mat(kW, kV) + A::mat(kSH, kV), t);
    from_act<8, 4, kBf16>(v, f, w, lane);
    w += A::mat(kW, kV);
    from_tile<kSH, 4, kBf16>(v, tile, kS, kX, w, lane);
    w += A::mat(kSH, kV) + kV;
    relu(v);

    // RGB head: v . R + b, R (32, 4) row-major
    float rgb[2][2][3] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float4 r0 = reinterpret_cast<const float4*>(w)[8 * nt + 2 * t];
      const float4 r1 = reinterpret_cast<const float4*>(w)[8 * nt + 2 * t + 1];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float a0 = operand(v[rb][nt][2 * half], kBf16);
          const float a1 = operand(v[rb][nt][2 * half + 1], kBf16);
          float(&c)[3] = rgb[rb][half];
          c[0] = fmaf(a1, r1.x, fmaf(a0, r0.x, c[0]));
          c[1] = fmaf(a1, r1.y, fmaf(a0, r0.y, c[1]));
          c[2] = fmaf(a1, r1.z, fmaf(a0, r0.z, c[2]));
        }
    }
    const float* b_rgb = w + kV * kRgb;

    // lane t writes column t of its rows: r, g, b, sigma
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float c0 = row_sum(rgb[rb][half][0]) + b_rgb[0];
        const float c1 = row_sum(rgb[rb][half][1]) + b_rgb[1];
        const float c2 = row_sum(rgb[rb][half][2]) + b_rgb[2];
        const float s = row_sum(sigma[rb][half]) + b_sigma;
        const int i = base + 16 * rb + 8 * half + g;
        if (i < n) out[4 * i + t] = t == 0 ? c0 : t == 1 ? c1 : t == 2 ? c2 : s;
      }
  }
}

using Kernel = void (*)(const float*, const float*, float*, int,
                        const uint32_t*, const brick::Levels, int,
                        const float4*, int, int, unsigned, int);

template <int KF, bool kBf16>
int launch(const float* pts, const float* sh, float* out, int n,
           const uint32_t* table, const brick::Levels& lv, int n_levels,
           const float* image, int n_words, int depth, unsigned split_mask,
           int head_split, cudaStream_t stream) {
  static nerf::LaunchCache cache;
  const Kernel kernel = fused_ngp_kernel<KF, kBf16>;
  const size_t smem = static_cast<size_t>(n_words) * 4 +
                      static_cast<size_t>(kWarps) * kTile *
                          Arm<KF, kBf16>::kStride * 4;
  int sms = 0;
  if (cudaError_t err = nerf::prepare_launch(cache, kernel, smem, &sms))
    return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  const int blocks = std::min((tiles + kWarps - 1) / kWarps, sms);
  kernel<<<blocks, kThreads, smem, stream>>>(
      pts, sh, out, n, table, lv, n_levels,
      reinterpret_cast<const float4*>(image), n_words / 4, depth, split_mask,
      head_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a CUDA error code (0 on success). `image` is
// the arm's weight image (n_words 32-bit words, 16-byte aligned); n_feat_pad
// the pack's x rows (24 or 32); depth the trunk's layers; bit i - 1 of
// split_mask says trunk layer i reads [x, h]; head_split that the heads do;
// bf16 picks the arm.
int fused_ngp_eval(const float* pts, const float* sh, float* out, int n,
                   const void* table, const brick::Levels* levels,
                   int n_levels, const float* image, int n_words,
                   int n_feat_pad, int depth, unsigned split_mask,
                   int head_split, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || 2 * n_levels > n_feat_pad || depth < 1 || depth > 32 ||
      n_words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_feat_pad == 24)
    return bf16 ? launch<24, true>(pts, sh, out, n, tab, *levels, n_levels,
                                   image, n_words, depth, split_mask,
                                   head_split, s)
                : launch<24, false>(pts, sh, out, n, tab, *levels, n_levels,
                                    image, n_words, depth, split_mask,
                                    head_split, s);
  if (n_feat_pad == 32)
    return bf16 ? launch<32, true>(pts, sh, out, n, tab, *levels, n_levels,
                                   image, n_words, depth, split_mask,
                                   head_split, s)
                : launch<32, false>(pts, sh, out, n, tab, *levels, n_levels,
                                    image, n_words, depth, split_mask,
                                    head_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
