// Canonical NeRF MLP backward for Hopper (sm_90a): f32 gradients of every
// packed weight and bias from the encoded features x, v and the cotangent
// g = dL/d[rgb, sigma] of the (N, 4) output.
//
// Replaces the TPU Pallas kernel _bwd_kernel
// (nerf_replication_tpu/ops/pallas/mlp_train.py:54-145, launched by
// _diff_bwd at :225). On the TPU one core walks the tiles in order and
// carries the weight gradients in VMEM from one grid step to the next
// ("arbitrary" semantics). Hopper's blocks run in parallel and in no order,
// so the work is split into three kernels:
//
// 1. delta (one block per 64-point tile): recomputes the forward with the
//    forward kernel's code and rounding points (nerf_mlp_tile.cuh), then
//    backpropagates g through the heads and the trunk. Each product with a
//    transposed weight takes bf16 deltas and f32 accumulation; the ReLU
//    masks come from the recomputed activations. It writes every bf16
//    activation and bf16 delta that a weight gradient needs into a
//    workspace in device memory (about 10 KB per point), and per-tile f32
//    column sums of the f32 deltas: the bias gradients, which the TPU
//    kernel also sums from f32 deltas.
// 2. weight gradient: dW_l = A_l^T . D_l as bf16 tensor-core products with
//    f32 accumulation, one 64 x 64 output tile per block and one chunk of
//    kChunk points per grid row, into per-chunk f32 partials.
// 3. reduce: the partials summed in a fixed order (two passes), so the
//    result does not depend on how the blocks were scheduled.
//
// What bounds it: the recompute plus the delta chain is twice the forward's
// tensor-core work; the weight-gradient products another forward's worth,
// reading the ~10 KB per point workspace from device memory a few times.
// Keeping activations on chip and wgmma are work for a later version.
//
// The two paths from the heads into the trunk: d_h7 = d_feat . W_feat^T +
// d_sigma . w_alpha^T. The feature part runs on the tensor cores, the
// density part is added in the epilogue as exact bf16 x bf16 products.
// Padding (row 63 of W0/W_ix, rows 27..31 of Wv_d, columns 3..15 of W_rgb,
// b_alpha[1:], b_rgb[3:]) gets exactly zero gradient because the padded
// features and cotangent columns are zero.

#include "nerf_mlp_tile.cuh"

namespace {

using namespace nerf;

constexpr int kChunkAlign = 64;
constexpr int kMaxProducts = 24;
constexpr int kWgThreads = 128;   // 4 warps, each 16 rows of a 64 x 64 tile
constexpr int kReduceThreads = 256;

struct BwdSmem {
  Smem f;                           // forward tile: h, x, v, stage, sigma
  bf16 d[kTileM * kLdH];            // bf16 deltas, the next product's A
  float g[kTileM * 4];              // cotangent tile
};

// f32 deltas of one warp's columns (NT 16-wide fragments, 64 rows) from its
// accumulators: plus, with sig, bf16(sig[row]) * wa[col] (the density head's
// path), times the ReLU mask of `mask` (shared memory, pitch kLdH; none if
// null). Writes bf16 into dst (pitch kLdH) and each column's f32 sum over
// the 64 rows, in a fixed order, to bsum.
template <int NT>
__device__ __forceinline__ void delta_epilogue(
    FragC (&acc)[4][NT], float* stage, int lane, const bf16* mask,
    const float* sig, const bf16* __restrict__ wa, bf16* dst,
    float* __restrict__ bsum) {
  const int c = lane & 15, half = lane >> 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 16 + c;
    const float wcol = sig ? __bfloat162float(wa[col]) : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int rr = 0; rr < 8; ++rr) {
        const int r = half * 8 + rr, row = i * 16 + r;
        float val = stage[r * 16 + c];
        if (sig)
          val += __bfloat162float(__float2bfloat16_rn(sig[row * 4])) * wcol;
        if (mask && !(__bfloat162float(mask[row * kLdH + col]) > 0.0f))
          val = 0.0f;
        sum += val;
        dst[row * kLdH + col] = __float2bfloat16_rn(val);
      }
      __syncwarp();
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (lane < 16) bsum[col] = sum;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
nerf_mlp_bwd_delta_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ v,
                          const float* __restrict__ g, int n, int n_pad,
                          const bf16* __restrict__ w,
                          const float* __restrict__ b, int depth, int skip,
                          bf16* __restrict__ act, bf16* __restrict__ dlt,
                          float* __restrict__ bias_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTileM;
  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  float* stage = s.f.stage + warp * 256;
  float* bp = bias_part + static_cast<size_t>(blockIdx.x) * b_pack_size(depth);
  bf16* d_af = dlt + depth * plane;                          // (n_pad, 272)
  bf16* d_gpre = d_af + static_cast<size_t>(n_pad) * (kWidth + kAlphaPad);
  bf16* d_rgb = d_gpre + static_cast<size_t>(n_pad) * kHalf; // (n_pad, 16)

  load_rows(x, n_pad, row0, kXDim, s.f.x, kLdX, tid);
  load_rows(v, n_pad, row0, kVDim, s.f.v, kLdV, tid);
  for (int e = tid; e < kTileM * 4; e += kThreads)
    s.g[e] = row0 + (e >> 2) < n ? g[static_cast<size_t>(row0) * 4 + e] : 0.0f;
  __syncthreads();

  // recompute, keeping every activation in the workspace
  forward_tile<false>(s.f, w, b, depth, skip, [&](int l) {
    if (l <= depth)
      store_rows(s.f.h, kLdH, kWidth, act + l * plane, kWidth, row0, tid);
    else
      store_rows(s.f.h, kLdH, kHalf, act + (depth + 1) * plane, kHalf, row0,
                 tid);
  });
  // s.f.h now holds the view activations g_act (columns 0..127)

  // d_rgb: the first 3 cotangent columns, bf16, padded to 16
  for (int e = tid; e < kTileM * kRgbCols; e += kThreads) {
    const int p = e >> 4, c = e & 15;
    s.d[p * kLdH + c] = __float2bfloat16_rn(c < 3 ? s.g[p * 4 + c] : 0.0f);
  }
  if (tid < kRgbCols + kAlphaPad) {  // b_rgb and b_alpha: f32 column sums
    const int c = tid < kRgbCols ? tid : 3;
    float sum = 0.0f;
    if (tid < 3 || tid == kRgbCols)
      for (int p = 0; p < kTileM; ++p) sum += s.g[p * 4 + c];
    bp[tid < kRgbCols ? b_rgb_offset(depth) + tid
                      : b_alpha_offset(depth) + tid - kRgbCols] = sum;
  }
  __syncthreads();
  store_rows(s.d, kLdH, kRgbCols, d_rgb, kRgbCols, row0, tid);

  // view layer: d_gpre = relu'(g_act) * (d_rgb . W_rgb^T), 16 columns a warp
  {
    const int nv = warp * 16;
    FragC accv[4][1];
    zero(accv);
    mma_tiles<4, 1, wmma::col_major>(accv, s.d, kLdH,
                                     w + w_rgb_offset(depth, skip) + nv * kRgbCols,
                                     kRgbCols, kRgbCols);
    __syncthreads();
    delta_epilogue<1>(accv, stage, lane, s.f.h + nv, nullptr, nullptr,
                      s.d + nv, bp + b_view_offset(depth) + nv);
    __syncthreads();
    store_rows(s.d, kLdH, kHalf, d_gpre, kHalf, row0, tid);
  }

  const int n0 = warp * 32;
  FragC acc[4][2];
  // feature head: d_feat = d_gpre . Wv_f^T (no ReLU)
  zero(acc);
  mma_tiles<4, 2, wmma::col_major>(acc, s.d, kLdH,
                                   w + w_view_offset(depth, skip) + n0 * kHalf,
                                   kHalf, kHalf);
  __syncthreads();
  delta_epilogue<2>(acc, stage, lane, nullptr, nullptr, nullptr, s.d + n0,
                    bp + b_feat_offset(depth) + n0);
  // s.f.h is free: the last trunk activations, for their ReLU mask
  load_rows(act + (depth - 1) * plane, n_pad, row0, kWidth, s.f.h, kLdH, tid);
  __syncthreads();
  // d_af = [d_feat | d_sigma | 0], all bf16
  store_rows(s.d, kLdH, kWidth, d_af, kWidth + kAlphaPad, row0, tid);
  for (int e = tid; e < kTileM * kAlphaPad; e += kThreads) {
    const int p = e >> 4, c = e & 15;
    d_af[static_cast<size_t>(row0 + p) * (kWidth + kAlphaPad) + kWidth + c] =
        __float2bfloat16_rn(c == 0 ? s.g[p * 4 + 3] : 0.0f);
  }

  // last trunk layer: d_feat . W_feat^T + d_sigma . w_alpha^T, masked
  zero(acc);
  mma_tiles<4, 2, wmma::col_major>(acc, s.d, kLdH,
                                   w + w_feat_offset(depth, skip) + n0 * kWidth,
                                   kWidth, kWidth);
  __syncthreads();
  delta_epilogue<2>(acc, stage, lane, s.f.h + n0, s.g + 3,
                    w + w_alpha_offset(depth, skip) + n0, s.d + n0,
                    bp + (depth - 1) * kWidth + n0);
  __syncthreads();
  store_rows(s.d, kLdH, kWidth, dlt + (depth - 1) * plane, kWidth, row0, tid);

  // trunk: d_pre_{i-1} = relu'(h_{i-1}) * (d_pre_i . W_i^T); the skip
  // layer's input part W_ix takes no delta onward (inputs get none)
  for (int i = depth - 1; i >= 1; --i) {
    load_rows(act + (i - 1) * plane, n_pad, row0, kWidth, s.f.h, kLdH, tid);
    zero(acc);
    mma_tiles<4, 2, wmma::col_major>(acc, s.d, kLdH,
                                     w + w_trunk_offset(i, skip) + n0 * kWidth,
                                     kWidth, kWidth);
    __syncthreads();
    delta_epilogue<2>(acc, stage, lane, s.f.h + n0, nullptr, nullptr,
                      s.d + n0, bp + (i - 1) * kWidth + n0);
    __syncthreads();
    store_rows(s.d, kLdH, kWidth, dlt + (i - 1) * plane, kWidth, row0, tid);
  }
}

// One weight gradient: out[k][m] = sum_n a[n][k] * d[n][m] for k < K, m < M
// (both multiples of 16). Columns m < m_main go to out_off + k * out_ld + m,
// column m_main to out2_off + k when out2_off >= 0; the rest are dropped.
struct Product {
  const bf16* a;
  const bf16* d;
  long long out_off, out2_off;
  int lda, ldd, k, m, out_ld, m_main;
};

struct Products {
  Product p[kMaxProducts];
  int tiles_begin[kMaxProducts + 1];   // prefix sums of 64 x 64 output tiles
  int count;
};

__global__ void __launch_bounds__(kWgThreads)
nerf_mlp_bwd_wgrad_kernel(Products ps, int n_pad, int chunk,
                          long long e_w, float* __restrict__ part) {
  __shared__ __align__(32) float stage_all[kWgThreads / 32][256];
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
      FragAT;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
      FragB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int q = 0;
  while (q + 1 < ps.count && ps.tiles_begin[q + 1] <= static_cast<int>(blockIdx.x))
    ++q;
  const Product& pr = ps.p[q];
  const int local = blockIdx.x - ps.tiles_begin[q];
  const int m_tiles = (pr.m + 63) / 64;
  const int k0 = (local / m_tiles) * 64 + warp * 16;
  const int m_base = (local % m_tiles) * 64;
  if (k0 >= pr.k) return;
  const int nb = blockIdx.y * chunk;
  const int ne = min(n_pad, nb + chunk);

  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int n = nb; n < ne; n += 16) {
    FragAT a;  // A^T: element (k, n) at a[n * lda + k]
    wmma::load_matrix_sync(a, pr.a + static_cast<size_t>(n) * pr.lda + k0,
                           pr.lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m_base + j * 16 >= pr.m) break;
      FragB bfr;
      wmma::load_matrix_sync(
          bfr, pr.d + static_cast<size_t>(n) * pr.ldd + m_base + j * 16,
          pr.ldd);
      wmma::mma_sync(acc[j], a, bfr, acc[j]);
    }
  }
  float* stage = stage_all[warp];
  float* out = part + static_cast<size_t>(blockIdx.y) * e_w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m_base + j * 16 >= pr.m) break;
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int k = k0 + (e >> 4), m = m_base + j * 16 + (e & 15);
      if (m < pr.m_main)
        out[pr.out_off + static_cast<long long>(k) * pr.out_ld + m] = stage[e];
      else if (m == pr.m_main && pr.out2_off >= 0)
        out[pr.out2_off + k] = stage[e];
    }
    __syncwarp();
  }
}

// out[r][e] = sum of in[c][e] over c in [r * group, min(C, (r + 1) * group)),
// in increasing c.
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int rows, long long e_n, int group) {
  const long long e = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (e >= e_n) return;
  const int c0 = blockIdx.y * group, c1 = min(rows, c0 + group);
  float sum = 0.0f;
  for (int c = c0; c < c1; ++c) sum += in[static_cast<size_t>(c) * e_n + e];
  out[static_cast<size_t>(blockIdx.y) * e_n + e] = sum;
}

// in (rows, e_n) -> out (e_n): first into tmp (ceil(rows / group), e_n).
int reduce_two_pass(const float* in, float* tmp, float* out, int rows,
                    long long e_n, int group, cudaStream_t stream) {
  const int mid = (rows + group - 1) / group;
  const unsigned gx = static_cast<unsigned>((e_n + kReduceThreads - 1) /
                                            kReduceThreads);
  reduce_rows_kernel<<<dim3(gx, mid), kReduceThreads, 0, stream>>>(
      in, tmp, rows, e_n, group);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  reduce_rows_kernel<<<dim3(gx, 1), kReduceThreads, 0, stream>>>(
      tmp, out, mid, e_n, mid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Gradients of the packed f32 weights (grad_w, e_w elements) and biases
// (grad_b, e_b) on `stream`. x (n_pad, 64) and v (n_pad, 32) are the bf16
// encoded features with zero rows past n, g (n, 4) f32 the cotangent.
// Workspaces (the caller sizes them, see ops/mlp_train.py):
//   act bf16 (depth + 1) * n_pad * 256 + n_pad * 128
//   dlt bf16 depth * n_pad * 256 + n_pad * (272 + 128 + 16)
//   part_w f32 ceil(n_pad / chunk) * e_w, tmp_w ceil(that / group_w) * e_w
//   part_b f32 (n_pad / 64) * e_b, tmp_b ceil(that / group_b) * e_b
// Returns cudaGetLastError() of the last launch, or cudaErrorInvalidValue
// for arguments the kernels do not take.
int fused_nerf_mlp_bwd(const void* x, const void* v, const float* g, int n,
                       int n_pad, const void* w, const float* b, int depth,
                       int skip, void* act, void* dlt, float* part_w,
                       float* tmp_w, float* part_b, float* tmp_b,
                       float* grad_w, float* grad_b, long long e_w,
                       long long e_b, int chunk, int group_w, int group_b,
                       void* stream) {
  if (n <= 0 || n_pad % kTileM != 0 || n_pad < n || chunk % kChunkAlign != 0 ||
      depth + 5 > kMaxProducts || skip < 0 || skip >= depth - 1 ||
      static_cast<long long>(w_pack_size(depth, skip)) != e_w ||
      b_pack_size(depth) != e_b || group_w < 1 || group_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* actb = static_cast<bf16*>(act);
  bf16* dltb = static_cast<bf16*>(dlt);

  const int smem = static_cast<int>(sizeof(BwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      nerf_mlp_bwd_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n_pad / kTileM;
  nerf_mlp_bwd_delta_kernel<<<tiles, kThreads, smem, st>>>(
      xb, vb, g, n, n_pad, wb, b, depth, skip, actb, dltb, part_b);
  if ((err = cudaGetLastError())) return static_cast<int>(err);

  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  const bf16* d_af = dltb + depth * plane;
  const bf16* d_gpre = d_af + static_cast<size_t>(n_pad) * (kWidth + kAlphaPad);
  const bf16* d_rgb = d_gpre + static_cast<size_t>(n_pad) * kHalf;
  Products ps;
  ps.count = 0;
  int total = 0;
  auto add = [&](const bf16* a, int lda, const bf16* d, int ldd, int k, int m,
                 size_t out_off, int out_ld, int m_main, long long out2_off) {
    Product& p = ps.p[ps.count];
    p.a = a; p.d = d; p.lda = lda; p.ldd = ldd; p.k = k; p.m = m;
    p.out_off = static_cast<long long>(out_off); p.out_ld = out_ld;
    p.m_main = m_main; p.out2_off = out2_off;
    ps.tiles_begin[ps.count++] = total;
    total += ((k + 63) / 64) * ((m + 63) / 64);
  };
  add(xb, kXDim, dltb, kWidth, kXDim, kWidth, 0, kWidth, kWidth, -1);
  for (int i = 1; i < depth; ++i) {
    const size_t off = w_trunk_offset(i, skip);
    if (i == skip + 1)
      add(xb, kXDim, dltb + i * plane, kWidth, kXDim, kWidth,
          off - static_cast<size_t>(kXDim) * kWidth, kWidth, kWidth, -1);
    add(actb + (i - 1) * plane, kWidth, dltb + i * plane, kWidth, kWidth,
        kWidth, off, kWidth, kWidth, -1);
  }
  add(actb + (depth - 1) * plane, kWidth, d_af, kWidth + kAlphaPad, kWidth,
      kWidth + kAlphaPad, w_feat_offset(depth, skip), kWidth, kWidth,
      static_cast<long long>(w_alpha_offset(depth, skip)));
  add(actb + depth * plane, kWidth, d_gpre, kHalf, kWidth, kHalf,
      w_view_offset(depth, skip), kHalf, kHalf, -1);
  add(vb, kVDim, d_gpre, kHalf, kVDim, kHalf, w_view_dir_offset(depth, skip),
      kHalf, kHalf, -1);
  add(actb + (depth + 1) * plane, kHalf, d_rgb, kRgbCols, kHalf, kRgbCols,
      w_rgb_offset(depth, skip), kRgbCols, kRgbCols, -1);
  ps.tiles_begin[ps.count] = total;

  const int chunks = (n_pad + chunk - 1) / chunk;
  nerf_mlp_bwd_wgrad_kernel<<<dim3(total, chunks), kWgThreads, 0, st>>>(
      ps, n_pad, chunk, e_w, part_w);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (int e2 = reduce_two_pass(part_w, tmp_w, grad_w, chunks, e_w, group_w, st))
    return e2;
  return reduce_two_pass(part_b, tmp_b, grad_b, tiles, e_b, group_b, st);
}

}  // extern "C"
