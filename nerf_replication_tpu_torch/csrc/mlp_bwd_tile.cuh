// Backward pieces shared by fused_nerf_mlp_bwd.cu (#5, the canonical MLP's
// backward) and fused_deform_mlp.cu (the deformation MLP's), on the tile core
// of nerf_mlp_tile.cuh: the delta epilogue and the bias partials of the
// delta kernels, their workspace's tile order and bulk stores, and the
// weight-gradient kernel and the reduction as bodies that each source wraps
// in kernels of its own names (fused_nerf_mlp_bwd.cu describes the design).
#pragma once

#include "nerf_mlp_tile.cuh"

namespace nerf {

constexpr int kMaxProducts = 24;
constexpr int kReduceThreads = 256;

// bf16 deltas of a layer from its accumulators, on registers: plus, with
// kSig, sig[half] * wa[col] (the density head's path; sig is the bf16-rounded
// d_sigma of this thread's two rows), times the ReLU mask bits (words of
// stride kConsumers, see act_epilogue) with kMask. Writes bf16 into the
// warpgroup's tile and the f32 sum of this warp's 16 rows of every column to
// colsum[col].
template <int N, bool kMask, bool kSig>
__device__ __forceinline__ void delta_epilogue(
    float (&acc)[N / 2], const uint32_t* masks, const float (&sig)[2],
    const bf16* wa, unsigned char* tile, float* colsum, int warp, int lane) {
  unsigned char* base = tile + acc_tile_offset(warp, lane);
  const int cq = 2 * (lane & 3);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (kMask && (j & 7) == 0) word = masks[(j >> 3) * kConsumers];
    float w0 = 0.0f, w1 = 0.0f;
    if (kSig) {
      w0 = __bfloat162float(wa[8 * j + cq]);
      w1 = __bfloat162float(wa[8 * j + cq + 1]);
    }
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      float v0 = acc[i], v1 = acc[i + 1];
      if (kSig) {
        v0 += sig[half] * w0;
        v1 += sig[half] * w1;
      }
      if (kMask) {
        if (!((word >> (i & 31)) & 1u)) v0 = 0.0f;
        if (!((word >> ((i + 1) & 31)) & 1u)) v1 = 0.0f;
      }
      s0 += v0;
      s1 += v1;
      *reinterpret_cast<__nv_bfloat162*>(base + j * kALbo + half * kCore) =
          __floats2bfloat162_rn(v0, v1);
    }
#pragma unroll
    for (int step = 4; step < 32; step <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, step);
      s1 += __shfl_xor_sync(0xffffffffu, s1, step);
    }
    if (lane < 4)
      *reinterpret_cast<float2*>(colsum + 8 * j + cq) = make_float2(s0, s1);
  }
}

// The four warps' column sums, in order, to the bias partial of this
// warpgroup. Between two tile_sync()s.
__device__ __forceinline__ void bias_out(const float* colsum, int cols,
                                         float* __restrict__ dst, int t) {
  for (int c = t; c < cols; c += kWgThreads)
    dst[c] = ((colsum[c] + colsum[kWidth + c]) + colsum[2 * kWidth + c]) +
             colsum[3 * kWidth + c];
}

// Element offset of the 64-point group that starts at row0 (a multiple of
// 64) in a tile-order plane of `cols` columns.
__device__ __forceinline__ size_t group_at(int row0, int cols) {
  return static_cast<size_t>(row0) * cols;
}

// The workspace's traffic, moved by one thread of the warpgroup (`leader`):
// out() copies a tile image (or a run of its 8-column blocks) to device
// memory in a bulk group of its own, after the tile_sync() that made the
// tile's writes visible to the async proxy; read_back() waits until every
// such copy has read its source, before the tile is written again (a
// barrier then tells the other threads).
struct TileOut {
  bool leader;
  __device__ __forceinline__ void out(bf16* dst, const unsigned char* src,
                                      int bytes) const {
    if (leader) {
      bulk_store(dst, src, bytes);
      bulk_commit();
    }
  }
  __device__ __forceinline__ void read_back() const {
    if (leader) bulk_wait_read<0>();
  }
};

// One weight gradient: out[k][m] = sum_n a[n][k] * d[n][m] for k < K (a
// multiple of 16) and m < M (256, 128 or 16), to out_off + k * out_ld + m;
// or, with alpha_off >= 0, column 0 alone to alpha_off + k. a and d are
// tile-order planes of lda and ldd columns, each pointer at its first
// column block.
struct Product {
  const bf16* a;
  const bf16* d;
  long long out_off, alpha_off;
  int lda, ldd, k, m, out_ld;
};

struct Products {
  Product p[kMaxProducts];
  int blocks_begin[kMaxProducts + 1];   // prefix sums of 128-row blocks
  int count;
};

constexpr int kWgPoints = 64;                      // points per stage
constexpr int kWgStages = 4;                       // 192 KB of stages
constexpr int kWgRowsA = 128;                      // gradient rows per block
constexpr int kWgABytes = kWgPoints * kWgRowsA * 2;
constexpr int kWgDBytes = kWgPoints * kWidth * 2;
constexpr int kWgStageBytes = kWgABytes + kWgDBytes;
constexpr int kWgThreadsAll = kConsumers + 32;     // and a producer warp
// both operands MN-major: core matrices of 8 points x 8 features, ordered
// [feature / 8][point / 8], as a 64-point group of the workspace is
constexpr int kWgLbo = kCore;                      // next 8 points
constexpr int kWgSbo = (kWgPoints / 8) * kCore;    // next 8 features

struct WgradSmem {
  alignas(128) unsigned char buf[kWgStages][kWgStageBytes];  // A, then D
  uint64_t full[kWgStages];    // a stage's bulk copies have landed
  uint64_t empty[kWgStages];   // every consumer warp has finished with it
};

// The main loop of one block for a product with M = N columns.
template <int N>
__device__ __forceinline__ void wgrad_block(const Product& pr, int ka0, int nb,
                                            int ne, WgradSmem& s,
                                            float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int iters = (ne - nb) / kWgPoints;
  if (tid >= kConsumers) {
    // the producer: stage `it` holds, of the 64-point group at nb + 64 it,
    // A's 8-column blocks from ka0 / 8 on (at most 16) and D's first N / 8,
    // each one contiguous block of its plane
    if (tid != kConsumers) return;
    const uint32_t a_bytes = min(kWgRowsA, pr.k - ka0) * kWgPoints * 2;
    const uint32_t d_bytes = N * kWgPoints * 2;
    const bf16* a = pr.a + static_cast<size_t>(ka0) * kWgPoints;
    Pipe<kWgStages> p;
    for (int it = 0; it < iters; ++it) {
      const size_t p0 = static_cast<size_t>(nb) + it * kWgPoints;
      mbar_wait(&s.empty[p.stage], p.phase ^ 1);
      mbar_expect_tx(&s.full[p.stage], a_bytes + d_bytes);
      bulk_copy(s.buf[p.stage], a + p0 * pr.lda, a_bytes, &s.full[p.stage]);
      bulk_copy(s.buf[p.stage] + kWgABytes, pr.d + p0 * pr.ldd, d_bytes,
                &s.full[p.stage]);
      p.advance();
    }
    return;
  }
  const int wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;

  // A warpgroup whose rows lie past the product's K multiplies whatever the
  // stage holds and stores nothing: the wgmmas stay in uniform code.
  float acc[N / 2] = {};
  Pipe<kWgStages> p;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(&s.full[p.stage], p.phase);
    const uint32_t sa_addr = smem_addr(s.buf[p.stage]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgPoints / 16; ++kk) {
      const uint64_t da =
          make_desc(sa_addr + wg * (kWgRows / 8) * kWgSbo + kk * 2 * kWgLbo,
                    kWgLbo, kWgSbo);
      const uint64_t db = make_desc(sa_addr + kWgABytes + kk * 2 * kWgLbo,
                                    kWgLbo, kWgSbo);
      wgmma<N, 1, 1>(acc, da, db, it > 0 || kk > 0);
    }
    wgmma_commit();
    // the stage before this one is read: back to the producer
    wgmma_wait<1>();
    if (p.prev >= 0 && lane == 0) mbar_arrive(&s.empty[p.prev]);
    p.prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (ka0 + wg * kWgRows >= pr.k) return;

  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = ka0 + wg * kWgRows + warp * 16 + (lane >> 2) + 8 * half;
      const int i = 4 * j + 2 * half;
      if (k >= pr.k) continue;
      if (pr.alpha_off >= 0) {
        if (j == 0 && q == 0) out[pr.alpha_off + k] = acc[i];
      } else {
        *reinterpret_cast<float2*>(out + pr.out_off +
                                   static_cast<long long>(k) * pr.out_ld +
                                   8 * j + 2 * q) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
}

// The body of a weight-gradient kernel of kWgThreadsAll threads a block: a
// block of 128 rows of product ps.p[q] (by blockIdx.x, through
// ps.blocks_begin) over chunk blockIdx.y of the points, its f32 partial to
// part + blockIdx.y * e_w.
__device__ __forceinline__ void wgrad_blocks(const Products& ps, int n_pad,
                                             int chunk, long long e_w,
                                             float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradSmem& s = *reinterpret_cast<WgradSmem*>(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  int q = 0;
  while (q + 1 < ps.count &&
         ps.blocks_begin[q + 1] <= static_cast<int>(blockIdx.x))
    ++q;
  const Product& pr = ps.p[q];
  const int ka0 = (blockIdx.x - ps.blocks_begin[q]) * kWgRowsA;
  const int nb = blockIdx.y * chunk;
  const int ne = min(n_pad, nb + chunk);
  float* out = part + static_cast<size_t>(blockIdx.y) * e_w;
  if (pr.m == kWidth)
    wgrad_block<kWidth>(pr, ka0, nb, ne, s, out);
  else if (pr.m == kHalf)
    wgrad_block<kHalf>(pr, ka0, nb, ne, s, out);
  else
    wgrad_block<kRgbCols>(pr, ka0, nb, ne, s, out);
}

// out[r][e] = sum of in[c][e] over c in [r * group, min(C, (r + 1) * group)),
// in increasing c: the body of a reduction kernel of kReduceThreads threads
// a block, blockIdx.y the output row.
__device__ __forceinline__ void reduce_rows(const float* __restrict__ in,
                                            float* __restrict__ out, int rows,
                                            long long e_n, int group) {
  const long long e = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (e >= e_n) return;
  const int c0 = blockIdx.y * group, c1 = min(rows, c0 + group);
  float sum = 0.0f;
  for (int c = c0; c < c1; ++c) sum += in[static_cast<size_t>(c) * e_n + e];
  out[static_cast<size_t>(blockIdx.y) * e_n + e] = sum;
}

// in (rows, e_n) -> out (e_n): first into tmp (ceil(rows / group), e_n), by
// two launches of `kernel`, a reduction kernel whose body is reduce_rows.
template <typename Kernel>
int reduce_two_pass(Kernel kernel, const float* in, float* tmp, float* out,
                    int rows, long long e_n, int group, cudaStream_t stream) {
  const int mid = (rows + group - 1) / group;
  const unsigned gx = static_cast<unsigned>((e_n + kReduceThreads - 1) /
                                            kReduceThreads);
  kernel<<<dim3(gx, mid), kReduceThreads, 0, stream>>>(in, tmp, rows, e_n,
                                                       group);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  kernel<<<dim3(gx, 1), kReduceThreads, 0, stream>>>(tmp, out, mid, e_n, mid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerf
