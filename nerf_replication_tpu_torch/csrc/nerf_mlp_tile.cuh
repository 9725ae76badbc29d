// Tile core shared by fused_nerf_mlp.cu (forward) and fused_nerf_mlp_bwd.cu
// (backward): constants, the weight packs and their kernel images, the
// shared-memory weight ring, wgmma products against it, register epilogues
// and the forward pass of one tile.
//
// What bounds it: about 1.19 MFLOP of bf16 tensor-core work a point against
// a few hundred bytes of device memory, so the tensor cores should be the
// limit. What held the first version (wmma, 64-point blocks) far under it
// was the weights: every block re-read the whole 1.19 MB pack from L2
// through fragment loads, and every accumulator went through shared memory
// to be finished. What this design does about it:
//
// * A block takes 128 points: two consumer warpgroups of 64 rows each, and
//   a producer warpgroup of which one thread works; it gives its registers
//   to the consumers (setmaxnreg), whose 128 accumulators a thread would
//   spill otherwise. Blocks are persistent (one an SM) and walk over tiles,
//   so the next tile's weights load during this tile's last layers.
// * Weights reach the tensor cores through a ring of shared-memory stages.
//   The producer thread fills it with 1-D bulk copies (cp.async.bulk,
//   completion on an mbarrier), a K-slab of 64 rows a stage; the consumers
//   hand a stage back through a second mbarrier when the wgmmas that read
//   it have finished. Loads run ahead of the products by the depth of the
//   ring, across layers and tiles.
// * Products are wgmma m64nNk16 (bf16 x bf16 -> f32), A (activations) and B
//   (weights) both from shared memory, K-major, unswizzled core matrices
//   (wgmma.cuh). The host permutes the pack once into that order (the
//   "image", below), so a slab is one contiguous run.
// * The accumulator layout is known, so the epilogues run on registers and
//   write straight into the activation tile, in the core-matrix order the
//   next wgmma reads: bias, ReLU and the bf16 rounding (one cvt a pair), the
//   ReLU bit masks, the density head, the backward's masks and column sums.
//   The layer's f32 biases wait in shared memory, staged a layer ahead.
// * The two warpgroups own disjoint rows of the in-place activation tile,
//   so they never wait for each other's data, and where the ring holds a
//   whole product they take turns at the tensor cores: while one runs its
//   epilogue the other's products run. They meet only in the ring and at
//   the turn.
//
// Numerics follow the TPU kernels: bf16 operands, f32 accumulation, f32
// bias + ReLU, rounded to bf16 before each next product; the density comes
// from f32 sums of bf16 x bf16 products.
//
// The canonical weight pack (bf16 for the kernels, row-major (in, out), in
// order):
//   W0 [64 x 256]; for i in 1..depth-1: (i == skip + 1: W_ix [64 x 256]),
//   W_i [256 x 256]; W_feat [256 x 256]; w_alpha [256];
//   Wv_f [256 x 128]; Wv_d [32 x 128]; W_rgb [128 x 16].
// Bias pack (f32): b_0..b_{depth-1} [256 each]; b_feat [256];
//   b_alpha [16, first used]; b_v [128]; b_rgb [16, first 3 used].
// The kernels read two images of the weight pack, each of the pack's size
// with every matrix at its canonical offset (w_alpha as it is):
//   forward image: matrix W (K x N) as K-slabs of kSlabK rows (the whole K
//     for Wv_d and W_rgb), a slab (Ks x N) ordered
//     [k / 8][n / 8][n % 8][k % 8];
//   transposed image: the same for W^T (N x K), for the matrices the
//     backward multiplies by: W_i (i >= 1), W_feat, Wv_f (slabs of 64 rows)
//     and W_rgb (one slab of 16).
// nerf_replication_tpu_torch/ops/mlp_kernel.py builds the packs and images.
#pragma once

#include <cstddef>
#include <cstdint>

#include "launch_cache.cuh"
#include "wgmma.cuh"

namespace nerf {

typedef __nv_bfloat16 bf16;

constexpr int kTileM = 128;          // points per tile
constexpr int kWgRows = 64;          // rows of one consumer warpgroup
constexpr int kWgThreads = 128;
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kThreads = kConsumers + kWgThreads;  // and the producer's
// registers a thread: all start with 65536 / kThreads rounded down to 8s,
// then the producer warpgroup hands most of its share to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWidth = 256;          // trunk width
constexpr int kHalf = 128;           // view layer width
constexpr int kXDim = 64;            // encoded point features, padded to 16s
constexpr int kVDim = 32;            // encoded direction features, padded
constexpr int kRgbCols = 16;         // RGB head, padded
constexpr int kAlphaPad = 16;        // density-head bias, padded
// weight rows per ring stage (SLAB_K of ops/mlp_kernel.py, which orders the
// images by it)
constexpr int kSlabK = 64;
constexpr int kTurnBar = 3;          // named barriers 3, 4: a warpgroup's turn
constexpr int kStageBytes = kSlabK * kWidth * 2;
constexpr int kCore = 128;           // bytes of a core matrix
// activation tiles of a warpgroup: core matrices ordered [k / 8][row / 8]
constexpr int kALbo = (kWgRows / 8) * kCore;
constexpr int kHBytes = kWgRows * kWidth * 2;
constexpr int kXBytes = kWgRows * kXDim * 2;
constexpr int kVBytes = kWgRows * kVDim * 2;

// Offsets into the packs (elements).
__host__ __device__ inline size_t w_trunk_offset(int i, int skip) {
  // W_i (the h part for the skip layer), i >= 1
  size_t off = static_cast<size_t>(kXDim) * kWidth;
  for (int j = 1; j <= i; ++j) {
    if (j == skip + 1) off += static_cast<size_t>(kXDim) * kWidth;
    if (j < i) off += static_cast<size_t>(kWidth) * kWidth;
  }
  return off;
}
__host__ __device__ inline size_t w_feat_offset(int depth, int skip) {
  return w_trunk_offset(depth - 1, skip) + static_cast<size_t>(kWidth) * kWidth;
}
__host__ __device__ inline size_t w_alpha_offset(int depth, int skip) {
  return w_feat_offset(depth, skip) + static_cast<size_t>(kWidth) * kWidth;
}
__host__ __device__ inline size_t w_view_offset(int depth, int skip) {
  return w_alpha_offset(depth, skip) + kWidth;
}
__host__ __device__ inline size_t w_view_dir_offset(int depth, int skip) {
  return w_view_offset(depth, skip) + static_cast<size_t>(kWidth) * kHalf;
}
__host__ __device__ inline size_t w_rgb_offset(int depth, int skip) {
  return w_view_dir_offset(depth, skip) + static_cast<size_t>(kVDim) * kHalf;
}
__host__ __device__ inline size_t w_pack_size(int depth, int skip) {
  return w_rgb_offset(depth, skip) + static_cast<size_t>(kHalf) * kRgbCols;
}
__host__ __device__ inline int b_feat_offset(int depth) { return depth * kWidth; }
__host__ __device__ inline int b_alpha_offset(int depth) {
  return (depth + 1) * kWidth;
}
__host__ __device__ inline int b_view_offset(int depth) {
  return (depth + 1) * kWidth + kAlphaPad;
}
__host__ __device__ inline int b_rgb_offset(int depth) {
  return b_view_offset(depth) + kHalf;
}
__host__ __device__ inline int b_pack_size(int depth) {
  return b_rgb_offset(depth) + kRgbCols;
}

// The weight ring: kStages slabs, each with a "full" barrier (the bulk
// copy's bytes have landed) and an "empty" one (every consumer warp has
// finished the wgmmas that read it).
template <int kStages>
struct Ring {
  alignas(128) unsigned char buf[kStages][kStageBytes];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int kStages>
__device__ __forceinline__ void ring_init(Ring<kStages>& ring) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&ring.full[s], 1);
    mbar_init(&ring.empty[s], kConsumers / 32);
  }
  mbar_init_fence();
}

// Tiles this block takes: blockIdx.x + k * gridDim.x for k < tile_rounds().
__device__ __forceinline__ int tile_rounds(int tiles) {
  const int first = static_cast<int>(blockIdx.x);
  return first < tiles ? (tiles - first + gridDim.x - 1) / gridDim.x : 0;
}

// A thread's place in the ring. Producer and consumers walk the same
// sequence of slabs, so each keeps its own.
template <int kStages>
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;   // consumers: the stage whose wgmmas were committed last
  int wg = 0;      // consumers: the warpgroup
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer (one thread): the K-slabs of one matrix of an image, (k x n) at
// src, slab_k rows a stage.
template <int kStages>
__device__ __forceinline__ void produce(Ring<kStages>& ring, Pipe<kStages>& p,
                                        const bf16* __restrict__ src, int k,
                                        int n, int slab_k) {
  const uint32_t bytes = static_cast<uint32_t>(slab_k) * n * 2;
  for (int k0 = 0; k0 < k; k0 += slab_k) {
    mbar_wait(&ring.empty[p.stage], p.phase ^ 1);
    mbar_expect_tx(&ring.full[p.stage], bytes);
    bulk_copy(ring.buf[p.stage], src + static_cast<size_t>(k0) * n, bytes,
              &ring.full[p.stage]);
    p.advance();
  }
}

// The forward pass's slabs of one tile, in the order forward_tile (and,
// with_rgb, the RGB head after it) consumes them.
template <int kStages>
__device__ __forceinline__ void produce_forward(Ring<kStages>& ring,
                                                Pipe<kStages>& p,
                                                const bf16* __restrict__ img,
                                                int depth, int skip,
                                                bool with_rgb) {
  const bf16* w = img;
  produce(ring, p, w, kXDim, kWidth, kSlabK);
  w += kXDim * kWidth;
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      produce(ring, p, w, kXDim, kWidth, kSlabK);
      w += kXDim * kWidth;
    }
    produce(ring, p, w, kWidth, kWidth, kSlabK);
    w += kWidth * kWidth;
  }
  produce(ring, p, w, kWidth, kWidth, kSlabK);   // W_feat
  w += kWidth * kWidth + kWidth;                 // and past w_alpha
  produce(ring, p, w, kWidth, kHalf, kSlabK);    // Wv_f
  w += kWidth * kHalf;
  produce(ring, p, w, kVDim, kHalf, kVDim);      // Wv_d
  w += kVDim * kHalf;
  if (with_rgb) produce(ring, p, w, kHalf, kRgbCols, kHalf);
}

// The turn at the tensor cores: warpgroup wg waits on barrier kTurnBar + wg,
// on which the other arrives when it has started its product. Warpgroup 0
// goes first: turn_start() has warpgroup 1 pass once. Turns need a ring that
// holds a whole 256-row product: the warpgroup whose turn it is reads slabs
// the other has yet to read, and the ring can hold no more than kStages of
// those (a smaller ring would have to hand the turn over inside a product,
// which measured no gain).
template <int kStages>
constexpr bool kTurns = kStages * kSlabK >= kWidth;
template <int kStages>
__device__ __forceinline__ void turn_take(const Pipe<kStages>& p) {
  if (kTurns<kStages>) named_barrier(kTurnBar + p.wg, kConsumers);
}
template <int kStages>
__device__ __forceinline__ void turn_pass(const Pipe<kStages>& p) {
  if (kTurns<kStages>) named_barrier_arrive(kTurnBar + 1 - p.wg, kConsumers);
}
template <int kStages>
__device__ __forceinline__ void turn_start(Pipe<kStages>& p, int wg) {
  p.wg = wg;
  if (wg == 1) turn_pass(p);
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  static_assert(N == 256 || N == 128 || N == 16, "instantiated widths");
  if constexpr (N == 256) wgmma_n256<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_n128<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db, scale_d);
}

template <int kStages>
__device__ __forceinline__ void release(Ring<kStages>& ring, int stage,
                                        int lane) {
  if (lane == 0) mbar_arrive(&ring.empty[stage]);
}

// Waits for every wgmma of this thread's warpgroup and hands back the stage
// the last of them read.
template <int kStages>
__device__ __forceinline__ void settle(Ring<kStages>& ring, Pipe<kStages>& p,
                                       int lane) {
  wgmma_wait<0>();
  if (p.prev >= 0) release(ring, p.prev, lane);
  p.prev = -1;
}

// Consumer warpgroup: acc (+)= A[64 x k] . W[k x N] for the next k / slab_k
// slabs of the ring. A is the warpgroup's activation tile at shared address
// a_addr (first k / 8 block). fresh: acc starts from zero; cleared here.
// The last slab's wgmmas are left running: drain() before acc is read. The
// warpgroup holds the turn at the tensor cores while it starts them.
template <int N, int kStages>
__device__ __forceinline__ void consume(float (&acc)[N / 2],
                                        Ring<kStages>& ring, Pipe<kStages>& p,
                                        uint32_t a_addr, int k, int slab_k,
                                        bool& fresh, int lane) {
  constexpr uint32_t kBLbo = (N / 8) * kCore;   // slab: [k / 8][n / 8]
  // never wait for the turn with a slab unreleased: the other warpgroup's
  // next slab may need that stage
  if (kTurns<kStages>) settle(ring, p, lane);
  turn_take(p);
  for (int k0 = 0; k0 < k; k0 += slab_k) {
    mbar_wait(&ring.full[p.stage], p.phase);
    wgmma_fence();
    const uint32_t b_addr = smem_addr(ring.buf[p.stage]);
    for (int kk = 0; kk < slab_k; kk += 16) {
      const uint64_t da =
          make_desc(a_addr + ((k0 + kk) >> 3) * kALbo, kALbo, kCore);
      const uint64_t db = make_desc(b_addr + (kk >> 3) * kBLbo, kBLbo, kCore);
      wgmma<N, 0, 0>(acc, da, db, fresh ? 0 : 1);
      fresh = false;
    }
    wgmma_commit();
    if (p.prev >= 0) {
      wgmma_wait<1>();
      release(ring, p.prev, lane);
    }
    p.prev = p.stage;
    p.advance();
  }
  turn_pass(p);
}

// Waits for every wgmma of this thread's warpgroup; acc may then be read.
template <int kRegs, int kStages>
__device__ __forceinline__ void drain(float (&acc)[kRegs], Ring<kStages>& ring,
                                      Pipe<kStages>& p, int lane) {
  settle(ring, p, lane);
  fence_regs(acc);
}

// After this thread's stores into an activation tile: visible to the
// warpgroup's next wgmmas and generic loads once all 128 threads are here.
__device__ __forceinline__ void tile_sync(int bar_id) {
  fence_async_proxy();
  named_barrier(bar_id, kWgThreads);
}

// Byte offset of this thread's first accumulator element (register 0) in
// the warpgroup's activation tile; register i of column block j = i / 4 and
// row half (i / 2) % 2 lies j * kALbo + half * kCore further on.
__device__ __forceinline__ int acc_tile_offset(int warp, int lane) {
  const int r = warp * 16 + (lane >> 2);
  return (r >> 3) * kCore + (r & 7) * 16 + (lane & 3) * 4;
}

// This thread's two of a layer's n biases, fetched from global memory while
// the layer before runs and put into the warpgroup's shared buffer for the
// layer once that layer's products are started, so no epilogue and no
// product waits for device memory.
__device__ __forceinline__ float2 bias_fetch(const float* __restrict__ b,
                                             int n, int t) {
  return 2 * t < n ? __ldg(reinterpret_cast<const float2*>(b) + t)
                   : make_float2(0.0f, 0.0f);
}
__device__ __forceinline__ void bias_stage(float* bias_s, float2 val, int n,
                                           int t) {
  if (2 * t < n) reinterpret_cast<float2*>(bias_s)[t] = val;
}

// A layer's activations from its accumulators, on registers: f32 bias (from
// shared memory), then (ReLU and) rounding to bf16 in one instruction a
// pair, stored into the warpgroup's tile: the value the next product reads.
// With kMasks, bit i % 32 of word i / 32 of this thread's mask words (stride
// kConsumers) says that the value of register i is positive. With kSigma,
// sigma[half] gains this thread's part of the density head: the f32 sum of
// the rounded activations times w_alpha (wa, shared memory).
template <int N, bool kRelu, bool kMasks, bool kSigma>
__device__ __forceinline__ void act_epilogue(float (&acc)[N / 2],
                                             const float* bias_s,
                                             unsigned char* tile, int warp,
                                             int lane, uint32_t* masks,
                                             const bf16* wa,
                                             float (&sigma)[2]) {
  unsigned char* base = tile + acc_tile_offset(warp, lane);
  const int cq = 2 * (lane & 3);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(bias_s + 8 * j + cq);
    float w0 = 0.0f, w1 = 0.0f;
    if (kSigma) {
      w0 = __bfloat162float(wa[8 * j + cq]);
      w1 = __bfloat162float(wa[8 * j + cq + 1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      const uint32_t pk =
          pack_bf16x2<kRelu>(acc[i] + bj.x, acc[i + 1] + bj.y);
      *reinterpret_cast<uint32_t*>(base + j * kALbo + half * kCore) = pk;
      if (kMasks) {   // after the ReLU a value is positive or zero
        if (pk & 0x7fffu) word |= 1u << (i & 31);
        if (pk & 0x7fff0000u) word |= 1u << ((i + 1) & 31);
      }
      if (kSigma) {
        sigma[half] += __uint_as_float(pk << 16) * w0;
        sigma[half] += __uint_as_float(pk & 0xffff0000u) * w1;
      }
    }
    if (kMasks && (j & 7) == 7) {
      masks[(j >> 3) * kConsumers] = word;
      word = 0;
    }
  }
}

// 16-byte pieces of the warpgroup's tile <-> rows of a row-major bf16 matrix
// in global memory. Piece e of a pass: row e % 8 of row group (e / 32) % 8,
// column block 4 (e / 256) + (e / 8) % 4: a quarter warp touches 128
// contiguous bytes of shared memory, and four lanes 64 contiguous bytes of
// a row in global memory.
struct Piece {
  int row, col8;
  __device__ __forceinline__ explicit Piece(int e)
      : row(((e >> 5) & 7) * 8 + (e & 7)), col8((e >> 8) * 4 + ((e >> 3) & 3)) {}
  __device__ __forceinline__ int tile_offset() const {
    return col8 * kALbo + (row >> 3) * kCore + (row & 7) * 16;
  }
};
__device__ __forceinline__ int piece_count(int cols) {
  return kWgRows * (((cols >> 3) + 3) & ~3);
}

// Rows [row0, row0 + 64) of a row-major bf16 (n, cols) matrix into the
// warpgroup's tile; rows past n are zero. t: thread of the warpgroup.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, int n,
                                          int row0, int cols,
                                          unsigned char* tile, int t) {
  for (int e = t; e < piece_count(cols); e += kWgThreads) {
    const Piece pc(e);
    if (pc.col8 >= (cols >> 3)) continue;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + pc.row < n)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + pc.row) * cols + pc.col8 * 8);
    *reinterpret_cast<uint4*>(tile + pc.tile_offset()) = val;
  }
}

// Columns [0, cols) of the warpgroup's tile into rows [row0, row0 + 64) of a
// row-major bf16 matrix of pitch ldg in global memory.
__device__ __forceinline__ void store_rows(const unsigned char* tile, int cols,
                                           bf16* __restrict__ dst, int ldg,
                                           int row0, int t) {
  for (int e = t; e < piece_count(cols); e += kWgThreads) {
    const Piece pc(e);
    if (pc.col8 >= (cols >> 3)) continue;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + pc.row) * ldg +
                              pc.col8 * 8) =
        *reinterpret_cast<const uint4*>(tile + pc.tile_offset());
  }
}

// The forward pass of one warpgroup's 64 rows, whose encoded inputs are in
// its tiles x and v, through the view layer: afterwards h holds the view
// activations (columns 0..127) and, with kSigma, sigma the raw density of
// this thread's two rows (without b_alpha). after(l) runs once layer l's
// activations are complete in h and visible to the warpgroup (l =
// 0..depth-1 for the trunk, depth for the feature layer, depth + 1 for the
// view layer): while the next layer's last products run, so it may read h
// and must not write it; after(depth + 1) runs last, with nothing in flight.
// With kMasks the ReLU masks of trunk layer l go to words 4 l .. 4 l + 3 of
// this thread's mask words, those of the view layer to words 4 depth,
// 4 depth + 1. bias_s: 2 x kWidth floats of shared memory of the warpgroup's
// own (layer l's biases in half l % 2, staged a layer ahead); wa: w_alpha in
// shared memory.
template <int kStages, bool kSigma, bool kMasks, typename After>
__device__ __forceinline__ void forward_tile(
    Ring<kStages>& ring, Pipe<kStages>& pipe, unsigned char* h,
    const unsigned char* x, const unsigned char* v,
    const float* __restrict__ b, float* bias_s, const bf16* wa, int depth,
    int skip, uint32_t* masks, float (&sigma)[2], int warp, int lane,
    int bar_id, After after) {
  const uint32_t h_addr = smem_addr(h), x_addr = smem_addr(x);
  const int t = warp * 32 + lane;
  // layer l's biases: the trunk's and the feature head's 256 each, then
  // (past b_alpha) the view layer's 128
  auto bias_of = [&](int l) {
    return b + l * kWidth + (l > depth ? kAlphaPad : 0);
  };
  auto slot = [&](int l) { return bias_s + (l & 1) * kWidth; };
  float acc[kWidth / 2] = {};
  bool fresh = true;

  bias_stage(slot(0), bias_fetch(bias_of(0), kWidth, t), kWidth, t);
  named_barrier(bar_id, kWgThreads);
  float2 next = bias_fetch(bias_of(1), kWidth, t);
  consume<kWidth>(acc, ring, pipe, x_addr, kXDim, kSlabK, fresh, lane);
  bias_stage(slot(1), next, kWidth, t);
  drain(acc, ring, pipe, lane);
  act_epilogue<kWidth, true, kMasks, false>(acc, slot(0), h, warp, lane, masks,
                                            nullptr, sigma);
  tile_sync(bar_id);

  for (int i = 1; i < depth; ++i) {
    next = bias_fetch(bias_of(i + 1), kWidth, t);
    fresh = true;
    if (i == skip + 1)   // the [x, h] concat as a split product
      consume<kWidth>(acc, ring, pipe, x_addr, kXDim, kSlabK, fresh, lane);
    consume<kWidth>(acc, ring, pipe, h_addr, kWidth, kSlabK, fresh, lane);
    after(i - 1);
    bias_stage(slot(i + 1), next, kWidth, t);
    drain(acc, ring, pipe, lane);
    // every warp has finished with h (wgmma, after) before it is overwritten
    named_barrier(bar_id, kWgThreads);
    uint32_t* m = masks + 4 * i * kConsumers;
    if (kSigma && i == depth - 1)
      act_epilogue<kWidth, true, kMasks, true>(acc, slot(i), h, warp, lane, m,
                                               wa, sigma);
    else
      act_epilogue<kWidth, true, kMasks, false>(acc, slot(i), h, warp, lane,
                                                m, nullptr, sigma);
    tile_sync(bar_id);
  }
  if (kSigma) {
    // the four lanes that share a row hold its partial sums
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sigma[half] += __shfl_xor_sync(0xffffffffu, sigma[half], 1);
      sigma[half] += __shfl_xor_sync(0xffffffffu, sigma[half], 2);
    }
  }

  // feature head: no ReLU
  next = bias_fetch(bias_of(depth + 1), kHalf, t);
  fresh = true;
  consume<kWidth>(acc, ring, pipe, h_addr, kWidth, kSlabK, fresh, lane);
  after(depth - 1);
  bias_stage(slot(depth + 1), next, kHalf, t);
  drain(acc, ring, pipe, lane);
  named_barrier(bar_id, kWgThreads);
  act_epilogue<kWidth, false, false, false>(acc, slot(depth), h, warp, lane,
                                            nullptr, nullptr, sigma);
  tile_sync(bar_id);

  // view layer: relu(feat . Wv_f + v . Wv_d + b_v)
  float accv[kHalf / 2] = {};
  fresh = true;
  consume<kHalf>(accv, ring, pipe, h_addr, kWidth, kSlabK, fresh, lane);
  consume<kHalf>(accv, ring, pipe, smem_addr(v), kVDim, kVDim, fresh, lane);
  after(depth);
  drain(accv, ring, pipe, lane);
  named_barrier(bar_id, kWgThreads);
  act_epilogue<kHalf, true, kMasks, false>(accv, slot(depth + 1), h, warp, lane,
                                           masks + 4 * depth * kConsumers,
                                           nullptr, sigma);
  tile_sync(bar_id);
  after(depth + 1);
}

}  // namespace nerf
