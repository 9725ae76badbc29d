// D-NeRF's deformation MLP Psi_t for Hopper (sm_90a), forward and backward:
// dx = Psi_t(gamma(x) | gamma(t)) from the raw points and times, and the f32
// gradients of its packed weights and biases from the cotangent of dx. No
// TPU kernel computes Psi_t (the JAX package runs it in XLA); these take the
// place of PyTorch's GEMMs, joins, casts and autograd on the training path
// (ops/deform_mlp.py).
//
// Psi_t is the canonical MLP's kind of network, so the kernels are built on
// its tile core (nerf_mlp_tile.cuh, mlp_bwd_tile.cuh): an 8 x 256 ReLU trunk
// on wgmma with gamma(x) re-joined into layer skip + 1, persistent blocks of
// 128 points, the weights streamed through a shared-memory ring by bulk
// copies, the epilogues on registers. It differs in three places:
// * its input is encoded in the kernel, gamma(x) into the x tile (63 -> 64
//   columns) and gamma(t) into the v tile (1 + 2 time_freqs -> 32), and
//   layer 0 is x . W0x + v . W0t (forward_tile's kDeform pass);
// * the trunk is all of it: no density, feature or view layer;
// * the head is 256 -> 3 (padded to 16 columns), bf16 operands and an f32
//   product and output: dx is not rounded.
//
// Weight pack (bf16, row-major (in, out), in order): W0x [64 x 256], W0t
// [32 x 256]; for i in 1..depth-1: (i == skip + 1: W_ix [64 x 256]), W_i
// [256 x 256]; W_out [256 x 16] (columns 3..15 zero). Bias pack (f32):
// b_0..b_{depth-1} [256 each]; b_out [16, first 3 used]. The forward image
// has every matrix in slabs of at most 64 rows (W0t one slab of 32, W_out
// one of 256), each [k / 8][n / 8][n % 8][k % 8]; the transposed image has
// W_i^T (i >= 1) in slabs of 64 rows and the rest as in the pack, W_out
// among it, whose first three columns the backward reads as they are.
// ops/deform_mlp.py builds the packs and images.
//
// Backward, on #5's design (fused_nerf_mlp_bwd.cu):
// 1. delta: each consumer warpgroup encodes its 64 rows again, recomputes
//    the trunk (ReLU masks kept on chip as bits) and walks the deltas back
//    down it. The head's path into the trunk, d_h = g . W_out^T, is a K = 3
//    product: f32 on registers while the last activation's copy drains,
//    then masked, summed for b_{depth-1} in f32 and rounded once to bf16 by
//    the delta epilogue. The bf16 planes h_0..h_{depth-1}, x, v,
//    d_0..d_{depth-1} and d_out = bf16(g) (16 columns) leave for a
//    tile-order workspace by bulk copies (4,208 bf16 columns a point at
//    depth 8). p and t carry no gradient, so W0x, W0t and W_ix pass no delta
//    on.
// 2. weight gradient (the shared body, mlp_bwd_tile.cuh): x^T . d_0,
//    v^T . d_0, h_{i-1}^T . d_i, x^T . d_{skip+1}, h_{depth-1}^T . d_out,
//    f32 partials a chunk of points.
// 3. reduce: the weight and bias partials summed in a fixed order.
//
// The encoding (mlp_encode.cuh) uses the precise sincosf, so this file must
// never be built with --use_fast_math.

#include "mlp_bwd_tile.cuh"
#include "mlp_encode.cuh"

namespace {

using namespace nerf;

constexpr int kOutCols = 16;       // the head, padded (3 used)
constexpr int kFwdStages = 4;      // 128 KB of weight ring: turns, as #1's
constexpr int kBwdStages = 3;      // 96 KB: the mask bits take the fourth's

// Offsets into the packs (elements).
__host__ __device__ inline size_t dw_trunk_offset(int i, int skip) {
  // W_i (the h part for the skip layer), i >= 1: past W0x and W0t
  return static_cast<size_t>(kVDim) * kWidth + w_trunk_offset(i, skip);
}
__host__ __device__ inline size_t dw_out_offset(int depth, int skip) {
  return dw_trunk_offset(depth - 1, skip) +
         static_cast<size_t>(kWidth) * kWidth;
}
__host__ __device__ inline size_t dw_pack_size(int depth, int skip) {
  return dw_out_offset(depth, skip) + static_cast<size_t>(kWidth) * kOutCols;
}
__host__ __device__ inline int db_out_offset(int depth) {
  return depth * kWidth;
}
__host__ __device__ inline int db_pack_size(int depth) {
  return db_out_offset(depth) + kOutCols;
}

// Producer (one thread): the forward image's slabs of one tile, in the
// order forward_tile's kDeform pass (and, with_head, the head) reads them.
template <int kStages>
__device__ __forceinline__ void produce_deform(Ring<kStages>& ring,
                                               Pipe<kStages>& p,
                                               const bf16* __restrict__ img,
                                               int depth, int skip,
                                               bool with_head) {
  const bf16* w = img;
  produce(ring, p, w, kXDim, kWidth, kSlabK);    // W0x
  w += kXDim * kWidth;
  produce(ring, p, w, kVDim, kWidth, kVDim);     // W0t
  w += kVDim * kWidth;
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      produce(ring, p, w, kXDim, kWidth, kSlabK);
      w += kXDim * kWidth;
    }
    produce(ring, p, w, kWidth, kWidth, kSlabK);
    w += kWidth * kWidth;
  }
  if (with_head) produce(ring, p, w, kWidth, kOutCols, kWidth);
}

// A warpgroup's inputs: gamma(x) of rows row0.. into x, gamma(t) into v.
__device__ __forceinline__ void encode_inputs(const float* __restrict__ pts,
                                              const float* __restrict__ times,
                                              int n, int row0, int xyz_freqs,
                                              int time_freqs, unsigned char* x,
                                              unsigned char* v, int t) {
  encode<3>(pts, n, row0, xyz_freqs, x, kXDim, t);
  encode<1>(times, n, row0, time_freqs, v, kVDim, t);
}

// ---------------------------------------------------------------- forward

struct FwdSmem {
  Ring<kFwdStages> ring;
  alignas(128) unsigned char h[2][kHBytes];   // activations, in place
  alignas(128) unsigned char x[2][kXBytes];   // gamma(x) (skip input too)
  alignas(128) unsigned char v[2][kVBytes];   // gamma(t)
  float bias[2][2 * kWidth];                   // the running layer's biases
};

__global__ void __launch_bounds__(kThreads, 1)
deform_mlp_fwd_kernel(const float* __restrict__ pts,
                      const float* __restrict__ times, float* __restrict__ out,
                      int n, const bf16* __restrict__ img,
                      const float* __restrict__ b, int depth, int skip,
                      int xyz_freqs, int time_freqs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(s.ring);
  __syncthreads();
  const int rounds = tile_rounds((n + kTileM - 1) / kTileM);
  Pipe<kFwdStages> pipe;

  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers)
      for (int k = 0; k < rounds; ++k)
        produce_deform(s.ring, pipe, img, depth, skip, true);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31, bar_id = 1 + wg;
  const float* __restrict__ bo = b + db_out_offset(depth);
  turn_start(pipe, wg);
  for (int k = 0; k < rounds; ++k) {
    const int row0 =
        (static_cast<int>(blockIdx.x + k * gridDim.x)) * kTileM + wg * kWgRows;
    encode_inputs(pts, times, n, row0, xyz_freqs, time_freqs, s.x[wg],
                  s.v[wg], t);
    tile_sync(bar_id);
    float unused[2] = {0.0f, 0.0f};
    forward_tile<kFwdStages, false, false, true>(
        s.ring, pipe, s.h[wg], s.x[wg], s.v[wg], b, s.bias[wg], nullptr,
        depth, skip, nullptr, unused, warp, lane, bar_id, NoHook());
    // the head on the last activations: f32 products of bf16 operands
    float acc[kOutCols / 2] = {};
    bool fresh = true;
    consume<kOutCols>(acc, s.ring, pipe, smem_addr(s.h[wg]), kWidth, kWidth,
                      fresh, lane);
    drain(acc, s.ring, pipe, lane);
    const int q = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // registers 2 half, 2 half + 1: columns 2 q, 2 q + 1
      const int gp = row0 + warp * 16 + (lane >> 2) + 8 * half;
      if (gp >= n || q > 1) continue;
      float* o = out + static_cast<size_t>(gp) * 3 + 2 * q;
      o[0] = acc[2 * half] + bo[2 * q];
      if (q == 0) o[1] = acc[2 * half + 1] + bo[1];
    }
  }
}

// --------------------------------------------------------------- backward

struct DeltaSmem {
  Ring<kBwdStages> ring;
  alignas(128) unsigned char t[2][kHBytes];  // activations, then deltas
  // gamma(x); after the recompute, each warp's f32 column sums
  alignas(128) unsigned char x[2][kXBytes];
  // gamma(t); after the recompute, d_out's tile
  alignas(128) unsigned char v[2][kVBytes];
  float g[kTileM * 4];                       // cotangent tile (3 used a row)
  float bias[2][2 * kWidth];                  // the running layer's biases
  float wo[3][kWidth];                       // W_out^T's rows (bf16 values)
  // and 4 depth * kConsumers mask words
};
static_assert(4 * kWidth * sizeof(float) <= kXBytes, "column sums fit in x");
static_assert(2 * kALbo <= kVBytes, "d_out's tile fits in v");

__host__ __device__ inline size_t delta_smem_bytes(int depth) {
  return sizeof(DeltaSmem) + static_cast<size_t>(4 * depth) * kConsumers * 4;
}

// A consumer warpgroup's share of the delta kernel: its 64 rows of every
// tile the block takes.
__device__ __forceinline__ void deform_delta_tiles(
    DeltaSmem& s, uint32_t* mask_words, Pipe<kBwdStages>& pipe, int rounds,
    const float* __restrict__ pts, const float* __restrict__ times,
    const float* __restrict__ g, int n, int n_pad,
    const float* __restrict__ b, int depth, int skip, int xyz_freqs,
    int time_freqs, bf16* __restrict__ act, bf16* __restrict__ dlt,
    float* __restrict__ bias_part) {
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31, bar_id = 1 + wg;
  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  bf16* x_out = act + depth * plane;                          // 64 columns
  bf16* v_out = x_out + static_cast<size_t>(n_pad) * kXDim;   // 32
  bf16* d_out = dlt + depth * plane;                          // 16
  unsigned char* tile_h = s.t[wg];
  const uint32_t tile_addr = smem_addr(tile_h);
  unsigned char* tail = s.v[wg];   // d_out's tile, after the recompute
  uint32_t* masks = mask_words + tid;
  float* colsum_all = reinterpret_cast<float*>(s.x[wg]);
  float* colsum = colsum_all + warp * kWidth;
  float* gs = s.g + wg * kWgRows * 4;
  const int r_lo = warp * 16 + (lane >> 2);   // this thread's rows: r_lo, + 8
  const int cq = 2 * (lane & 3);
  const int e_b = db_pack_size(depth);
  const TileOut ws{t == 0};
  float unused[2] = {0.0f, 0.0f};   // no density: no sigma, no sig
  turn_start(pipe, wg);

  for (int k = 0; k < rounds; ++k) {
    const int tile = static_cast<int>(blockIdx.x + k * gridDim.x);
    const int row0 = tile * kTileM + wg * kWgRows;
    float* bp = bias_part + static_cast<size_t>(tile * 2 + wg) * e_b;
    encode_inputs(pts, times, n, row0, xyz_freqs, time_freqs, s.x[wg],
                  s.v[wg], t);
    for (int e = t; e < kWgRows * 4; e += kWgThreads) {
      const int r = row0 + (e >> 2), c = e & 3;
      gs[e] = r < n && c < 3 ? g[static_cast<size_t>(r) * 3 + c] : 0.0f;
    }
    ws.read_back();   // the last tile's d_0, before the recompute's layer 0
    tile_sync(bar_id);
    ws.out(x_out + group_at(row0, kXDim), s.x[wg], kXBytes);
    ws.out(v_out + group_at(row0, kVDim), s.v[wg], kVBytes);

    // recompute, keeping every activation in the workspace and its ReLU
    // mask on chip
    forward_tile<kBwdStages, false, true, true>(
        s.ring, pipe, tile_h, s.x[wg], s.v[wg], b, s.bias[wg], nullptr, depth,
        skip, masks, unused, warp, lane, bar_id,
        [&](int l) {
          ws.out(act + l * plane + group_at(row0, kWidth), tile_h, kHBytes);
          // layer l + 1's epilogue overwrites the tile; the last layer's
          // copy drains while the head's path is formed below
          if (l < depth - 1) ws.read_back();
        });

    // d_out: the cotangent's 3 columns, bf16, padded to 16, where gamma(t)
    // was (its copy has read it: the recompute's first read_back)
    {
      const int p = t >> 1, c8 = t & 1;
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        vals[c] = __float2bfloat16_rn(c8 == 0 && c < 3 ? gs[p * 4 + c] : 0.0f);
      *reinterpret_cast<uint4*>(tail + c8 * kALbo + (p >> 3) * kCore +
                                (p & 7) * 16) =
          *reinterpret_cast<const uint4*>(vals);
    }
    if (t < kOutCols) {   // b_out: f32 column sums of the cotangent
      float sum = 0.0f;
      if (t < 3)
        for (int p = 0; p < kWgRows; ++p) sum += gs[p * 4 + t];
      bp[db_out_offset(depth) + t] = sum;
    }

    // the head's path into the trunk, d_h = g . W_out^T (K = 3), in f32 on
    // registers in the accumulator layout
    float acc[kWidth / 2];
    {
      float gr[2][3];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 3; ++c) gr[half][c] = gs[(r_lo + 8 * half) * 4 + c];
#pragma unroll
      for (int j = 0; j < kWidth / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + cq + e;
          const float w0 = s.wo[0][col], w1 = s.wo[1][col], w2 = s.wo[2][col];
#pragma unroll
          for (int half = 0; half < 2; ++half)
            acc[4 * j + 2 * half + e] =
                fmaf(gr[half][2], w2, fmaf(gr[half][1], w1, gr[half][0] * w0));
        }
    }
    ws.read_back();   // h_{depth-1}'s copy has read the tile
    named_barrier(bar_id, kWgThreads);
    delta_epilogue<kWidth, true, false>(acc, masks + 4 * (depth - 1) *
                                                         kConsumers,
                                        unused, nullptr, tile_h, colsum, warp,
                                        lane);
    tile_sync(bar_id);
    ws.out(d_out + group_at(row0, kOutCols), tail, kWgRows * kOutCols * 2);
    bias_out(colsum_all, kWidth, bp + (depth - 1) * kWidth, t);

    // trunk, from the last layer down: d_pre_{i-1} = relu'(h_{i-1}) *
    // (d_pre_i . W_i^T); each plane of deltas goes out to the workspace
    // while the next product's last wgmmas read the same tile
    for (int i = depth - 1; i >= 1; --i) {
      bool fresh = true;
      consume<kWidth>(acc, s.ring, pipe, tile_addr, kWidth, kSlabK, fresh,
                      lane);
      ws.out(dlt + i * plane + group_at(row0, kWidth), tile_h, kHBytes);
      drain(acc, s.ring, pipe, lane);
      ws.read_back();
      named_barrier(bar_id, kWgThreads);
      delta_epilogue<kWidth, true, false>(acc, masks + 4 * (i - 1) *
                                                           kConsumers,
                                          unused, nullptr, tile_h, colsum,
                                          warp, lane);
      tile_sync(bar_id);
      bias_out(colsum_all, kWidth, bp + (i - 1) * kWidth, t);
    }
    ws.out(dlt + group_at(row0, kWidth), tile_h, kHBytes);
    // the next tile's inputs overwrite x (the column sums) and v
    named_barrier(bar_id, kWgThreads);
  }
  // the copies complete before the block's shared memory goes
  if (ws.leader) bulk_wait_all();
}

__global__ void __launch_bounds__(kThreads, 1)
deform_mlp_bwd_delta_kernel(const float* __restrict__ pts,
                            const float* __restrict__ times,
                            const float* __restrict__ g, int n, int n_pad,
                            const bf16* __restrict__ img,
                            const bf16* __restrict__ img_t,
                            const float* __restrict__ b, int depth, int skip,
                            int xyz_freqs, int time_freqs,
                            bf16* __restrict__ act, bf16* __restrict__ dlt,
                            float* __restrict__ bias_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DeltaSmem& s = *reinterpret_cast<DeltaSmem*>(smem_raw);
  uint32_t* mask_words =
      reinterpret_cast<uint32_t*>(smem_raw + sizeof(DeltaSmem));
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(s.ring);
  // W_out's first three columns, as the pack has them in the transposed
  // image: wo[c][k] = W_out[k][c]
  const bf16* __restrict__ w_out = img_t + dw_out_offset(depth, skip);
  for (int e = tid; e < 3 * kWidth; e += kThreads)
    s.wo[e / kWidth][e % kWidth] =
        __bfloat162float(w_out[(e % kWidth) * kOutCols + e / kWidth]);
  __syncthreads();
  const int rounds = tile_rounds(n_pad / kTileM);
  Pipe<kBwdStages> pipe;

  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers)
      for (int k = 0; k < rounds; ++k) {
        produce_deform(s.ring, pipe, img, depth, skip, false);
        for (int i = depth - 1; i >= 1; --i)
          produce(s.ring, pipe, img_t + dw_trunk_offset(i, skip), kWidth,
                  kWidth, kSlabK);
      }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  deform_delta_tiles(s, mask_words, pipe, rounds, pts, times, g, n, n_pad, b,
                     depth, skip, xyz_freqs, time_freqs, act, dlt, bias_part);
}

__global__ void __launch_bounds__(kWgThreadsAll, 1)
deform_mlp_bwd_wgrad_kernel(const __grid_constant__ Products ps, int n_pad,
                            int chunk, long long e_w,
                            float* __restrict__ part) {
  wgrad_blocks(ps, n_pad, chunk, e_w, part);
}

__global__ void __launch_bounds__(kReduceThreads)
deform_mlp_reduce_kernel(const float* __restrict__ in,
                         float* __restrict__ out, int rows, long long e_n,
                         int group) {
  reduce_rows(in, out, rows, e_n, group);
}

// The encodings the kernels take: gamma(x) in at most 64 columns, gamma(t)
// in at most 32; a depth whose mask bits fit beside the delta kernel's
// buffers; one skip that feeds a trunk layer.
bool takes(int depth, int skip, int xyz_freqs, int time_freqs) {
  return xyz_freqs >= 0 && 3 * (1 + 2 * xyz_freqs) <= kXDim &&
         time_freqs >= 0 && 1 + 2 * time_freqs <= kVDim && depth >= 2 &&
         skip >= 0 && skip < depth - 1 &&
         delta_smem_bytes(depth) <= 232448 && depth + 4 <= kMaxProducts;
}

LaunchCache fwd_cache, delta_cache, wgrad_cache;

}  // namespace

extern "C" {

// Dynamic shared memory of a block of the forward kernel, of the delta
// kernel at this depth, and of the weight-gradient kernel.
int fused_deform_mlp_smem_bytes() { return static_cast<int>(sizeof(FwdSmem)); }
int fused_deform_mlp_bwd_delta_smem_bytes(int depth) {
  return static_cast<int>(delta_smem_bytes(depth));
}

// dx (n, 3) f32 of the points pts (n, 3) f32 at times (n,) f32, on `stream`;
// img the forward image of the bf16 weight pack, b the f32 bias pack.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
int fused_deform_mlp(const float* pts, const float* times, float* out, int n,
                     const void* img, const float* b, int depth, int skip,
                     int xyz_freqs, int time_freqs, void* stream) {
  if (n <= 0) return 0;
  if (!takes(depth, skip, xyz_freqs, time_freqs))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (cudaError_t err = prepare_launch(fwd_cache, deform_mlp_fwd_kernel,
                                       sizeof(FwdSmem), &sms))
    return static_cast<int>(err);
  const int tiles = (n + kTileM - 1) / kTileM;
  deform_mlp_fwd_kernel<<<tiles < sms ? tiles : sms, kThreads, sizeof(FwdSmem),
                          static_cast<cudaStream_t>(stream)>>>(
      pts, times, out, n, static_cast<const bf16*>(img), b, depth, skip,
      xyz_freqs, time_freqs);
  return static_cast<int>(cudaGetLastError());
}

// Gradients of the packed f32 weights (grad_w, e_w elements) and biases
// (grad_b, e_b) on `stream`, from the points pts (n, 3), their times (n,)
// and g (n, 3) f32, the cotangent of dx; img and img_t the forward and
// transposed images of the bf16 weight pack.
// Workspaces (the caller sizes them, see ops/deform_mlp.py), tile-order
// planes of the columns named:
//   act bf16 h_0 .. h_{depth-1} (256 each), x (64), v (32)
//   dlt bf16 d_0 .. d_{depth-1} (256 each), d_out (16)
//   part_w f32 ceil(n_pad / chunk) * e_w, tmp_w ceil(that / group_w) * e_w
//   part_b f32 (n_pad / 64) * e_b, tmp_b ceil(that / group_b) * e_b
// Returns cudaGetLastError() of the last launch, or cudaErrorInvalidValue
// for arguments the kernels do not take.
int fused_deform_mlp_bwd(const float* pts, const float* times, const float* g,
                         int n, int n_pad, const void* img, const void* img_t,
                         const float* b, int depth, int skip, int xyz_freqs,
                         int time_freqs, void* act, void* dlt, float* part_w,
                         float* tmp_w, float* part_b, float* tmp_b,
                         float* grad_w, float* grad_b, long long e_w,
                         long long e_b, int chunk, int group_w, int group_b,
                         void* stream) {
  if (n <= 0 || n_pad % kTileM != 0 || n_pad < n ||
      chunk % kWgPoints != 0 || !takes(depth, skip, xyz_freqs, time_freqs) ||
      static_cast<long long>(dw_pack_size(depth, skip)) != e_w ||
      db_pack_size(depth) != e_b || group_w < 1 || group_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* actb = static_cast<bf16*>(act);
  bf16* dltb = static_cast<bf16*>(dlt);

  // persistent blocks, one an SM, or fewer when there are fewer tiles
  const size_t smem = delta_smem_bytes(depth);
  int sms = 0;
  cudaError_t err = prepare_launch(delta_cache, deform_mlp_bwd_delta_kernel,
                                   smem, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n_pad / kTileM;
  deform_mlp_bwd_delta_kernel<<<tiles < sms ? tiles : sms, kThreads, smem,
                                st>>>(
      pts, times, g, n, n_pad, static_cast<const bf16*>(img),
      static_cast<const bf16*>(img_t), b, depth, skip, xyz_freqs, time_freqs,
      actb, dltb, part_b);
  if ((err = cudaGetLastError())) return static_cast<int>(err);

  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  const bf16* xt = actb + depth * plane;
  const bf16* vt = xt + static_cast<size_t>(n_pad) * kXDim;
  const bf16* d_out = dltb + depth * plane;
  Products ps;
  ps.count = 0;
  int total = 0;
  auto add = [&](const bf16* a, int lda, const bf16* d, int ldd, int k, int m,
                 size_t out_off) {
    Product& p = ps.p[ps.count];
    p.a = a; p.d = d; p.lda = lda; p.ldd = ldd; p.k = k; p.m = m;
    p.out_off = static_cast<long long>(out_off); p.out_ld = m;
    p.alpha_off = -1;
    ps.blocks_begin[ps.count++] = total;
    total += (k + kWgRowsA - 1) / kWgRowsA;
  };
  add(xt, kXDim, dltb, kWidth, kXDim, kWidth, 0);
  add(vt, kVDim, dltb, kWidth, kVDim, kWidth,
      static_cast<size_t>(kXDim) * kWidth);
  for (int i = 1; i < depth; ++i) {
    const size_t off = dw_trunk_offset(i, skip);
    if (i == skip + 1)
      add(xt, kXDim, dltb + i * plane, kWidth, kXDim, kWidth,
          off - static_cast<size_t>(kXDim) * kWidth);
    add(actb + (i - 1) * plane, kWidth, dltb + i * plane, kWidth, kWidth,
        kWidth, off);
  }
  add(actb + (depth - 1) * plane, kWidth, d_out, kOutCols, kWidth, kOutCols,
      dw_out_offset(depth, skip));
  ps.blocks_begin[ps.count] = total;

  const int wg_smem = static_cast<int>(sizeof(WgradSmem));
  err = prepare_launch(wgrad_cache, deform_mlp_bwd_wgrad_kernel, wg_smem, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n_pad + chunk - 1) / chunk;
  deform_mlp_bwd_wgrad_kernel<<<dim3(total, chunks), kWgThreadsAll, wg_smem,
                                st>>>(ps, n_pad, chunk, e_w, part_w);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (int e2 = reduce_two_pass(deform_mlp_reduce_kernel, part_w, tmp_w,
                               grad_w, chunks, e_w, group_w, st))
    return e2;
  return reduce_two_pass(deform_mlp_reduce_kernel, part_b, tmp_b, grad_b,
                         n_pad / kWgRows, e_b, group_b, st);
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
