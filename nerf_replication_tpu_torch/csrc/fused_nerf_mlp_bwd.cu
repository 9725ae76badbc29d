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
// 1. delta (persistent blocks, 128 points a tile, built on the tile core of
//    nerf_mlp_tile.cuh): each consumer warpgroup recomputes the forward of
//    its 64 rows with the forward kernel's code and rounding points, then
//    backpropagates g through the heads and the trunk, all in one in-place
//    shared-memory tile. Each product with a transposed weight is a wgmma
//    of bf16 deltas against a slab of the transposed weight image, streamed
//    through the same ring as the forward's weights. The epilogues run on
//    registers: the ReLU masks are bits the recompute's epilogue left in
//    shared memory (one bit an activation, read back by the thread that
//    wrote them, because both accumulators have one layout), so no
//    activation is re-read from device memory; the density head's path is
//    added as exact bf16 x bf16 products; the bias gradients are column
//    sums of the f32 deltas, summed in a fixed order (row pairs, a shuffle
//    tree, the four warps in order). Every bf16 activation and delta that a
//    weight gradient needs goes to a workspace in device memory (about 10 KB
//    a point) in the tile's own byte order (below), so each plane of a tile
//    leaves as one bulk copy (cp.async.bulk, shared -> global) that one
//    thread of the warpgroup issues while the next product's last wgmmas
//    run; it waits for the copy to have read the tile before the tile is
//    written again. The encoded x and v go out the same way, in the same order. The
//    ring has three stages (the mask bits take the fourth's room), less
//    than a whole product, so the warpgroups do not take turns.
// 2. weight gradient: dW_l = A_l^T . D_l with the points as the product's K.
//    A block owns 128 rows x up to 256 columns of one gradient for one
//    chunk of points. A 64-point stage of either operand is one contiguous
//    block of the workspace, already in the MN-major core-matrix order the
//    wgmmas read, so a producer warp's one thread loads each with a bulk
//    copy (global -> shared) into a four-stage ring that completes on
//    mbarriers; the consumer warpgroups wait, multiply and hand the stage
//    back. A 256 x 256 gradient reads its A plane once and its D plane
//    twice. f32 partials a chunk.
// 3. reduce: the partials summed in a fixed order (two passes), so the
//    result does not depend on how the blocks were scheduled.
//
// Input gradient (the delta kernel's kDx arm, asked for by a non-null
// grad_x): dL/dx = d_0 . W_0^T + d_{skip+1} . W_{skip+1,x}^T, f32 (n_pad,
// 64). Each product is a wgmma of the bf16 deltas already in the tile
// against the transposed image of W_ix or W_0 (4 slabs of 64 x 64), which
// the producer streams through the ring just before W_{skip+1}^T and just
// after W_1^T. The skip layer's part goes to grad_x from the accumulators;
// the thread that stored it adds d_0's part to it. Without grad_x the
// kernel is the kDx = false instantiation, which has none of this.
//
// Workspace order ("tile order"): a plane of C columns over n_pad points is
// n_pad / 64 groups of 64 points, each the image of a warpgroup's tile,
// core matrices [column / 8][point / 8][point % 8][column % 8]: element
// (p, c) at (p / 64) 64 C + (c / 8) 512 + (p % 64) 8 + c % 8. A group, and
// every run of whole 8-column blocks of it, is one contiguous block.
//
// What bounds it: the recompute plus the delta chain is twice the forward's
// tensor-core work, the weight-gradient products another forward's worth,
// about 3.5 ms at the bf16 peak for a training step's 1,048,576 points. The
// two-kernel split writes the ~10 KB a point workspace once and reads it
// about 1.6 times as issued (D planes of 256-wide gradients twice, the
// second mostly from L2): at least 20.9 GB a step at depth 8, 6.25 ms of
// the card's 3.35 TB/s, above the operations. The bulk copies take that
// traffic off the threads that issue the wgmmas, so stores and loads can
// run under the products.
//
// The two paths from the heads into the trunk: d_h7 = d_feat . W_feat^T +
// d_sigma . w_alpha^T. The feature part runs on the tensor cores, the
// density part is added in the epilogue as exact bf16 x bf16 products.
// Padding (row 63 of W0/W_ix, rows 27..31 of Wv_d, columns 3..15 of W_rgb,
// b_alpha[1:], b_rgb[3:]) gets exactly zero gradient because the padded
// features and cotangent columns are zero; rows past n carry a zero
// cotangent, so all their deltas are zero.

#include "mlp_bwd_tile.cuh"
#include "mlp_encode.cuh"

namespace {

using namespace nerf;

constexpr int kStages = 3;   // 96 KB of weight ring
constexpr int kGradThreads = 256;   // threads of a block of the encoding's
                                    // gradient

// Where a tile's encoded inputs come from: the bf16 features x (n_pad, 64)
// and v (n_pad, 32), zero past n, or, in the encode arm, the f32 points and
// directions (n, 3) and their bands.
struct Inputs {
  const bf16* x;
  const bf16* v;
  const float* pts;
  const float* dirs;
  int xyz_freqs, view_freqs;
};

struct BwdSmem {
  Ring<kStages> ring;
  alignas(128) unsigned char t[2][kHBytes];  // activations, then deltas
  // encoded points; after the recompute, each warp's f32 column sums
  alignas(128) unsigned char x[2][kXBytes];
  // encoded directions; after the recompute, d_rgb's tile and d_af's tail
  alignas(128) unsigned char v[2][kVBytes];
  float g[kTileM * 4];                       // cotangent tile
  float bias[2][2 * kWidth];                  // the running layer's biases
  bf16 wa[kWidth];                           // w_alpha
  // and (4 depth + 2) * kConsumers mask words
};
static_assert(4 * kWidth * sizeof(float) <= kXBytes, "column sums fit in x");
static_assert(4 * kALbo <= kVBytes, "d_rgb and d_af's tail fit in v");

__host__ __device__ inline size_t bwd_smem_bytes(int depth) {
  return sizeof(BwdSmem) + static_cast<size_t>(4 * depth + 2) * kConsumers * 4;
}

// The backward's slabs of one tile after the recompute's, in the order the
// delta chain consumes them, from the transposed image; with kDx, W_ix^T
// before W_{skip+1}^T and W_0^T last (256 x 64 each).
template <bool kDx>
__device__ __forceinline__ void produce_backward(Ring<kStages>& ring,
                                                 Pipe<kStages>& p,
                                                 const bf16* __restrict__ wt,
                                                 int depth, int skip) {
  produce(ring, p, wt + w_rgb_offset(depth, skip), kRgbCols, kHalf, kRgbCols);
  produce(ring, p, wt + w_view_offset(depth, skip), kHalf, kWidth, kSlabK);
  produce(ring, p, wt + w_feat_offset(depth, skip), kWidth, kWidth, kSlabK);
  for (int i = depth - 1; i >= 1; --i) {
    if (kDx && i == skip + 1)
      produce(ring, p, wt + w_trunk_offset(i, skip) - kXDim * kWidth, kWidth,
              kXDim, kSlabK);
    produce(ring, p, wt + w_trunk_offset(i, skip), kWidth, kWidth, kSlabK);
  }
  if (kDx) produce(ring, p, wt, kWidth, kXDim, kSlabK);
}

// The input gradient's part in this thread's accumulators (a 64-column
// product) to rows row0.. of the f32 (n_pad, 64) grad_x; with kAdd added to
// what this thread stored there before.
template <bool kAdd>
__device__ __forceinline__ void dx_out(const float (&acc)[kXDim / 2],
                                       float* __restrict__ dx, int row0,
                                       int warp, int lane) {
  const int r = row0 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kXDim / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      float2* at = reinterpret_cast<float2*>(
          dx + static_cast<size_t>(r + 8 * half) * kXDim + 8 * j + cq);
      float2 val = make_float2(acc[i], acc[i + 1]);
      if (kAdd) {
        const float2 part = *at;
        val.x += part.x;
        val.y += part.y;
      }
      *at = val;
    }
}

// A consumer warpgroup's share of the delta kernel: its 64 rows of every
// tile the block takes, encoded from the points with kEnc; with kDx, their
// input gradient to dx.
template <bool kDx, bool kEnc>
__device__ __forceinline__ void delta_tiles(
    BwdSmem& s, uint32_t* mask_words, Pipe<kStages>& pipe, int rounds,
    const Inputs& in, const float* __restrict__ g, int n, int n_pad,
    const float* __restrict__ b,
    int depth, int skip, bf16* __restrict__ act, bf16* __restrict__ dlt,
    float* __restrict__ bias_part, float* __restrict__ dx) {
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31, bar_id = 1 + wg;
  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  bf16* g_act = act + (depth + 1) * plane;                    // 128 columns
  bf16* x_out = g_act + static_cast<size_t>(n_pad) * kHalf;   // 64
  bf16* v_out = x_out + static_cast<size_t>(n_pad) * kXDim;   // 32
  bf16* d_af = dlt + depth * plane;                           // 272
  bf16* d_gpre = d_af + static_cast<size_t>(n_pad) * (kWidth + kAlphaPad);
  bf16* d_rgb = d_gpre + static_cast<size_t>(n_pad) * kHalf;  // 16
  const bf16* wa = s.wa;
  unsigned char* tile_h = s.t[wg];
  const uint32_t tile_addr = smem_addr(tile_h);
  // after the recompute: d_rgb's tile (2 column blocks), then d_af's last
  // 16 columns [d_sigma | 0] (2 more), staged where v was
  unsigned char* tail = s.v[wg];
  uint32_t* masks = mask_words + tid;
  float* colsum_all = reinterpret_cast<float*>(s.x[wg]);
  float* colsum = colsum_all + warp * kWidth;
  float* gs = s.g + wg * kWgRows * 4;
  const int r_lo = warp * 16 + (lane >> 2);   // this thread's rows: r_lo, + 8
  const TileOut ws{t == 0};
  turn_start(pipe, wg);

  for (int k = 0; k < rounds; ++k) {
    const int tile = static_cast<int>(blockIdx.x + k * gridDim.x);
    const int row0 = tile * kTileM + wg * kWgRows;
    float* bp = bias_part +
                static_cast<size_t>(tile * 2 + wg) * b_pack_size(depth);
    if (kEnc) {
      encode(in.pts, n, row0, in.xyz_freqs, s.x[wg], kXDim, t);
      encode(in.dirs, n, row0, in.view_freqs, s.v[wg], kVDim, t);
    } else {
      load_rows(in.x, n_pad, row0, kXDim, s.x[wg], t);
      load_rows(in.v, n_pad, row0, kVDim, s.v[wg], t);
    }
    for (int e = t; e < kWgRows * 4; e += kWgThreads)
      gs[e] = row0 + (e >> 2) < n ? g[static_cast<size_t>(row0) * 4 + e] : 0.0f;
    ws.read_back();   // the last tile's d_0, before the recompute's layer 0
    tile_sync(bar_id);
    ws.out(x_out + group_at(row0, kXDim), s.x[wg], kXBytes);
    ws.out(v_out + group_at(row0, kVDim), s.v[wg], kVBytes);

    // recompute, keeping every activation in the workspace and its ReLU
    // mask on chip
    float unused[2] = {0.0f, 0.0f};
    forward_tile<kStages, false, true>(
        s.ring, pipe, tile_h, s.x[wg], s.v[wg], b, s.bias[wg], wa, depth,
        skip, masks, unused, warp, lane, bar_id, [&](int l) {
          if (l <= depth) {
            ws.out(act + l * plane + group_at(row0, kWidth), tile_h, kHBytes);
            ws.read_back();   // layer l + 1's epilogue overwrites the tile
          } else {
            ws.out(g_act + group_at(row0, kHalf), tile_h, kWgRows * kHalf * 2);
          }
        });

    // d_rgb: the first 3 cotangent columns, bf16, padded to 16; d_af's
    // tail: d_sigma, padded to 16
    {
      const int p = t >> 1, c8 = t & 1;
      __align__(16) bf16 rgb[8], dsig[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        rgb[c] = __float2bfloat16_rn(c8 == 0 && c < 3 ? gs[p * 4 + c] : 0.0f);
        dsig[c] =
            __float2bfloat16_rn(c8 == 0 && c == 0 ? gs[p * 4 + 3] : 0.0f);
      }
      unsigned char* at = tail + c8 * kALbo + (p >> 3) * kCore + (p & 7) * 16;
      *reinterpret_cast<uint4*>(at) = *reinterpret_cast<const uint4*>(rgb);
      *reinterpret_cast<uint4*>(at + 2 * kALbo) =
          *reinterpret_cast<const uint4*>(dsig);
    }
    if (t < kRgbCols + kAlphaPad) {  // b_rgb and b_alpha: f32 column sums
      const int c = t < kRgbCols ? t : 3;
      float sum = 0.0f;
      if (t < 3 || t == kRgbCols)
        for (int p = 0; p < kWgRows; ++p) sum += gs[p * 4 + c];
      bp[t < kRgbCols ? b_rgb_offset(depth) + t
                      : b_alpha_offset(depth) + t - kRgbCols] = sum;
    }
    tile_sync(bar_id);

    // Each plane of deltas goes out to the workspace while the next
    // product's last wgmmas read the same tile (issued any earlier, the
    // copy's reads of the tile slow the product's: measured).
    // view layer: d_gpre = relu'(g_act) * (d_rgb . W_rgb^T)
    bool fresh = true;
    {
      float accv[kHalf / 2] = {};
      consume<kHalf>(accv, s.ring, pipe, smem_addr(tail), kRgbCols, kRgbCols,
                     fresh, lane);
      ws.out(d_rgb + group_at(row0, kRgbCols), tail, kWgRows * kRgbCols * 2);
      drain(accv, s.ring, pipe, lane);
      ws.read_back();   // g_act's copy has read the tile
      named_barrier(bar_id, kWgThreads);
      delta_epilogue<kHalf, true, false>(accv, masks + 4 * depth * kConsumers,
                                         unused, nullptr, tile_h, colsum, warp,
                                         lane);
    }
    tile_sync(bar_id);
    bias_out(colsum_all, kHalf, bp + b_view_offset(depth), t);

    float acc[kWidth / 2] = {};
    // feature head: d_feat = d_gpre . Wv_f^T (no ReLU)
    fresh = true;
    consume<kWidth>(acc, s.ring, pipe, tile_addr, kHalf, kSlabK, fresh, lane);
    ws.out(d_gpre + group_at(row0, kHalf), tile_h, kWgRows * kHalf * 2);
    drain(acc, s.ring, pipe, lane);
    ws.read_back();
    named_barrier(bar_id, kWgThreads);
    delta_epilogue<kWidth, false, false>(acc, nullptr, unused, nullptr, tile_h,
                                         colsum, warp, lane);
    tile_sync(bar_id);
    bias_out(colsum_all, kWidth, bp + b_feat_offset(depth), t);

    // trunk, from the last layer down: d_pre_{i-1} = relu'(h_{i-1}) *
    // (d_pre_i . W_i^T), where the last layer's input delta is d_feat .
    // W_feat^T + d_sigma . w_alpha^T. The skip layer's input part W_ix
    // passes no delta on into the trunk; with kDx it gives the input
    // gradient's first part, d_{skip+1} . W_ix^T.
    const float sig[2] = {
        __bfloat162float(__float2bfloat16_rn(gs[r_lo * 4 + 3])),
        __bfloat162float(__float2bfloat16_rn(gs[(r_lo + 8) * 4 + 3]))};
    for (int i = depth; i >= 1; --i) {
      if (kDx && i == skip + 1) {
        float accx[kXDim / 2];
        bool fx = true;
        consume<kXDim>(accx, s.ring, pipe, tile_addr, kWidth, kSlabK, fx,
                       lane);
        drain(accx, s.ring, pipe, lane);
        dx_out<false>(accx, dx, row0, warp, lane);
        // the last epilogue's values are spent: accx may take their
        // registers
#pragma unroll
        for (int e = 0; e < kWidth / 2; ++e) acc[e] = 0.0f;
      }
      fresh = true;
      consume<kWidth>(acc, s.ring, pipe, tile_addr, kWidth, kSlabK, fresh,
                      lane);
      if (i == depth) {
        // d_af = [d_feat | d_sigma | 0]: the tile's 32 column blocks, then
        // the staged 2
        bf16* af = d_af + group_at(row0, kWidth + kAlphaPad);
        ws.out(af, tile_h, kHBytes);
        ws.out(af + kWgRows * kWidth, tail + 2 * kALbo,
               kWgRows * kAlphaPad * 2);
      } else {
        ws.out(dlt + i * plane + group_at(row0, kWidth), tile_h, kHBytes);
      }
      drain(acc, s.ring, pipe, lane);
      ws.read_back();
      named_barrier(bar_id, kWgThreads);
      const uint32_t* m = masks + 4 * (i - 1) * kConsumers;
      if (i == depth)
        delta_epilogue<kWidth, true, true>(acc, m, sig, wa, tile_h, colsum,
                                           warp, lane);
      else
        delta_epilogue<kWidth, true, false>(acc, m, sig, nullptr, tile_h,
                                            colsum, warp, lane);
      tile_sync(bar_id);
      bias_out(colsum_all, kWidth, bp + (i - 1) * kWidth, t);
    }
    ws.out(dlt + group_at(row0, kWidth), tile_h, kHBytes);
    if (kDx) {   // the input gradient's second part, d_0 . W_0^T
      float accx[kXDim / 2];
      bool fx = true;
      consume<kXDim>(accx, s.ring, pipe, tile_addr, kWidth, kSlabK, fx, lane);
      drain(accx, s.ring, pipe, lane);
      dx_out<true>(accx, dx, row0, warp, lane);
    }
    // the next tile's loads overwrite x (the column sums) and v
    named_barrier(bar_id, kWgThreads);
  }
  // the copies complete before the block's shared memory goes
  if (ws.leader) bulk_wait_all();
}

template <bool kDx, bool kEnc>
__global__ void __launch_bounds__(kThreads, 1)
nerf_mlp_bwd_delta_kernel(const __grid_constant__ Inputs in,
                          const float* __restrict__ g, int n, int n_pad,
                          const bf16* __restrict__ img,
                          const bf16* __restrict__ img_t,
                          const float* __restrict__ b, int depth, int skip,
                          bf16* __restrict__ act, bf16* __restrict__ dlt,
                          float* __restrict__ bias_part,
                          float* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  uint32_t* mask_words =
      reinterpret_cast<uint32_t*>(smem_raw + sizeof(BwdSmem));
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(s.ring);
  if (tid < kWidth) s.wa[tid] = img[w_alpha_offset(depth, skip) + tid];
  __syncthreads();
  const int rounds = tile_rounds(n_pad / kTileM);
  Pipe<kStages> pipe;

  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int k = 0; k < rounds; ++k) {
        produce_forward(s.ring, pipe, img, depth, skip, false);
        produce_backward<kDx>(s.ring, pipe, img_t, depth, skip);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    delta_tiles<kDx, kEnc>(s, mask_words, pipe, rounds, in, g, n, n_pad, b,
                           depth, skip, act, dlt, bias_part, dx);
  }
}

__global__ void __launch_bounds__(kWgThreadsAll, 1)
nerf_mlp_bwd_wgrad_kernel(const __grid_constant__ Products ps, int n_pad,
                          int chunk, long long e_w, float* __restrict__ part) {
  wgrad_blocks(ps, n_pad, chunk, e_w, part);
}

// dL/dp (n, 3) of the encoded points from their f32 gradient gx (n, 64,
// freq_encode's layout [x, sin(2^0 x), cos(2^0 x), ...], each over the
// 3 dims), a thread a (point, dim): the identity's column plus each band's
// chain rule, bands in increasing order.
__global__ void __launch_bounds__(kGradThreads)
nerf_encode_grad_kernel(const float* __restrict__ pts,
                        const float* __restrict__ gx, int n, int freqs,
                        float* __restrict__ gp) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kGradThreads + threadIdx.x;
  if (e >= 3LL * n) return;
  const int d = static_cast<int>(e % 3);
  const float* __restrict__ row = gx + (e / 3) * kXDim;
  const float p = pts[e];
  float acc = row[d];
  for (int band = 0; band < freqs; ++band) {
    // scaling by 2^band is exact in f32, as in the encode
    const float scale = static_cast<float>(1 << band);
    float sn, cs;
    sincosf(p * scale, &sn, &cs);
    acc += scale * (cs * row[3 + 6 * band + d] - sn * row[6 + 6 * band + d]);
  }
  gp[e] = acc;
}

// out[r][e] = sum of in[c][e] over c in [r * group, min(C, (r + 1) * group)),
// in increasing c.
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int rows, long long e_n, int group) {
  reduce_rows(in, out, rows, e_n, group);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of the delta kernel (at this depth) and
// of the weight-gradient kernel.
int fused_nerf_mlp_bwd_delta_smem_bytes(int depth) {
  return static_cast<int>(bwd_smem_bytes(depth));
}
int fused_nerf_mlp_bwd_wgrad_smem_bytes() {
  return static_cast<int>(sizeof(WgradSmem));
}

// Gradients of the packed f32 weights (grad_w, e_w elements) and biases
// (grad_b, e_b) on `stream`, and, where grad_x is not null, of the encoded
// points: grad_x f32 (n_pad, 64), zero in rows past n. x (n_pad, 64) and v
// (n_pad, 32) are the bf16 encoded features with zero rows past n; where
// both are null, the delta kernel encodes pts and dirs (n, 3 f32 each) with
// xyz_freqs and view_freqs bands itself (the encode arm; nerf_encode_grad
// takes its grad_x on to the points). g (n, 4) f32 is the cotangent; img
// and img_t the forward and transposed images of the bf16 weight pack.
// Workspaces (the caller sizes them, see ops/mlp_train.py), tile-order
// planes of the columns named:
//   act bf16 h_0 .. h_{depth-1}, feat (256 each), g_act (128), x (64),
//       v (32): (depth + 1) * n_pad * 256 + n_pad * (128 + 64 + 32)
//   dlt bf16 d_0 .. d_{depth-1} (256 each), d_af (272), d_gpre (128),
//       d_rgb (16): depth * n_pad * 256 + n_pad * (272 + 128 + 16)
//   part_w f32 ceil(n_pad / chunk) * e_w, tmp_w ceil(that / group_w) * e_w
//   part_b f32 (n_pad / 64) * e_b, tmp_b ceil(that / group_b) * e_b
// *bulk_bytes gets the bytes the launch's bulk copies move: both
// workspaces written once by the delta kernel, and every stage the
// weight-gradient producers load (A's rows of a block and D's columns, so
// D once for each 128 gradient rows). Returns cudaGetLastError() of the
// last launch, or cudaErrorInvalidValue for arguments the kernels do not
// take.
int fused_nerf_mlp_bwd(const void* x, const void* v, const float* pts,
                       const float* dirs, int xyz_freqs, int view_freqs,
                       const float* g, int n, int n_pad, const void* img,
                       const void* img_t, const float* b, int depth, int skip,
                       void* act, void* dlt, float* part_w, float* tmp_w,
                       float* part_b, float* tmp_b, float* grad_w,
                       float* grad_b, float* grad_x,
                       long long e_w, long long e_b, int chunk, int group_w,
                       int group_b, void* stream, long long* bulk_bytes) {
  const bool enc = x == nullptr;
  if (enc != (v == nullptr) ||
      (enc && (pts == nullptr || dirs == nullptr || xyz_freqs < 0 ||
               view_freqs < 0 || 3 * (1 + 2 * xyz_freqs) > kXDim ||
               3 * (1 + 2 * view_freqs) > kVDim)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_pad % kTileM != 0 || n_pad < n ||
      chunk % kWgPoints != 0 ||
      depth + 6 > kMaxProducts || skip < 0 || skip >= depth - 1 ||
      static_cast<long long>(w_pack_size(depth, skip)) != e_w ||
      b_pack_size(depth) != e_b || group_w < 1 || group_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Inputs in{static_cast<const bf16*>(x), static_cast<const bf16*>(v),
                  pts, dirs, xyz_freqs, view_freqs};
  bf16* actb = static_cast<bf16*>(act);
  bf16* dltb = static_cast<bf16*>(dlt);

  // persistent blocks, one an SM, or fewer when there are fewer tiles
  static LaunchCache delta_cache[2][2], wgrad_cache;
  const size_t smem = bwd_smem_bytes(depth);
  int sms = 0;
  const bool dx = grad_x != nullptr;
  auto delta = dx ? (enc ? nerf_mlp_bwd_delta_kernel<true, true>
                         : nerf_mlp_bwd_delta_kernel<true, false>)
                  : (enc ? nerf_mlp_bwd_delta_kernel<false, true>
                         : nerf_mlp_bwd_delta_kernel<false, false>);
  cudaError_t err = prepare_launch(delta_cache[dx][enc], delta, smem, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n_pad / kTileM;
  delta<<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(
      in, g, n, n_pad, static_cast<const bf16*>(img),
      static_cast<const bf16*>(img_t), b, depth, skip, actb, dltb, part_b,
      grad_x);
  if ((err = cudaGetLastError())) return static_cast<int>(err);

  const size_t plane = static_cast<size_t>(n_pad) * kWidth;
  const bf16* g_act = actb + (depth + 1) * plane;
  const bf16* xt = g_act + static_cast<size_t>(n_pad) * kHalf;
  const bf16* vt = xt + static_cast<size_t>(n_pad) * kXDim;
  const bf16* d_af = dltb + depth * plane;
  const bf16* d_gpre = d_af + static_cast<size_t>(n_pad) * (kWidth + kAlphaPad);
  const bf16* d_rgb = d_gpre + static_cast<size_t>(n_pad) * kHalf;
  Products ps;
  ps.count = 0;
  int total = 0;
  // the delta kernel's stores, then each product's stage loads over all
  // n_pad / 64 stages of its blocks
  long long moved = static_cast<long long>(
      (vt + static_cast<size_t>(n_pad) * kVDim - actb) +
      (d_rgb + static_cast<size_t>(n_pad) * kRgbCols - dltb)) * 2;
  auto add = [&](const bf16* a, int lda, const bf16* d, int ldd, int k, int m,
                 size_t out_off, int out_ld, long long alpha_off) {
    Product& p = ps.p[ps.count];
    p.a = a; p.d = d; p.lda = lda; p.ldd = ldd; p.k = k; p.m = m;
    p.out_off = static_cast<long long>(out_off); p.out_ld = out_ld;
    p.alpha_off = alpha_off;
    ps.blocks_begin[ps.count++] = total;
    const int blocks = (k + kWgRowsA - 1) / kWgRowsA;
    total += blocks;
    moved += static_cast<long long>(n_pad) * 2 * (k + blocks * m);
  };
  add(xt, kXDim, dltb, kWidth, kXDim, kWidth, 0, kWidth, -1);
  for (int i = 1; i < depth; ++i) {
    const size_t off = w_trunk_offset(i, skip);
    if (i == skip + 1)
      add(xt, kXDim, dltb + i * plane, kWidth, kXDim, kWidth,
          off - static_cast<size_t>(kXDim) * kWidth, kWidth, -1);
    add(actb + (i - 1) * plane, kWidth, dltb + i * plane, kWidth, kWidth,
        kWidth, off, kWidth, -1);
  }
  // d_af = [d_feat | d_sigma | 0]: W_feat's gradient, and w_alpha's from
  // the 16 columns that start with d_sigma (column block 32 of a group)
  add(actb + (depth - 1) * plane, kWidth, d_af, kWidth + kAlphaPad, kWidth,
      kWidth, w_feat_offset(depth, skip), kWidth, -1);
  add(actb + (depth - 1) * plane, kWidth, d_af + kWidth * kWgPoints,
      kWidth + kAlphaPad, kWidth, kAlphaPad, 0, 0,
      static_cast<long long>(w_alpha_offset(depth, skip)));
  add(actb + depth * plane, kWidth, d_gpre, kHalf, kWidth, kHalf,
      w_view_offset(depth, skip), kHalf, -1);
  add(vt, kVDim, d_gpre, kHalf, kVDim, kHalf, w_view_dir_offset(depth, skip),
      kHalf, -1);
  add(g_act, kHalf, d_rgb, kRgbCols, kHalf, kRgbCols,
      w_rgb_offset(depth, skip), kRgbCols, -1);
  ps.blocks_begin[ps.count] = total;
  *bulk_bytes = moved;

  const int wg_smem = static_cast<int>(sizeof(WgradSmem));
  err = prepare_launch(wgrad_cache, nerf_mlp_bwd_wgrad_kernel, wg_smem, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n_pad + chunk - 1) / chunk;
  nerf_mlp_bwd_wgrad_kernel<<<dim3(total, chunks), kWgThreadsAll, wg_smem,
                              st>>>(ps, n_pad, chunk, e_w, part_w);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (int e2 = reduce_two_pass(reduce_rows_kernel, part_w, tmp_w, grad_w,
                               chunks, e_w, group_w, st))
    return e2;
  return reduce_two_pass(reduce_rows_kernel, part_b, tmp_b, grad_b,
                         n_pad / kWgRows, e_b, group_b, st);
}


// dL/dp (n, 3) f32 of points pts (n, 3) from the f32 gradient gx (n, 64)
// of their frequency encoding with `freqs` bands (the input gradient arm's
// grad_x), on `stream`. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int nerf_encode_grad(const float* pts, const float* gx, int n, int freqs,
                     float* gp, void* stream) {
  if (n <= 0 || freqs < 0 || 3 * (1 + 2 * freqs) > kXDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = 3LL * n;
  nerf_encode_grad_kernel<<<static_cast<unsigned>(
                                (items + kGradThreads - 1) / kGradThreads),
                            kGradThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pts, gx, n, freqs, gp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
