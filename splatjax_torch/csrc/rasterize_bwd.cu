// Backward tile rasterizer (K4): per-instance gradients of the forward's
// front-to-back compositing, on 32-byte or 16-byte packed rows.
//
// Replaces splatjax/ops/rasterize_vjp.py::_bwd_kernel (the Pallas kernel
// called by _bwd_pallas). The TPU kernel walks each tile's chunks in
// reverse with double-buffered DMAs, turns the within-chunk suffix scans
// into triangular MXU matmuls, reduces the per-instance sums over pixels as
// moment matmuls, and hands 128-lane output windows shared by two tiles
// from one grid step to the next (a DMA-ownership artefact of its
// feature-major output). None of that carries over.
//
// What bounds it on the H100: issue slots, in two places, and the deepest
// tiles' latency. Each walked fragment recomputes the power polynomial
// and, inside the support, exp + log1p + exp and about 30 FLOPs of chain
// rule; each (instance, warp) with a live fragment then reduces 10 sums
// over its pixels. A first design (a 5-level shuffle tree for each of the
// 10 sums: 50 shuffles per warp and instance, tiles in index order) ran at
// 4.4% of its operation bound, and its deepest tile, 14x the mean tile's
// walked instances and alone half of the kernel's time, started mid-grid.
// Bytes are small: one packed row per walked instance in, one 64-byte
// (32-byte when packed) gradient row out. PERF.md has the measured times.
//
// Design, a template over the square tile edge TILE (8, 16, 32 or 64 px;
// P = TILE^2 pixels):
// * up to 16 px one block per tile (Backward<TILE>), at 32 and 64 px one
//   thread-block cluster per tile (BackwardCluster<TILE>, below); tiles
//   are taken heaviest first: block (or cluster) b re-walks tile
//   order[b], the binning's permutation of all tiles by descending list
//   length, the forward's order too;
// * one pixel per thread (PIX) on 256 threads a 16 px tile or a cluster's
//   16x16 sub-block: on the 1M-splat 1920x1080 frame, measured on an H100
//   SXM at 700 W, two pixels a thread on 128 threads took 1.3x the time
//   at 16 px and four on 64 threads 2x, because a deep tile's
//   latency-bound walk then runs on 4 or 2 warps instead of 8; a single
//   block of 256 threads with 4 or 16 pixels a thread at 32 and 64 px
//   spilled its per-pixel arrays and took 4.3x and 28x the 16 px kernel.
//   An 8 px tile runs 64 threads, one pixel each, and holds its warps'
//   partials (below) half a chunk at a time;
// * it walks exactly the chunks the forward walked: chunks_done (row 4 of
//   the saved output) from astart = start / 128 * 128, last chunk first;
//   the first 128 threads decode one of the chunk's rows each (at 8 px
//   the 64 threads two each) into shared memory as four records, (c0,
//   c1, c2, c3), (c4, c5, threshold, depth), (r, g, b, mxl) and (myl,
//   opacity), so a walked fragment costs two
//   16-byte broadcast loads, and two more only when it is live;
// * transmittance comes from the saved LOG T_final (row 6), never from T:
//   log T_k = log T_after - log1p(-alpha_k), so stacks whose T drops below
//   the f32 range keep their front gradients;
// * per pixel it carries S, the suffix sum of alpha T (g . c) behind the
//   current instance, and applies splatjax's chain rule: the same cutoff,
//   z-buffer and range masks as the forward, the 1e-6 floor on 1 - alpha
//   when the clip does not bound alpha, g_alpha zeroed where the clip
//   binds, centred moments of g_power for the conic and mean gradients,
//   S1 / opacity for the opacity gradient, alpha T g for color and depth;
// * the 10 sums of an instance are folded over the thread's pixels in
//   registers, then over the warp by a reduce-scatter butterfly (5 + 3 +
//   2 + 1 + 1 = 12 shuffles, after which one even lane holds each sum),
//   skipped when no lane of the warp is live; those 10 lanes store the
//   warp's partials, and after the chunk each instance's thread adds the 8
//   warps' partials in warp order (in a cluster, then the blocks' partials
//   in rank order). Every sum has a fixed order, so two runs give
//   bit-identical rows (no atomics);
// * each instance belongs to one tile, so a block writes only its walked
//   rows [start, min(end, astart + 128 chunks_done)) of a zero-filled
//   output;
// * 16-byte rows write their gradients as bf16 pairs rounded to nearest
//   even, channel c low and c + 8 high (splatjax's _pack_grad_bf16), the
//   input of K7.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"
#include "rows.cuh"

namespace {

namespace coop = cooperative_groups;

constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr int NSUM = 10;
constexpr float LOG_OM_MIN = -60.0f;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The block geometry of a TILE x TILE tile up to 16 px (see the design
// notes above).
template <int TILE>
struct Backward {
  static constexpr int P = TILE * TILE;
  static constexpr int THREADS = P < 256 ? P : 256;
  static constexpr int PIX = P / THREADS;  // pixels a thread, in a column
  static constexpr int NWARPS = THREADS / 32;
  // The chunk's rows whose warps' partials a block holds at once: at 8 px
  // half the chunk, its back half walked and added before its front half
  // (12 KB of shared memory a block, not 17: 17 blocks an SM, not 12).
  static constexpr int HALVES = TILE == 8 ? 2 : 1;
  static constexpr int SPAN = CHUNK / HALVES;
  // Whether the chain rule takes the fast exp (__expf) for alpha and T and
  // divides by 1 - alpha through an approximate reciprocal (__fdividef, 2
  // ulp) instead of the IEEE division and its slow-path check: at 8 px,
  // where each fragment's instructions bound the kernel.
  static constexpr bool FAST_MATH = TILE == 8;
  static_assert((TILE == 8 || TILE == 16) && P % THREADS == 0,
                "tile edge 8 or 16: wider tiles run BackwardCluster");
  static_assert(THREADS % CHUNK == 0 || CHUNK % THREADS == 0,
                "the threads decode a chunk's rows in whole rounds");
};

__device__ __forceinline__ uint32_t bf16_round_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return u + 0x7FFFu + ((u >> 16) & 1u);
}

// channel c in the low half, channel c + 8 in the high half
__device__ __forceinline__ int pack_pair(float lo, float hi) {
  return (int)((bf16_round_bits(hi) & 0xFFFF0000u) |
               (bf16_round_bits(lo) >> 16));
}

// Which of the 10 sums warp_reduce_scatter leaves on `lane`, or -1: the
// even lanes whose bits 1-3 name a position that every level kept hold
// sum 5 b4 + 3 b3 + 2 b2 + b1 (b the lane's bits). Nibble (lane / 2) % 8
// of SLOTS is that sum for b4 = 0, 15 where none. Written as bit tests,
// the slot and its shared address were recomputed inside the instance
// loop of the 16-byte instantiation (15 integer instructions an instance
// in its SASS), which made it 14% slower than the 32-byte one; with the
// table and a pointer taken once, both loops hold them in registers.
constexpr unsigned SLOTS = 0xFF43F210u;
__device__ __forceinline__ int scatter_slot(int lane) {
  const int v = (int)((SLOTS >> (4 * ((lane >> 1) & 7))) & 15u);
  return (lane & 1) || v == 15 ? -1 : v + 5 * ((lane >> 4) & 1);
}

// Sums v[0..9] over the 32 lanes of a warp. Each level exchanges half of
// the values still held with the partner lane and adds the other half:
// 10 -> 5 (xor 16), 5 -> 3 (xor 8, one padded), 3 -> 2 (xor 4, one
// padded), 2 -> 1 (xor 2), then the pair sum (xor 1). Returns the warp sum
// of v[scatter_slot(lane)] on the lanes where that is >= 0.
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[NSUM],
                                                     int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float w[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const float keep = b4 ? v[m + 5] : v[m];
    const float send = b4 ? v[m] : v[m + 5];
    w[m] = keep + __shfl_xor_sync(FULL, send, 16);
  }
  float u[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float upper = m + 3 < 5 ? w[m + 3] : 0.0f;
    const float keep = b3 ? upper : w[m];
    const float send = b3 ? w[m] : upper;
    u[m] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  float z[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float upper = m + 2 < 3 ? u[m + 2] : 0.0f;
    const float keep = b2 ? upper : u[m];
    const float send = b2 ? u[m] : upper;
    z[m] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  const float q = (b1 ? z[1] : z[0]) + __shfl_xor_sync(FULL, b1 ? z[0] : z[1], 2);
  return q + __shfl_xor_sync(FULL, q, 1);
}

// Chunk row r's shared records from instance base + r's packed row: the
// power polynomial (s_pow, s_cut), colour and the mean's x offset
// (s_col), the mean's y offset and opacity (s_aux).
// Returns the decoded row.
template <bool PACKED16, bool EXACT>
__device__ __forceinline__ Decoded stage_row(const int4* __restrict__ rows,
                                             int base, int r, float ox,
                                             float oy, float4* s_pow,
                                             float4* s_cut, float4* s_col,
                                             float2* s_aux) {
  const Decoded d = decode_row<PACKED16>(rows, (long long)base + r);
  const float mxl = d.mx - ox, myl = d.my - oy;
  power_records<EXACT>(d, mxl, myl, s_pow[r], s_cut[r]);
  s_col[r] = make_float4(d.r, d.g, d.b, mxl);
  s_aux[r] = make_float2(myl, d.opa);
  return d;
}

// Instance base + r's gradient row from its 10 sums and chunk row r's
// records: the sums chained to (mean2d, conic, colour, opacity, depth),
// written as f32 or as bf16 pairs.
template <bool PACKED16>
__device__ __forceinline__ void store_grad_row(const float (&sum)[NSUM],
                                               const float4* s_pow,
                                               const float4* s_cut,
                                               const float2* s_aux, int base,
                                               int r,
                                               void* __restrict__ grad) {
  // the conic from its exact power coefficients (-ca/2, -cb, -cc/2)
  const float ca = -2.0f * s_pow[r].w, cb = -s_cut[r].x;
  const float cc = -2.0f * s_cut[r].y;
  const float opa = s_aux[r].y;
  float ch[16];
  ch[0] = ca * sum[1] + cb * sum[2];              // mean2d.x
  ch[1] = cb * sum[1] + cc * sum[2];              // mean2d.y
  ch[2] = -0.5f * sum[3];                         // conic a
  ch[3] = -sum[4];                                // conic b
  ch[4] = -0.5f * sum[5];                         // conic c
  ch[5] = sum[6];                                 // r
  ch[6] = sum[7];                                 // g
  ch[7] = sum[8];                                 // b
  ch[8] = sum[0] / (fabsf(opa) > 1e-12f ? opa : 1e-12f);  // opacity
  ch[9] = sum[9];                                 // depth
#pragma unroll
  for (int k = 10; k < 16; ++k) ch[k] = 0.0f;
  const long long kk = (long long)base + r;
  if (PACKED16) {
    int4* o = reinterpret_cast<int4*>(grad) + 2 * kk;
    o[0] = make_int4(pack_pair(ch[0], ch[8]), pack_pair(ch[1], ch[9]),
                     pack_pair(ch[2], ch[10]), pack_pair(ch[3], ch[11]));
    o[1] = make_int4(pack_pair(ch[4], ch[12]), pack_pair(ch[5], ch[13]),
                     pack_pair(ch[6], ch[14]), pack_pair(ch[7], ch[15]));
  } else {
    float4* o = reinterpret_cast<float4*>(grad) + 4 * kk;
    o[0] = make_float4(ch[0], ch[1], ch[2], ch[3]);
    o[1] = make_float4(ch[4], ch[5], ch[6], ch[7]);
    o[2] = make_float4(ch[8], ch[9], 0.0f, 0.0f);
    o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The 10 sums of partials row r over the NWARPS warps' partials, in warp
// order.
template <int NWARPS, int ROWS>
__device__ __forceinline__ void fold_warps(const float (*s_part)[ROWS][NSUM],
                                           int r, float (&sum)[NSUM]) {
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int wi = 0; wi < NWARPS; ++wi) acc += s_part[wi][r][k];
    sum[k] = acc;
  }
}

// Instance base + r's gradient row from the warps' partial sums of chunk
// row r and its records.
template <bool PACKED16, int NWARPS>
__device__ __forceinline__ void write_grad_row(
    const float (*s_part)[CHUNK][NSUM], const float4* s_pow,
    const float4* s_cut, const float2* s_aux, int base, int r,
    void* __restrict__ grad) {
  float sum[NSUM];
  fold_warps<NWARPS, CHUNK>(s_part, r, sum);
  store_grad_row<PACKED16>(sum, s_pow, s_cut, s_aux, base, r, grad);
}

template <int TILE, bool PACKED16>
__global__ void __launch_bounds__(Backward<TILE>::THREADS)
rasterize_bwd_kernel(const int4* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const int* __restrict__ order,
                     const float* __restrict__ out_saved,
                     const float* __restrict__ g_out, int gch,
                     const float* __restrict__ zbuf, void* __restrict__ grad,
                     int tiles_x, int has_clip, float log_clip,
                     int clamp_log_om, int om_floor) {
  using G = Backward<TILE>;
  constexpr int P = G::P, PIX = G::PIX, THREADS = G::THREADS;
  constexpr int NWARPS = G::NWARPS;
  constexpr bool EXACT = ExactPower<TILE>::value;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, mean x - tile centre x
  __shared__ float2 s_aux[CHUNK];  // mean y - tile centre y, opacity
  // the warps' partials: 48128 B in all at 16 px, 12288 B at 8 px
  __shared__ float s_part[NWARPS][G::SPAN][NSUM];

  const int t = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // the warp's partials column this lane stores after each instance
  const int slot = scatter_slot(lane);
  float* const part = slot >= 0 ? &s_part[warp][0][slot] : nullptr;
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const float* saved = out_saved + (long long)t * OUT_ROWS * P;
  const int c_done = (int)saved[4 * P];

  const int px = tid % TILE;
  const int py0 = (tid / TILE) * PIX;
  const float x = (float)px + 0.5f - 0.5f * TILE;
  const float xx = x * x;
  const float ox = (float)((t % tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / tiles_x) * TILE) + 0.5f * TILE;
  const float* go = g_out + (long long)t * gch * P;

  float y[PIX], xy[PIX], yy[PIX], zb[PIX];
  float gr[PIX], gg[PIX], gb[PIX], gd[PIX], gtt[PIX];
  float lt_after[PIX];  // log T behind the current instance
  float S[PIX];         // sum over later fragments of alpha T (g . c)
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int pp = (py0 + j) * TILE + px;
    y[j] = (float)(py0 + j) + 0.5f - 0.5f * TILE;
    xy[j] = x * y[j];
    yy[j] = y[j] * y[j];
    zb[j] = zbuf != nullptr ? zbuf[(long long)t * P + pp] : -CUDART_INF_F;
    gr[j] = go[0 * P + pp];
    gg[j] = go[1 * P + pp];
    gb[j] = go[2 * P + pp];
    gd[j] = gch > 4 ? go[5 * P + pp] : 0.0f;
    lt_after[j] = saved[6 * P + pp];
    gtt[j] = go[3 * P + pp] * expf(lt_after[j]);
    S[j] = 0.0f;
  }

  for (int c = c_done - 1; c >= 0; --c) {
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    __syncthreads();  // the previous chunk's readers of shared memory
    if constexpr (THREADS >= CHUNK) {
      if (tid >= lo && tid < hi) {  // hi <= 128: the first 128 threads
        stage_row<PACKED16, EXACT>(rows, base, tid, ox, oy, s_pow, s_cut,
                                   s_col, s_aux);
      }
    } else {  // fewer threads than rows: loop
      for (int r = tid; r < CHUNK; r += THREADS) {
        if (r >= lo && r < hi) {
          stage_row<PACKED16, EXACT>(rows, base, r, ox, oy, s_pow, s_cut,
                                     s_col, s_aux);
        }
      }
    }
    __syncthreads();

    // the rows [h_lo, h_hi) whose partials fit at once: the chunk's back
    // half, then its front half, at 8 px; the chunk at 16 px
    for (int h = G::HALVES - 1; h >= 0; --h) {
      const int hb = h * G::SPAN;
      const int h_lo = G::HALVES == 1 ? lo : max(lo, hb);
      const int h_hi = G::HALVES == 1 ? hi : min(hi, hb + G::SPAN);
      if (G::HALVES > 1 && h_lo >= h_hi) continue;  // an empty half
      for (int i = h_hi - 1; i >= h_lo; --i) {
        const float4 ct = s_cut[i];
        float power[PIX];
        bool hit[PIX];
        const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy,
                                           zb, power, hit);
        float v[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
        if (any) {
          const float4 col = s_col[i];
          const float myl = s_aux[i].x;
#pragma unroll
          for (int j = 0; j < PIX; ++j) {
            if (!hit[j]) continue;
            const float pe = has_clip ? fminf(power[j], log_clip) : power[j];
            const float alpha = G::FAST_MATH ? __expf(pe) : expf(pe);
            float s = log1pf(-alpha);
            if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
            const float lt_k = lt_after[j] - s;  // log T in front of i
            const float tk = G::FAST_MATH ? __expf(lt_k) : expf(lt_k);
            const float gdotc =
                gr[j] * col.x + gg[j] * col.y + gb[j] * col.z + gd[j] * ct.w;
            const float tg = tk * gdotc;
            float om = 1.0f - alpha;
            if (om_floor) om = om > 1e-6f ? om : 1e-6f;
            const float behind = S[j] + gtt[j];
            float g_alpha = tg - (G::FAST_MATH ? __fdividef(behind, om)
                                               : behind / om);
            if (has_clip && !(power[j] < log_clip)) g_alpha = 0.0f;
            const float g_pow = g_alpha * alpha;
            const float w = alpha * tk;
            S[j] += alpha * tg;
            lt_after[j] = lt_k;
            const float dx = x - col.w, dy = y[j] - myl;
            v[0] += g_pow;
            v[1] += g_pow * dx;
            v[2] += g_pow * dy;
            v[3] += g_pow * dx * dx;
            v[4] += g_pow * dx * dy;
            v[5] += g_pow * dy * dy;
            v[6] += w * gr[j];
            v[7] += w * gg[j];
            v[8] += w * gb[j];
            v[9] += w * gd[j];
          }
        }
        const float sum =
            __any_sync(FULL, any) ? warp_reduce_scatter(v, lane) : 0.0f;
        if (part != nullptr) part[(i - hb) * NSUM] = sum;
      }
      __syncthreads();

      if constexpr (G::HALVES > 1) {  // thread r adds the half's row hb + r
        static_assert(THREADS == G::SPAN, "one thread a row of the half");
        if (hb + tid >= h_lo && hb + tid < h_hi) {
          float sum[NSUM];
          fold_warps<NWARPS, G::SPAN>(s_part, tid, sum);
          store_grad_row<PACKED16>(sum, s_pow, s_cut, s_aux, base, hb + tid,
                                   grad);
        }
        __syncthreads();  // the half's partials read before the next half's
      } else {
        static_assert(THREADS >= CHUNK, "thread r adds chunk row r");
        if (tid >= lo && tid < hi) {
          write_grad_row<PACKED16, NWARPS>(s_part, s_pow, s_cut, s_aux, base,
                                           tid, grad);
        }
      }
    }
  }
}

// The thread-block cluster of a TILE x TILE tile at 32 and 64 px: CLUSTER
// blocks, block rank b taking sub-block b of the tile (SUB_W x SUB_H
// pixels, numbered row by row), one pixel a thread, as a 16 px tile's
// block does.
// * Every block stages the whole chunk's records, and with them each
//   instance's support mask (support_mask in rows.cuh: one bit per
//   sub-block its exp(-4) support can reach), and walks only the rows
//   whose bit for its sub-block is set (four ballot words, read last row
//   first). Another row has no live fragment among the block's pixels, so
//   its partials there would be +0 exactly: the skip changes no sum. It
//   is uniform over the block.
// * Chunk row r has an owner block, rank r / OWNED. After the walk,
//   thread r of every block the row reaches folds its warps' partials of
//   the row in warp order and stores the 10 sums into the owner's slot
//   (r % OWNED, rank) through distributed shared memory; after one
//   cluster barrier the owner adds the slots of the blocks the row's mask
//   names, in rank order from +0, chains the sums and writes the row
//   (zeros where the mask is empty). The slots are one buffer: every
//   block arrives at a second cluster barrier when its owner pass has
//   read them and waits on it before its next stores, so the chunk's
//   staging and walk in between hide that barrier.
// * Every block runs the tile's c_done chunks, so the barriers match; the
//   first remote store waits on a barrier that every block arrives at
//   when it starts, and the last arrival is waited on before exit.
// * The warps' partials (40 KB) and the slots (6 KB) live in dynamic
//   shared memory; MIN_BLOCKS, the blocks an SM this leaves room for (4),
//   caps the registers a thread in the launch bounds (64). A second slot
//   buffer by chunk parity, which saves the second barrier, leaves room
//   for 3 blocks an SM and was slower on the H100 (PERF.md).
template <int TILE>
struct BackwardSub {
  static constexpr int W = 16;
  static constexpr int H = 16;
};

template <int TILE>
struct BackwardCluster {
  static constexpr int P = TILE * TILE;
  static constexpr int SUB_W = BackwardSub<TILE>::W;
  static constexpr int SUB_H = BackwardSub<TILE>::H;
  static constexpr int THREADS = SUB_W * SUB_H;  // one pixel a thread
  static constexpr int NWARPS = THREADS / 32;
  static constexpr int COLS = TILE / SUB_W;  // sub-blocks in a row
  static constexpr int CLUSTER = P / THREADS;
  static constexpr int OWNED = CHUNK / CLUSTER;  // rows a block writes
  static constexpr int PART_BYTES = NWARPS * CHUNK * NSUM * 4;
  static constexpr int SLOT_BYTES = CHUNK * 3 * 16;
  static constexpr int DYN_BYTES = PART_BYTES + SLOT_BYTES;
  static constexpr int STATIC_BYTES = CHUNK * (3 * 16 + 8 + 4);
  // 228 KB of shared memory an SM, 1 KB of it reserved for each block
  static constexpr int MIN_BLOCKS =
      233472 / (DYN_BYTES + STATIC_BYTES + 1024);
  static_assert(TILE > 16 && P % THREADS == 0 && CHUNK % CLUSTER == 0 &&
                    CLUSTER <= 16,
                "a cluster of up to 16 blocks per 32 or 64 px tile");
  static_assert(THREADS >= CHUNK, "thread r stages and folds chunk row r");
  static_assert(MIN_BLOCKS >= 1, "shared memory of one block");
};

// A cluster barrier in two halves: this thread's arrival (its shared
// memory accesses before it ordered before the peers' after the wait, or
// no ordering when relaxed), and the wait for every block's arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int TILE, bool PACKED16>
__global__ void __launch_bounds__(BackwardCluster<TILE>::THREADS,
                                  BackwardCluster<TILE>::MIN_BLOCKS)
rasterize_bwd_cluster_kernel(const int4* __restrict__ rows,
                             const int* __restrict__ starts,
                             const int* __restrict__ ends,
                             const int* __restrict__ order,
                             const float* __restrict__ out_saved,
                             const float* __restrict__ g_out, int gch,
                             const float* __restrict__ zbuf,
                             void* __restrict__ grad, int tiles_x,
                             int has_clip, float log_clip, int clamp_log_om,
                             int om_floor) {
  using G = BackwardCluster<TILE>;
  constexpr int P = G::P, C = G::CLUSTER, OWNED = G::OWNED;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, mean x - tile centre x
  __shared__ float2 s_aux[CHUNK];  // mean y - tile centre y, opacity
  __shared__ unsigned s_mask[CHUNK];  // sub-blocks the support reaches
  __shared__ unsigned s_reach[CHUNK / 32];  // rows reaching this block
  extern __shared__ float4 s_dyn[];
  // the warps' partials, then the owned rows' slots
  float(*const s_part)[CHUNK][NSUM] =
      reinterpret_cast<float(*)[CHUNK][NSUM]>(s_dyn);
  float4(*const s_slot)[3] = reinterpret_cast<float4(*)[3]>(
      reinterpret_cast<char*>(s_dyn) + G::PART_BYTES);

  coop::cluster_group cluster = coop::this_cluster();
  cluster_arrive_relaxed();  // every block has started: the first wait
  const int rank = (int)cluster.block_rank();
  const int t = order[blockIdx.x / C];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int slot = scatter_slot(lane);
  float* const part = slot >= 0 ? &s_part[warp][0][slot] : nullptr;
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const float* saved = out_saved + (long long)t * OUT_ROWS * P;
  const int c_done = (int)saved[4 * P];

  // the thread's pixel, in coordinates centred on the whole tile
  const int px = (rank % G::COLS) * G::SUB_W + tid % G::SUB_W;
  const int py = (rank / G::COLS) * G::SUB_H + tid / G::SUB_W;
  const int pp = py * TILE + px;
  const float x = (float)px + 0.5f - 0.5f * TILE;
  const float xx = x * x;
  const float ox = (float)((t % tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / tiles_x) * TILE) + 0.5f * TILE;
  const float* go = g_out + (long long)t * gch * P;
  float y[1], xy[1], yy[1], zb[1];
  y[0] = (float)py + 0.5f - 0.5f * TILE;
  xy[0] = x * y[0];
  yy[0] = y[0] * y[0];
  zb[0] = zbuf != nullptr ? zbuf[(long long)t * P + pp] : -CUDART_INF_F;
  const float gr = go[0 * P + pp], gg = go[1 * P + pp];
  const float gb = go[2 * P + pp];
  const float gd = gch > 4 ? go[5 * P + pp] : 0.0f;
  float lt_after = saved[6 * P + pp];  // log T behind the current instance
  const float gtt = go[3 * P + pp] * expf(lt_after);
  float S = 0.0f;  // sum over later fragments of alpha T (g . c)

  for (int c = c_done - 1; c >= 0; --c) {
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    __syncthreads();  // the previous chunk's row writers read the records
    if (tid < CHUNK) {  // the first 4 warps: row tid
      bool reached = false;
      if (tid >= lo && tid < hi) {
        const Decoded d = stage_row<PACKED16, true>(
            rows, base, tid, ox, oy, s_pow, s_cut, s_col, s_aux);
        const unsigned mask = support_mask<TILE, G::SUB_W, G::SUB_H>(
            d, d.mx - ox, d.my - oy, logf(fmaxf(d.opa, 1e-30f)));
        s_mask[tid] = mask;
        reached = (mask >> rank) & 1u;
      }
      const unsigned bits = __ballot_sync(FULL, reached);
      if (lane == 0) s_reach[warp] = bits;
    }
    __syncthreads();

    // the rows whose support reaches the sub-block, last first
    for (int wr = CHUNK / 32 - 1; wr >= 0; --wr) {
      for (unsigned bits = s_reach[wr]; bits != 0;) {
        const int i = wr * 32 + 31 - __clz(bits);
        bits &= ~(1u << (i % 32));
        const float4 ct = s_cut[i];
        float power[1];
        bool hit[1];
        const bool any = eval_power<true>(s_pow[i], ct, x, xx, y, xy, yy, zb,
                                          power, hit);
        float v[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
        if (any) {
          const float4 col = s_col[i];
          const float myl = s_aux[i].x;
          const float pe = has_clip ? fminf(power[0], log_clip) : power[0];
          const float alpha = expf(pe);
          float s = log1pf(-alpha);
          if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
          const float lt_k = lt_after - s;  // log T in front of i
          const float tk = expf(lt_k);
          const float gdotc = gr * col.x + gg * col.y + gb * col.z + gd * ct.w;
          const float tg = tk * gdotc;
          float om = 1.0f - alpha;
          if (om_floor) om = om > 1e-6f ? om : 1e-6f;
          float g_alpha = tg - (S + gtt) / om;
          if (has_clip && !(power[0] < log_clip)) g_alpha = 0.0f;
          const float g_pow = g_alpha * alpha;
          const float w = alpha * tk;
          S += alpha * tg;
          lt_after = lt_k;
          const float dx = x - col.w, dy = y[0] - myl;
          v[0] = g_pow;
          v[1] = g_pow * dx;
          v[2] = g_pow * dy;
          v[3] = g_pow * dx * dx;
          v[4] = g_pow * dx * dy;
          v[5] = g_pow * dy * dy;
          v[6] = w * gr;
          v[7] = w * gg;
          v[8] = w * gb;
          v[9] = w * gd;
        }
        const float sum =
            __any_sync(FULL, any) ? warp_reduce_scatter(v, lane) : 0.0f;
        if (part != nullptr) part[i * NSUM] = sum;
      }
    }
    __syncthreads();
    cluster_wait();  // the owners have read the slots

    // a reached row's block partial to its owner
    if (tid < CHUNK && ((s_reach[warp] >> lane) & 1u)) {
      float sum[NSUM];
      fold_warps<G::NWARPS, CHUNK>(s_part, tid, sum);
      float4* dst = cluster.map_shared_rank(
          &s_slot[(tid % OWNED) * C + rank][0],
          (unsigned)(tid / OWNED));
      dst[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
      dst[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
      dst[2] = make_float4(sum[8], sum[9], 0.0f, 0.0f);
    }
    cluster.sync();

    // an owned row: the partials of the blocks it reaches, in rank order
    const int r = rank * OWNED + tid;
    if (tid < OWNED && r >= lo && r < hi) {
      const unsigned reach = s_mask[r];
      float sum[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) sum[k] = 0.0f;
#pragma unroll
      for (int b = 0; b < C; ++b) {
        if (!((reach >> b) & 1u)) continue;
        const float4* in = &s_slot[tid * C + b][0];
        const float4 a0 = in[0], a1 = in[1], a2 = in[2];
        sum[0] += a0.x;
        sum[1] += a0.y;
        sum[2] += a0.z;
        sum[3] += a0.w;
        sum[4] += a1.x;
        sum[5] += a1.y;
        sum[6] += a1.z;
        sum[7] += a1.w;
        sum[8] += a2.x;
        sum[9] += a2.y;
      }
      store_grad_row<PACKED16>(sum, s_pow, s_cut, s_aux, base, r, grad);
    }
    cluster_arrive();
  }
  cluster_wait();
}

// K4's kernel at tile edge TILE: one block per tile up to 16 px, one
// cluster per tile above
template <int TILE, bool PACKED16>
auto bwd_kernel() {
  if constexpr (TILE > 16) {
    return rasterize_bwd_cluster_kernel<TILE, PACKED16>;
  } else {
    return rasterize_bwd_kernel<TILE, PACKED16>;
  }
}

// K4's launch shape at tile edge TILE: blocks a tile, threads a block,
// dynamic shared memory bytes
template <int TILE>
struct BwdLaunch {
  static constexpr int CLUSTER = 1;
  static constexpr int THREADS = Backward<TILE>::THREADS;
  static constexpr int DYN_BYTES = 0;
};
template <>
struct BwdLaunch<32> : BackwardCluster<32> {};
template <>
struct BwdLaunch<64> : BackwardCluster<64> {};

template <int TILE>
int bwd_attributes(int packed16, int* out) {
  using L = BwdLaunch<TILE>;
  return packed16 ? kernel_attributes<L::CLUSTER>(
                        bwd_kernel<TILE, true>(), L::THREADS, L::DYN_BYTES,
                        out)
                  : kernel_attributes<L::CLUSTER>(
                        bwd_kernel<TILE, false>(), L::THREADS, L::DYN_BYTES,
                        out);
}

template <int TILE, bool PACKED16, class... Args>
int launch_bwd(int num_tiles, cudaStream_t stream, Args... args) {
  using L = BwdLaunch<TILE>;
  return launch_tiles<L::CLUSTER>(bwd_kernel<TILE, PACKED16>(),
                                  (unsigned)num_tiles * L::CLUSTER,
                                  L::THREADS, L::DYN_BYTES, stream, args...);
}

template <int TILE, class... Args>
int launch_edge(int packed16, int num_tiles, cudaStream_t stream,
                Args... args) {
  return packed16 ? launch_bwd<TILE, true>(num_tiles, stream, args...)
                  : launch_bwd<TILE, false>(num_tiles, stream, args...);
}

}  // namespace

// rows: (K, 8) int32 packed rows as the forward read them; starts/ends:
// (num_tiles,) int32; order: (num_tiles,) int32 permutation of the tiles,
// heaviest first; out_saved: (num_tiles, 8, P) f32 forward output;
// g_out: (num_tiles, gch, P) f32 planar cotangent, gch 4 (r, g, b,
// T_final) or 8 (the forward's rows, depth in row 5); zbuf:
// (num_tiles, P) f32 or null; grad: zero-filled (K, 16) f32, or (K, 8)
// int32 bf16 pairs when packed16; P = tile * tile. tile: the square tile
// edge, 8, 16, 32 or 64; any other returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int splat_rasterize_bwd(const int* rows, const int* starts,
                                   const int* ends, const int* order,
                                   const float* out_saved,
                                   const float* g_out, int gch,
                                   const float* zbuf, void* grad,
                                   int num_tiles, int tiles_x, int tile,
                                   int has_clip, float log_clip,
                                   int clamp_log_om, int om_floor,
                                   int packed16, cudaStream_t stream) {
  if (tile != 8 && tile != 16 && tile != 32 && tile != 64) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const int4* r = reinterpret_cast<const int4*>(rows);
  switch (tile) {
    case 8:
      return launch_edge<8>(packed16, num_tiles, stream, r, starts, ends,
                            order, out_saved, g_out, gch, zbuf, grad,
                            tiles_x, has_clip, log_clip, clamp_log_om,
                            om_floor);
    case 16:
      return launch_edge<16>(packed16, num_tiles, stream, r, starts, ends,
                             order, out_saved, g_out, gch, zbuf, grad,
                             tiles_x, has_clip, log_clip, clamp_log_om,
                             om_floor);
    case 32:
      return launch_edge<32>(packed16, num_tiles, stream, r, starts, ends,
                             order, out_saved, g_out, gch, zbuf, grad,
                             tiles_x, has_clip, log_clip, clamp_log_om,
                             om_floor);
    default:
      return launch_edge<64>(packed16, num_tiles, stream, r, starts, ends,
                             order, out_saved, g_out, gch, zbuf, grad,
                             tiles_x, has_clip, log_clip, clamp_log_om,
                             om_floor);
  }
}

// out: 5 int32, kernel_attributes (launch.cuh) of the K4 instantiation at
// tile edge tile (8, 16, 32 or 64) and row width (packed16): registers a
// thread, local memory bytes a thread (spills), the largest block, blocks
// an SM, clusters on the device.
extern "C" int splat_rasterize_bwd_attributes(int tile, int packed16,
                                              int* out) {
  switch (tile) {
    case 8: return bwd_attributes<8>(packed16, out);
    case 16: return bwd_attributes<16>(packed16, out);
    case 32: return bwd_attributes<32>(packed16, out);
    case 64: return bwd_attributes<64>(packed16, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
