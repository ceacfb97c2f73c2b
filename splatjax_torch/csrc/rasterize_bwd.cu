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
// P = TILE^2 pixels, the geometry in Backward<TILE>):
// * one block per tile, taken heaviest first: block b re-walks tile
//   order[b], the binning's permutation of all tiles by descending list
//   length, the forward's order too;
// * at 16 px one pixel per thread (PIX) on 256 threads: on the 1M-splat
//   1920x1080 frame, measured on an H100 SXM at 700 W, two pixels a thread
//   on 128 threads took 1.3x the time and four on 64 threads 2x, because a
//   deep tile's latency-bound walk then runs on 4 or 2 warps instead of 8.
//   Wider tiles keep 256 threads (8 warps, so the warps' partials stay at
//   40 KB of shared memory) and raise PIX, 4 at 32 px and 16 at 64 px,
//   whose per-pixel arrays spill to local memory; an 8 px tile runs 64
//   threads, one pixel each;
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
//   warps' partials in warp order. Every sum has a fixed order, so two
//   runs give bit-identical rows (no atomics);
// * each instance belongs to one tile, so a block writes only its walked
//   rows [start, min(end, astart + 128 chunks_done)) of a zero-filled
//   output;
// * 16-byte rows write their gradients as bf16 pairs rounded to nearest
//   even, channel c low and c + 8 high (splatjax's _pack_grad_bf16), the
//   input of K7.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr int NSUM = 10;
constexpr float LOG_OM_MIN = -60.0f;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The block geometry of a TILE x TILE tile (see the design notes above).
template <int TILE>
struct Backward {
  static constexpr int P = TILE * TILE;
  static constexpr int THREADS = P < 256 ? P : 256;
  static constexpr int PIX = P / THREADS;  // pixels a thread, in a column
  static constexpr int NWARPS = THREADS / 32;
  static_assert(TILE % 8 == 0 && P % THREADS == 0,
                "tile edge 8, 16, 32 or 64");
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
template <bool PACKED16, bool EXACT>
__device__ __forceinline__ void stage_row(const int4* __restrict__ rows,
                                          int base, int r, float ox, float oy,
                                          float4* s_pow, float4* s_cut,
                                          float4* s_col, float2* s_aux) {
  const Decoded d = decode_row<PACKED16>(rows, (long long)base + r);
  const float mxl = d.mx - ox, myl = d.my - oy;
  power_records<EXACT>(d, mxl, myl, s_pow[r], s_cut[r]);
  s_col[r] = make_float4(d.r, d.g, d.b, mxl);
  s_aux[r] = make_float2(myl, d.opa);
}

// Instance base + r's gradient row from the warps' partial sums of chunk
// row r and its records: the 10 sums in warp order, chained to (mean2d,
// conic, colour, opacity, depth), written as f32 or as bf16 pairs.
template <bool PACKED16, int NWARPS>
__device__ __forceinline__ void write_grad_row(
    const float (*s_part)[CHUNK][NSUM], const float4* s_pow,
    const float4* s_cut, const float2* s_aux, int base, int r,
    void* __restrict__ grad) {
  float sum[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int wi = 0; wi < NWARPS; ++wi) acc += s_part[wi][r][k];
    sum[k] = acc;
  }
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
  __shared__ float s_part[NWARPS][CHUNK][NSUM];  // 48128 B in all, 8 warps

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

    for (int i = hi - 1; i >= lo; --i) {
      const float4 ct = s_cut[i];
      float power[PIX];
      bool hit[PIX];
      const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy, zb,
                                         power, hit);
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
          const float alpha = expf(pe);
          float s = log1pf(-alpha);
          if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
          const float lt_k = lt_after[j] - s;  // log T in front of i
          const float tk = expf(lt_k);
          const float gdotc =
              gr[j] * col.x + gg[j] * col.y + gb[j] * col.z + gd[j] * ct.w;
          const float tg = tk * gdotc;
          float om = 1.0f - alpha;
          if (om_floor) om = om > 1e-6f ? om : 1e-6f;
          float g_alpha = tg - (S[j] + gtt[j]) / om;
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
      if (part != nullptr) part[i * NSUM] = sum;
    }
    __syncthreads();

    if constexpr (THREADS >= CHUNK) {
      if (tid >= lo && tid < hi) {
        write_grad_row<PACKED16, NWARPS>(s_part, s_pow, s_cut, s_aux, base,
                                         tid, grad);
      }
    } else {
      for (int r = tid; r < CHUNK; r += THREADS) {
        if (r >= lo && r < hi) {
          write_grad_row<PACKED16, NWARPS>(s_part, s_pow, s_cut, s_aux, base,
                                           r, grad);
        }
      }
    }
  }
}

template <int TILE>
int launch_bwd(const int4* r, const int* starts, const int* ends,
               const int* order, const float* out_saved, const float* g_out,
               int gch, const float* zbuf, void* grad, int num_tiles,
               int tiles_x, int has_clip, float log_clip, int clamp_log_om,
               int om_floor, int packed16, cudaStream_t stream) {
  constexpr int THREADS = Backward<TILE>::THREADS;
  if (packed16) {
    rasterize_bwd_kernel<TILE, true><<<num_tiles, THREADS, 0, stream>>>(
        r, starts, ends, order, out_saved, g_out, gch, zbuf, grad, tiles_x,
        has_clip, log_clip, clamp_log_om, om_floor);
  } else {
    rasterize_bwd_kernel<TILE, false><<<num_tiles, THREADS, 0, stream>>>(
        r, starts, ends, order, out_saved, g_out, gch, zbuf, grad, tiles_x,
        has_clip, log_clip, clamp_log_om, om_floor);
  }
  return (int)cudaGetLastError();
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
      return launch_bwd<8>(r, starts, ends, order, out_saved, g_out, gch,
                           zbuf, grad, num_tiles, tiles_x, has_clip,
                           log_clip, clamp_log_om, om_floor, packed16,
                           stream);
    case 16:
      return launch_bwd<16>(r, starts, ends, order, out_saved, g_out, gch,
                            zbuf, grad, num_tiles, tiles_x, has_clip,
                            log_clip, clamp_log_om, om_floor, packed16,
                            stream);
    case 32:
      return launch_bwd<32>(r, starts, ends, order, out_saved, g_out, gch,
                            zbuf, grad, num_tiles, tiles_x, has_clip,
                            log_clip, clamp_log_om, om_floor, packed16,
                            stream);
    default:
      return launch_bwd<64>(r, starts, ends, order, out_saved, g_out, gch,
                            zbuf, grad, num_tiles, tiles_x, has_clip,
                            log_clip, clamp_log_om, om_floor, packed16,
                            stream);
  }
}
