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
// What bounds it on the H100: per-fragment arithmetic and the per-instance
// reduction over the tile's pixels. Each walked fragment recomputes the
// power polynomial and, inside the support, exp + log1p + exp and about 30
// FLOPs of chain rule; each (instance, warp) with a live fragment then
// reduces 10 sums over 32 lanes with shuffles. Bytes are small: one packed
// row per walked instance in, one 64-byte (32-byte when packed) gradient
// row out.
//
// Design:
// * one 256-thread block per 16x16 tile, one thread per pixel;
// * it walks exactly the chunks the forward walked: chunks_done (row 4 of
//   the saved output) from astart = start / 128 * 128, last chunk first,
//   each chunk's rows decoded into shared memory, instances back to front;
// * transmittance comes from the saved LOG T_final (row 6), never from T:
//   log T_k = log T_after - log1p(-alpha_k), so stacks whose T drops below
//   the f32 range keep their front gradients;
// * per pixel it carries S, the suffix sum of alpha T (g . c) behind the
//   current instance, and applies splatjax's chain rule: the same cutoff,
//   z-buffer and range masks as the forward, the 1e-6 floor on 1 - alpha
//   when the clip does not bound alpha, g_alpha zeroed where the clip
//   binds, centred moments of g_power for the conic and mean gradients,
//   S1 / opacity for the opacity gradient, alpha T g for color and depth;
// * the 10 sums of each instance are reduced over the tile in a fixed
//   order, warp shuffles and then the 8 warp partials in shared memory, so
//   the result is the same on every run (no atomics);
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

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr int NWARPS = P / 32;
constexpr int NSUM = 10;
constexpr float LOG_OM_MIN = -60.0f;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t bf16_round_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return u + 0x7FFFu + ((u >> 16) & 1u);
}

// channel c in the low half, channel c + 8 in the high half
__device__ __forceinline__ int pack_pair(float lo, float hi) {
  return (int)((bf16_round_bits(hi) & 0xFFFF0000u) |
               (bf16_round_bits(lo) >> 16));
}

template <bool PACKED16>
__global__ void __launch_bounds__(P)
rasterize_bwd_kernel(const int4* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ out_saved,
                     const float* __restrict__ g_out, int gch,
                     const float* __restrict__ zbuf, void* __restrict__ grad,
                     int tiles_x, int has_clip, float log_clip,
                     int clamp_log_om, int om_floor) {
  __shared__ float s_coef[6][CHUNK];
  __shared__ float s_thr[CHUNK];
  __shared__ float s_col[4][CHUNK];
  __shared__ float s_mxl[CHUNK];
  __shared__ float s_myl[CHUNK];
  __shared__ float s_opa[CHUNK];
  __shared__ float s_part[NWARPS][NSUM][CHUNK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const float* saved = out_saved + (long long)t * OUT_ROWS * P;
  const int c_done = (int)saved[4 * P];

  const float x = (float)(p % TILE) + 0.5f - 0.5f * TILE;
  const float y = (float)(p / TILE) + 0.5f - 0.5f * TILE;
  const float xx = x * x, xy = x * y, yy = y * y;
  const float ox = (float)((t % tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / tiles_x) * TILE) + 0.5f * TILE;
  const float zb = zbuf != nullptr ? zbuf[(long long)t * P + p] : -CUDART_INF_F;

  const float* go = g_out + (long long)t * gch * P;
  const float gr = go[0 * P + p], gg = go[1 * P + p], gb = go[2 * P + p];
  const float gd = gch > 4 ? go[5 * P + p] : 0.0f;
  const float lt_final = saved[6 * P + p];
  const float gtt = go[3 * P + p] * expf(lt_final);

  float lt_after = lt_final;  // log T behind the current instance
  float S = 0.0f;             // sum over later fragments of alpha T (g . c)

  for (int c = c_done - 1; c >= 0; --c) {
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    __syncthreads();  // the previous chunk's readers of shared memory
    if (p >= lo && p < hi) {
      const Decoded d = decode_row<PACKED16>(rows, (long long)base + p);
      const float ca = d.ca, cb = d.cb, cc = d.cc;
      const float lnopa = logf(fmaxf(d.opa, 1e-30f));
      const float mxl = d.mx - ox, myl = d.my - oy;
      s_coef[0][p] =
          -0.5f * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + lnopa;
      s_coef[1][p] = ca * mxl + cb * myl;
      s_coef[2][p] = cc * myl + cb * mxl;
      s_coef[3][p] = -0.5f * ca;
      s_coef[4][p] = -cb;
      s_coef[5][p] = -0.5f * cc;
      s_thr[p] = lnopa - 4.0f;
      s_col[0][p] = d.r;
      s_col[1][p] = d.g;
      s_col[2][p] = d.b;
      s_col[3][p] = d.depth;
      s_mxl[p] = mxl;
      s_myl[p] = myl;
      s_opa[p] = d.opa;
    }
    __syncthreads();

    for (int i = hi - 1; i >= lo; --i) {
      const float power = s_coef[0][i] + s_coef[1][i] * x + s_coef[2][i] * y +
                          s_coef[3][i] * xx + s_coef[4][i] * xy +
                          s_coef[5][i] * yy;
      const bool valid = power >= s_thr[i] && s_col[3][i] > zb;
      float v[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
      if (valid) {
        const float pe = has_clip ? fminf(power, log_clip) : power;
        const float alpha = expf(pe);
        float s = log1pf(-alpha);
        if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
        const float lt_k = lt_after - s;  // log T in front of instance i
        const float tk = expf(lt_k);
        const float gdotc = gr * s_col[0][i] + gg * s_col[1][i] +
                            gb * s_col[2][i] + gd * s_col[3][i];
        const float tg = tk * gdotc;
        float om = 1.0f - alpha;
        if (om_floor) om = om > 1e-6f ? om : 1e-6f;
        float g_alpha = tg - (S + gtt) / om;
        if (has_clip && !(power < log_clip)) g_alpha = 0.0f;
        const float g_pow = g_alpha * alpha;
        const float w = alpha * tk;
        S += alpha * tg;
        lt_after = lt_k;
        const float dx = x - s_mxl[i], dy = y - s_myl[i];
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
      if (__any_sync(FULL, valid)) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[k] += __shfl_down_sync(FULL, v[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) s_part[warp][k][i] = v[k];
      }
    }
    __syncthreads();

    if (p >= lo && p < hi) {
      float sum[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) {
        float a = 0.0f;
#pragma unroll
        for (int wi = 0; wi < NWARPS; ++wi) a += s_part[wi][k][p];
        sum[k] = a;
      }
      // the conic from its exact power coefficients (-ca/2, -cb, -cc/2)
      const float ca = -2.0f * s_coef[3][p], cb = -s_coef[4][p];
      const float cc = -2.0f * s_coef[5][p];
      const float opa = s_opa[p];
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
      const long long kk = (long long)base + p;
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
  }
}

}  // namespace

// rows: (K, 8) int32 packed rows as the forward read them; starts/ends:
// (num_tiles,) int32; out_saved: (num_tiles, 8, 256) f32 forward output;
// g_out: (num_tiles, gch, 256) f32 planar cotangent, gch 4 (r, g, b,
// T_final) or 8 (the forward's rows, depth in row 5); zbuf:
// (num_tiles, 256) f32 or null; grad: zero-filled (K, 16) f32, or (K, 8)
// int32 bf16 pairs when packed16.
extern "C" int splat_rasterize_bwd(const int* rows, const int* starts,
                                   const int* ends, const float* out_saved,
                                   const float* g_out, int gch,
                                   const float* zbuf, void* grad,
                                   int num_tiles, int tiles_x, int has_clip,
                                   float log_clip, int clamp_log_om,
                                   int om_floor, int packed16,
                                   cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  const int4* r = reinterpret_cast<const int4*>(rows);
  if (packed16) {
    rasterize_bwd_kernel<true><<<num_tiles, P, 0, stream>>>(
        r, starts, ends, out_saved, g_out, gch, zbuf, grad, tiles_x,
        has_clip, log_clip, clamp_log_om, om_floor);
  } else {
    rasterize_bwd_kernel<false><<<num_tiles, P, 0, stream>>>(
        r, starts, ends, out_saved, g_out, gch, zbuf, grad, tiles_x,
        has_clip, log_clip, clamp_log_om, om_floor);
  }
  return (int)cudaGetLastError();
}
