// The forward tile composite shared by K2 (packed instance rows) and K3
// (cached parameter rows projected in the kernel). The two differ only in
// how an instance's f32 features are produced; that is the row source, a
// policy type with
//
//   __device__ Decoded operator()(long long k) const;
//
// which returns instance k's (mx, my, ca, cb, cc, r, g, b, opa, depth).
// Everything after it (power coefficients, cutoff, clip, transmittance,
// early stop, output rows) is the one fragment loop below.
//
// Design (splatjax's chunking, the standard CUDA 3DGS tile loop):
// * one 256-thread block per 16x16 tile, one thread per pixel;
// * the tile's instances [start, end) are walked in 128-instance chunks
//   aligned to GLOBAL multiples of 128 from astart = start / 128 * 128, the
//   chunking splatjax uses, so `chunks_done` (output row 4) is the same
//   contract the backward re-walks;
// * per chunk, threads lo..hi-1 each produce one instance's features from
//   the row source and store its power coefficients, threshold, color and
//   depth in shared memory; each pixel then composites the chunk
//   sequentially in f32;
// * before each chunk the whole tile stops if no pixel still has
//   log T > log(early_stop) (__syncthreads_or, also the barrier that
//   protects the shared chunk buffer);
// * transmittance is carried in log space (log1p(-alpha), clamped at -60
//   when the clip does not bound alpha below 1), the within-chunk weight is
//   exp(s_excl + log alpha) and the chunk's sum is scaled by exp(log T) at
//   the chunk end, as splatjax computes it;
// * the power is evaluated as c0 + c1 x + c2 y + c3 x^2 + c4 xy + c5 y^2 in
//   tile-centered coordinates (half-integers, exact in f32), matching
//   splatjax's coefficient formulation so fragments on the exp(-4) cutoff
//   fall the same way;
// * fragments outside the support have alpha == 0 exactly and are skipped,
//   which leaves every sum unchanged (a NaN power fails the compare too).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "rows.cuh"

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr float LOG_OM_MIN = -60.0f;

// Per-launch arguments of the composite, passed by value.
struct CompositeArgs {
  const int* starts;  // (num_tiles,) int32
  const int* ends;    // (num_tiles,) int32
  const float* zbuf;  // (num_tiles, 256) camera z, or null
  float* out;         // (num_tiles, 8, 256)
  int tiles_x;
  int has_clip;
  float log_clip;
  int clamp_log_om;
  float log_eps;
};

template <class Source>
__device__ __forceinline__ void composite_tile(const Source& src,
                                               const CompositeArgs& a) {
  __shared__ float s_coef[6][CHUNK];
  __shared__ float s_thr[CHUNK];
  __shared__ float s_col[4][CHUNK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const int n_chunks = (end - astart + CHUNK - 1) / CHUNK;

  // tile-centered pixel coordinates: half-integers in [-7.5, 7.5]
  const float x = (float)(p % TILE) + 0.5f - 0.5f * TILE;
  const float y = (float)(p / TILE) + 0.5f - 0.5f * TILE;
  const float xx = x * x, xy = x * y, yy = y * y;
  const float ox = (float)((t % a.tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / a.tiles_x) * TILE) + 0.5f * TILE;
  const float zb =
      a.zbuf != nullptr ? a.zbuf[(long long)t * P + p] : -CUDART_INF_F;

  float lt = 0.0f;  // log transmittance
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int c = 0;
  for (; c < n_chunks; ++c) {
    if (!__syncthreads_or(lt > a.log_eps)) break;
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    if (p >= lo && p < hi) {
      const Decoded d = src((long long)base + p);
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
    }
    __syncthreads();

    float s_ex = 0.0f;  // exclusive log-transmittance sum within the chunk
    float cr = 0.0f, cg = 0.0f, cbl = 0.0f, cd = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const float power = s_coef[0][i] + s_coef[1][i] * x + s_coef[2][i] * y +
                          s_coef[3][i] * xx + s_coef[4][i] * xy +
                          s_coef[5][i] * yy;
      const float depth = s_col[3][i];
      if (power >= s_thr[i] && depth > zb) {
        const float pe = a.has_clip ? fminf(power, a.log_clip) : power;
        const float alpha = expf(pe);
        float s = log1pf(-alpha);
        if (a.clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
        const float w = expf(s_ex + pe);
        cr += w * s_col[0][i];
        cg += w * s_col[1][i];
        cbl += w * s_col[2][i];
        cd += w * depth;
        s_ex += s;
      }
    }
    const float tr = expf(lt);
    acc_r += tr * cr;
    acc_g += tr * cg;
    acc_b += tr * cbl;
    acc_d += tr * cd;
    lt += s_ex;
  }

  float* o = a.out + (long long)t * OUT_ROWS * P + p;
  o[0 * P] = acc_r;
  o[1 * P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = expf(lt);
  o[4 * P] = (float)c;
  o[5 * P] = acc_d;
  o[6 * P] = lt;
  o[7 * P] = 0.0f;
}

}  // namespace
