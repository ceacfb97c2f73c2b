// Forward tile rasterizer (K2) on packed instance rows, 32-byte viewer rows
// or 16-byte training rows (template parameter PACKED16).
//
// Replaces splatjax/ops/rasterize.py::_fwd_kernel (the Pallas kernel called
// by rasterize_cm_fwd), both row decodes. The TPU kernel streams
// chunk-major feature blocks through a DMA ring, evaluates the Gaussian
// power as a (P, 6) x (6, 128) MXU product and turns the within-chunk
// transmittance scan into triangular matmuls, then flips its (P, C)
// accumulators to planar rows with identity matmuls. Those are MXU/VMEM
// artefacts; this kernel is the standard CUDA 3DGS tile rasterizer.
//
// What bounds it on the H100: the per-fragment arithmetic. Each walked
// fragment (instance x pixel) costs the 6-term power polynomial and, where
// the fragment is inside the exp(-4) support, exp + log1p + exp; bytes are
// small (32 B per instance read once per tile, 8 KB written per tile).
//
// Design:
// * one 256-thread block per 16x16 tile, one thread per pixel;
// * the tile's instances [start, end) are walked in 128-instance chunks
//   aligned to GLOBAL multiples of 128 from astart = start / 128 * 128, the
//   chunking splatjax uses, so `chunks_done` (output row 4) is the same
//   contract the backward re-walks;
// * per chunk, threads 0..127 each load one 32-byte row (two 16-byte
//   loads), decode it and store the per-instance power coefficients,
//   color and depth in shared memory; each pixel then composites the chunk
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
//   which leaves every sum unchanged;
// * the 16-byte rows decode exactly as splatjax's unpack_chunk16 (mean at
//   1/8 px with a 2048 px bias, bf16 conic halves, u16 opacity, RGB8, f32
//   depth in lane 4); the fragment math after the decode is the same f32
//   code for both layouts. splatjax's 16-byte mode also switches to
//   single-pass bf16 MXU scans; this kernel does not (f32 throughout).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "rows.cuh"

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr float LOG_OM_MIN = -60.0f;

template <bool PACKED16>
__global__ void __launch_bounds__(P)
rasterize_fwd_kernel(const int4* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ zbuf,
                     float* __restrict__ out, int tiles_x, int has_clip,
                     float log_clip, int clamp_log_om, float log_eps) {
  __shared__ float s_coef[6][CHUNK];
  __shared__ float s_thr[CHUNK];
  __shared__ float s_col[4][CHUNK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const int n_chunks = (end - astart + CHUNK - 1) / CHUNK;

  // tile-centered pixel coordinates: half-integers in [-7.5, 7.5]
  const float x = (float)(p % TILE) + 0.5f - 0.5f * TILE;
  const float y = (float)(p / TILE) + 0.5f - 0.5f * TILE;
  const float xx = x * x, xy = x * y, yy = y * y;
  const float ox = (float)((t % tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / tiles_x) * TILE) + 0.5f * TILE;
  const float zb = zbuf != nullptr ? zbuf[(long long)t * P + p] : -CUDART_INF_F;

  float lt = 0.0f;  // log transmittance
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int c = 0;
  for (; c < n_chunks; ++c) {
    if (!__syncthreads_or(lt > log_eps)) break;
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
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
        const float pe = has_clip ? fminf(power, log_clip) : power;
        const float alpha = expf(pe);
        float s = log1pf(-alpha);
        if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
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

  float* o = out + (long long)t * OUT_ROWS * P + p;
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

// rows: (K, 8) int32 packed instance rows, tile-sorted (16-byte training
// rows when packed16); starts/ends: (num_tiles,) int32; zbuf:
// (num_tiles, 256) f32 camera z or null; out: (num_tiles, 8, 256) f32.
extern "C" int splat_rasterize_fwd(const int* rows, const int* starts,
                                   const int* ends, const float* zbuf,
                                   float* out, int num_tiles, int tiles_x,
                                   int has_clip, float log_clip,
                                   int clamp_log_om, float log_eps,
                                   int packed16, cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  const int4* r = reinterpret_cast<const int4*>(rows);
  if (packed16) {
    rasterize_fwd_kernel<true><<<num_tiles, P, 0, stream>>>(
        r, starts, ends, zbuf, out, tiles_x, has_clip, log_clip,
        clamp_log_om, log_eps);
  } else {
    rasterize_fwd_kernel<false><<<num_tiles, P, 0, stream>>>(
        r, starts, ends, zbuf, out, tiles_x, has_clip, log_clip,
        clamp_log_om, log_eps);
  }
  return (int)cudaGetLastError();
}
