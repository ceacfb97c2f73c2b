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
// What bounds it on the H100: issue slots per walked fragment (the power
// polynomial, and exp + log1p + exp inside the support), and the latency
// of the deepest tiles, whose blocks walk up to 20x the mean tile's
// instances one after another. A first design (one thread per pixel,
// scalar shared arrays, tiles in index order) spent 8 broadcast shared
// loads per walked fragment before the cutoff test and started its
// deepest tiles mid-grid, so they finished last. PERF.md has the measured
// times of both designs.
//
// Design (splatjax's chunking, the standard CUDA 3DGS tile loop), a
// template over the square tile edge TILE (8, 16, 32 or 64 px; P = TILE^2
// pixels, the geometry in Composite<TILE>):
// * one block per tile, taken heaviest first: block b composites tile
//   order[b], a permutation of all tiles by descending instance count, so
//   the deepest tiles start first and the short ones fill in behind them;
// * each thread owns PIX vertically adjacent pixels, so every shared load
//   of an instance's features serves all of them; GROUP = P / PIX threads
//   cover the tile, and the block's two such groups split each chunk's
//   instances between them, the front 64 and the back 64. At 16 px PIX = 2
//   and GROUP = 128 (a warp covers a 16x4 patch; 256 threads, so a deep
//   tile's walk runs on 8 warps). Wider tiles keep the 256-thread block and
//   raise PIX (8 at 32 px, 32 at 64 px), at the cost of registers: the
//   64 px instantiation spills its per-pixel arrays to local memory. At
//   8 px a tile has 64 pixels: PIX = 1, GROUP = 64, 128 threads;
// * the tile's instances [start, end) are walked in 128-instance chunks
//   aligned to GLOBAL multiples of 128 from astart = start / 128 * 128, the
//   chunking splatjax uses, so `chunks_done` (output row 4) is the same
//   contract the backward re-walks;
// * per chunk, the first group's threads produce the instances' features
//   from the row source, one each (two each at 8 px, where GROUP = 64),
//   and store them as three float4 records,
//   (c0, c1, c2, c3), (c4, c5, threshold, depth) and (r, g, b, -): a walked
//   fragment costs two 16-byte broadcast loads for both pixels, a third
//   only when one of them is inside the support;
// * before each chunk the whole tile stops if no pixel still has
//   log T > log(early_stop) (__syncthreads_or over both pixels of every
//   thread of the first group, which carries T; also the barrier that
//   protects the shared chunk buffer);
// * transmittance is carried in log space (log1p(-alpha), clamped at -60
//   when the clip does not bound alpha below 1), the within-chunk weight is
//   exp(s_excl + log alpha), as splatjax computes it; each group sums its
//   half from its own start, the back half's sums are scaled by exp(the
//   front half's log-transmittance sum) when the halves are joined, and the
//   chunk's sum by exp(log T) at the chunk end; the back half's sums go
//   through shared memory, 20 B a pixel (dynamic shared memory at 64 px,
//   80 KB, opted in at launch by launch_composite);
// * the power is evaluated as c0 + c1 x + c2 y + c3 x^2 + c4 xy + c5 y^2 in
//   tile-centered coordinates (half-integers, exact in f32), term for term
//   in this order (another association or FMA contraction flips fragments
//   on the exp(-4) cutoff), matching splatjax's coefficient formulation so
//   those fragments fall the same way as in the plain version;
// * fragments outside the support have alpha == 0 exactly and are skipped,
//   which leaves every sum unchanged (a NaN power fails the compare too).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "rows.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int HALF = CHUNK / 2;      // instances of a chunk per group
constexpr int OUT_ROWS = 8;
constexpr float LOG_OM_MIN = -60.0f;

// The block geometry of a TILE x TILE tile (see the design notes above).
template <int TILE>
struct Composite {
  static constexpr int P = TILE * TILE;
  static constexpr int PIX = P > CHUNK ? P / CHUNK : 1;  // pixels a thread
  static constexpr int GROUP = P / PIX;    // threads that cover the tile
  static constexpr int THREADS = 2 * GROUP;
  // the back half's per-pixel sums: float4 + float a pixel
  static constexpr int BACK_BYTES = P * (int)(sizeof(float4) + sizeof(float));
  // above 48 KB of static shared memory a block needs dynamic shared memory
  static constexpr bool DYNAMIC = BACK_BYTES > 32 * 1024;
  static constexpr int DYNAMIC_BYTES = DYNAMIC ? BACK_BYTES : 0;
  static_assert(TILE % 8 == 0 && P % PIX == 0, "tile edge 8, 16, 32 or 64");
  static_assert(CHUNK % GROUP == 0, "the first group produces a chunk's rows");
};

// Per-launch arguments of the composite, passed by value.
struct CompositeArgs {
  const int* starts;  // (num_tiles,) int32
  const int* ends;    // (num_tiles,) int32
  const int* order;   // (num_tiles,) int32 tile of each block, heaviest first
  const float* zbuf;  // (num_tiles, P) camera z, or null
  float* out;         // (num_tiles, 8, P)
  int tiles_x;
  int has_clip;
  float log_clip;
  int clamp_log_om;
  float log_eps;
};

template <int TILE, class Source>
__device__ __forceinline__ void composite_tile(const Source& src,
                                               const CompositeArgs& a) {
  using G = Composite<TILE>;
  constexpr int P = G::P, PIX = G::PIX, GROUP = G::GROUP;
  constexpr bool EXACT = ExactPower<TILE>::value;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, unused
  float4* s_back;                  // the back half's r, g, b, depth sums
  float* s_back_lt;                // and its log-transmittance sum
  if constexpr (G::DYNAMIC) {
    extern __shared__ float4 s_dynamic[];
    s_back = s_dynamic;
    s_back_lt = reinterpret_cast<float*>(s_dynamic + P);
  } else {
    __shared__ float4 s_back_static[P];
    __shared__ float s_back_lt_static[P];
    s_back = s_back_static;
    s_back_lt = s_back_lt_static;
  }

  const int t = a.order[blockIdx.x];
  const int tid = threadIdx.x;
  const int half = tid / GROUP;    // 0: front half of each chunk, 1: back
  const int q = tid % GROUP;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const int n_chunks = (end - astart + CHUNK - 1) / CHUNK;

  // tile-centered pixel coordinates: half-integers in [-TILE/2 + 0.5,
  // TILE/2 - 0.5]; pixel j of this thread is (px, py0 + j), index pix[j]
  const int px = q % TILE;
  const int py0 = (q / TILE) * PIX;
  const float x = (float)px + 0.5f - 0.5f * TILE;
  const float xx = x * x;
  int pix[PIX];
  float y[PIX], xy[PIX], yy[PIX], zb[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    pix[j] = (py0 + j) * TILE + px;
    y[j] = (float)(py0 + j) + 0.5f - 0.5f * TILE;
    xy[j] = x * y[j];
    yy[j] = y[j] * y[j];
    zb[j] = a.zbuf != nullptr ? a.zbuf[(long long)t * P + pix[j]]
                              : -CUDART_INF_F;
  }
  const float ox = (float)((t % a.tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / a.tiles_x) * TILE) + 0.5f * TILE;

  float lt[PIX];  // log transmittance (the front group's)
  float acc_r[PIX], acc_g[PIX], acc_b[PIX], acc_d[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    lt[j] = 0.0f;
    acc_r[j] = acc_g[j] = acc_b[j] = acc_d[j] = 0.0f;
  }
  int c = 0;
  for (; c < n_chunks; ++c) {
    bool alive = false;
#pragma unroll
    for (int j = 0; j < PIX; ++j) alive |= half == 0 && lt[j] > a.log_eps;
    if (!__syncthreads_or(alive)) break;
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    const auto stage = [&](int r) {
      const Decoded d = src((long long)base + r);
      power_records<EXACT>(d, d.mx - ox, d.my - oy, s_pow[r], s_cut[r]);
      s_col[r] = make_float4(d.r, d.g, d.b, 0.0f);
    };
    if constexpr (GROUP == CHUNK) {
      if (tid < CHUNK && tid >= lo && tid < hi) stage(tid);
    } else if (tid < GROUP) {  // fewer threads than rows: loop
      for (int r = tid; r < CHUNK; r += GROUP) {
        if (r >= lo && r < hi) stage(r);
      }
    }
    __syncthreads();

    float s_ex[PIX];  // exclusive log-transmittance sum within the half
    float cr[PIX], cg[PIX], cbl[PIX], cd[PIX];
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      s_ex[j] = 0.0f;
      cr[j] = cg[j] = cbl[j] = cd[j] = 0.0f;
    }
    const int h_lo = max(lo, half * HALF);
    const int h_hi = min(hi, half * HALF + HALF);
    for (int i = h_lo; i < h_hi; ++i) {
      const float4 ct = s_cut[i];
      float power[PIX];
      bool hit[PIX];
      if (!eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy, zb, power,
                             hit)) {
        continue;
      }
      const float4 col = s_col[i];
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        if (!hit[j]) continue;
        const float pe = a.has_clip ? fminf(power[j], a.log_clip) : power[j];
        const float alpha = expf(pe);
        float s = log1pf(-alpha);
        if (a.clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
        const float w = expf(s_ex[j] + pe);
        cr[j] += w * col.x;
        cg[j] += w * col.y;
        cbl[j] += w * col.z;
        cd[j] += w * ct.w;
        s_ex[j] += s;
      }
    }
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        s_back[pix[j]] = make_float4(cr[j], cg[j], cbl[j], cd[j]);
        s_back_lt[pix[j]] = s_ex[j];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        // join the halves: the back half's weights start behind the front
        const float4 bk = s_back[pix[j]];
        const float tf = expf(s_ex[j]);
        cr[j] += tf * bk.x;
        cg[j] += tf * bk.y;
        cbl[j] += tf * bk.z;
        cd[j] += tf * bk.w;
        s_ex[j] += s_back_lt[pix[j]];
        const float tr = expf(lt[j]);
        acc_r[j] += tr * cr[j];
        acc_g[j] += tr * cg[j];
        acc_b[j] += tr * cbl[j];
        acc_d[j] += tr * cd[j];
        lt[j] += s_ex[j];
      }
    }
  }

  if (half == 0) {
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      float* o = a.out + (long long)t * OUT_ROWS * P + pix[j];
      o[0 * P] = acc_r[j];
      o[1 * P] = acc_g[j];
      o[2 * P] = acc_b[j];
      o[3 * P] = expf(lt[j]);
      o[4 * P] = (float)c;
      o[5 * P] = acc_d[j];
      o[6 * P] = lt[j];
      o[7 * P] = 0.0f;
    }
  }
}

// Launches ``kernel`` (a composite_tile<TILE> kernel) with one block per
// tile, opting the kernel in to its dynamic shared memory first where the
// instantiation needs it. Returns the launch's cudaError_t.
template <int TILE, class Kernel, class... Args>
int launch_composite(Kernel kernel, int num_tiles, cudaStream_t stream,
                     Args... args) {
  using G = Composite<TILE>;
  if (G::DYNAMIC) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::DYNAMIC_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<num_tiles, G::THREADS, G::DYNAMIC_BYTES, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
