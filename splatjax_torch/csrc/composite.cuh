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
// * up to 16 px one block composites a tile; at 32 and 64 px a
//   thread-block cluster does, its CLUSTER blocks each taking a 16x16
//   sub-block of the tile (4 at 32 px, 16 at 64 px: above the portable
//   cluster size of 8, opted in at launch), whose kernels are held to 64
//   registers a thread (4 blocks an SM). Tiles are taken heaviest
//   first: block (or cluster) b composites tile order[b], a permutation of
//   all tiles by descending instance count, so the deepest tiles start
//   first and the short ones fill in behind them;
// * each thread owns PIX vertically adjacent pixels of its block, so every
//   shared load of an instance's features serves all of them; GROUP =
//   pixels / PIX threads cover the block, and the block's two such groups
//   split each chunk's instances between them. At 16 px, and in every
//   block of a cluster, PIX = 2 and GROUP = 128 (a warp covers a 16x4
//   patch; 256 threads, so a deep tile's walk runs on 8 warps a block),
//   and the groups take the chunk's front 64 rows and its back 64. At 8 px
//   a tile has 64 pixels: PIX = 1, GROUP = 64, 128 threads, a warp covers
//   an 8x4 half of the tile, and the groups split the chunk's live rows
//   [lo, hi) evenly at (lo + hi) / 2: an 8 px tile of a 1080p frame of
//   1M splats walks about 95 instances on average, so most of its chunks
//   are partial, and fixed halves would often leave one group idle until
//   the join. Four one-warp groups of two pixels a thread, each walking a
//   quarter of the live rows over the whole tile, were slower on the H100
//   (64 registers, a four-segment join);
// * the tile's instances [start, end) are walked in 128-instance chunks
//   aligned to GLOBAL multiples of 128 from astart = start / 128 * 128, the
//   chunking splatjax uses, so `chunks_done` (output row 4) is the same
//   contract the backward re-walks;
// * per chunk, the instances' features are produced from the row source,
//   one row a thread: the first group's threads at 16 px and in a
//   cluster, all 128 threads at 8 px, where a staged row serves only 64
//   pixels and K3's projection costs about 190 operations a row (staging
//   chunk c + 1 into a second buffer while chunk c is walked, a barrier
//   fewer a chunk, was no faster there). They are stored as three float4
//   records, (c0, c1, c2, c3), (c4, c5, threshold, depth) and (r, g, b,
//   -): a walked fragment costs two 16-byte broadcast loads for both
//   pixels, a third only when one of them is inside the support;
// * before each chunk the whole tile stops if no pixel still has
//   log T > log(early_stop) (__syncthreads_or over both pixels of every
//   thread of the first group, which carries T; also the barrier that
//   protects the shared chunk buffer). A pixel that is dead keeps adding
//   until its tile stops, as in splatjax, so a cluster votes tile-wide:
//   each block writes its __syncthreads_or to its shared memory, by chunk
//   parity, and after one cluster barrier every warp reads the CLUSTER
//   flags through distributed shared memory. Every block of a cluster
//   thus runs the same number of chunks, and every pixel of a tile
//   carries one chunks_done (K4 reads it at the tile's pixel 0);
// * in a cluster the third record's last lane holds the instance's
//   support mask (support_mask in rows.cuh): one bit per sub-block its
//   exp(-4) support can reach, from a rectangle that bounds the f32
//   power's support. A block skips the chunk's instances whose bit is
//   clear, which changes no sum. The chunk is not compacted: the groups'
//   front and back halves stay where they are. At 8 px the same skip per
//   warp (a bit for each 8x4 half of the tile) was slower: the mask costs
//   each staged row two square roots and two divisions, and the test a
//   dependent shared load per walked row, more than the power polynomials
//   it saves on the rows a warp cannot see (PERF.md, cluster_variants.py);
// * every block of a cluster produces the whole chunk's records itself,
//   one row a thread of its first group. Splitting that work over the
//   cluster (block r producing 128 / CLUSTER rows, every block copying the
//   others' through distributed shared memory after the vote's barrier)
//   was slower for K2 and for K3 on the H100 (PERF.md, cluster_variants.py);
// * transmittance is carried in log space (log1p(-alpha), clamped at -60
//   when the clip does not bound alpha below 1), the within-chunk weight is
//   exp(s_excl + log alpha), as splatjax computes it; each group sums its
//   half from its own start, the back half's sums are scaled by exp(the
//   front half's log-transmittance sum) when the halves are joined, and the
//   chunk's sum by exp(log T) at the chunk end; the back half's sums go
//   through the block's shared memory, 20 B a pixel;
// * the power is evaluated as c0 + c1 x + c2 y + c3 x^2 + c4 xy + c5 y^2 in
//   coordinates centred on the whole tile (half-integers, exact in f32),
//   term for term in this order (another association or FMA contraction
//   flips fragments on the exp(-4) cutoff), matching splatjax's
//   coefficient formulation so those fragments fall the same way as in the
//   plain version;
// * fragments outside the support have alpha == 0 exactly and are skipped,
//   which leaves every sum unchanged (a NaN power fails the compare too).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"
#include "rows.cuh"

namespace {

namespace coop = cooperative_groups;

constexpr int CHUNK = 128;
constexpr int HALF = CHUNK / 2;      // instances of a chunk per group
constexpr int OUT_ROWS = 8;
constexpr float LOG_OM_MIN = -60.0f;

// The pixels one block composites, SUB_W x SUB_H: the whole tile up to 16
// px, a 16x16 sub-block of it above.
template <int TILE>
struct SubBlock {
  static constexpr int W = TILE <= 16 ? TILE : 16;
  static constexpr int H = W;
};

// The block geometry of a TILE x TILE tile (see the design notes above).
template <int TILE>
struct Composite {
  static constexpr int P = TILE * TILE;
  static constexpr int SUB_W = SubBlock<TILE>::W;
  static constexpr int SUB_H = SubBlock<TILE>::H;
  static constexpr int SUB_P = SUB_W * SUB_H;      // pixels of a block
  static constexpr int CLUSTER = P / SUB_P;        // blocks of a tile
  static constexpr int PIX = SUB_P > CHUNK ? 2 : 1;  // pixels a thread
  static constexpr int GROUP = SUB_P / PIX;  // threads that cover the block
  static constexpr int THREADS = 2 * GROUP;
  // resident blocks an SM the cluster kernels' launch bounds ask for:
  // 1024 threads, a cap of 64 registers a thread (PERF.md: uncapped, K3's
  // projection takes 68 and fits 3 blocks an SM; capped, it spills nothing
  // and runs about 20% faster at 64 px)
  static constexpr int MIN_BLOCKS = 1024 / THREADS;
  static_assert(TILE % 8 == 0 && P % SUB_P == 0, "tile edge 8, 16, 32 or 64");
  static_assert(THREADS >= CHUNK, "a thread produces each row of a chunk");
  static_assert(CLUSTER <= 32, "a warp reads the cluster's votes");
};

// Per-launch arguments of the composite, passed by value.
struct CompositeArgs {
  const int* starts;  // (num_tiles,) int32
  const int* ends;    // (num_tiles,) int32
  const int* order;   // (num_tiles,) int32 tile of each block or cluster
  const float* zbuf;  // (num_tiles, P) camera z, or null
  float* out;         // (num_tiles, 8, P)
  int tiles_x;
  int has_clip;
  float log_clip;
  int clamp_log_om;
  float log_eps;
};

// Whether any of the C blocks of this block's cluster voted its tile alive
// before chunk c: the block's vote goes to its shared memory at the chunk's
// parity, every warp reads the C votes after one cluster barrier. The
// parity lets a block write chunk c + 1's vote while a peer may still read
// chunk c's: it can only reach chunk c + 2's after every peer has passed
// chunk c + 1's barrier.
template <int C>
__device__ __forceinline__ bool cluster_alive(int vote, int c) {
  __shared__ int s_vote[2];
  coop::cluster_group cluster = coop::this_cluster();
  if (threadIdx.x == 0) s_vote[c & 1] = vote;
  cluster.sync();
  const int lane = threadIdx.x % 32;
  const int v =
      lane < C ? *cluster.map_shared_rank(&s_vote[c & 1], (unsigned)lane) : 0;
  return __any_sync(0xffffffffu, v != 0);
}

template <int TILE, class Source>
__device__ __forceinline__ void composite_tile(const Source& src,
                                               const CompositeArgs& a) {
  using G = Composite<TILE>;
  constexpr int P = G::P, PIX = G::PIX, GROUP = G::GROUP;
  constexpr int C = G::CLUSTER;
  constexpr bool EXACT = ExactPower<TILE>::value;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, support mask bits (clusters)
  __shared__ float4 s_back[G::SUB_P];  // the back half's r, g, b, depth sums
  __shared__ float s_back_lt[G::SUB_P];  // and its log-transmittance sum

  int rank = 0;  // the block's sub-block of the tile
  if constexpr (C > 1) rank = (int)coop::this_cluster().block_rank();
  const int t = a.order[blockIdx.x / C];
  const int tid = threadIdx.x;
  const int half = tid / GROUP;    // 0: front half of each chunk, 1: back
  const int q = tid % GROUP;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const int n_chunks = (end - astart + CHUNK - 1) / CHUNK;

  // pixel coordinates centred on the whole tile: half-integers in
  // [-TILE/2 + 0.5, TILE/2 - 0.5]; pixel j of this thread is (px, py0 + j),
  // index pix[j]
  constexpr int COLS = TILE / G::SUB_W;  // sub-blocks in a row of the tile
  const int px = (rank % COLS) * G::SUB_W + q % G::SUB_W;
  const int py0 = (rank / COLS) * G::SUB_H + (q / G::SUB_W) * PIX;
  const float x = (float)px + 0.5f - 0.5f * TILE;
  const float xx = x * x;
  int pix[PIX], back[PIX];  // tile and back-buffer index of pixel j
  float y[PIX], xy[PIX], yy[PIX], zb[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    pix[j] = (py0 + j) * TILE + px;
    back[j] = C == 1 ? pix[j] : j * GROUP + q;
    y[j] = (float)(py0 + j) + 0.5f - 0.5f * TILE;
    xy[j] = x * y[j];
    yy[j] = y[j] * y[j];
    zb[j] = a.zbuf != nullptr ? a.zbuf[(long long)t * P + pix[j]]
                              : -CUDART_INF_F;
  }
  const float ox = (float)((t % a.tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / a.tiles_x) * TILE) + 0.5f * TILE;
  // instance base + r's three records into the chunk buffer's row r
  const auto stage = [&](int base, int r) {
    const Decoded d = src((long long)base + r);
    power_records<EXACT>(d, d.mx - ox, d.my - oy, s_pow[r], s_cut[r]);
    if constexpr (C == 1) {
      s_col[r] = make_float4(d.r, d.g, d.b, 0.0f);
    } else {
      const unsigned mask = support_mask<TILE, G::SUB_W, G::SUB_H>(
          d, d.mx - ox, d.my - oy, logf(fmaxf(d.opa, 1e-30f)));
      s_col[r] = make_float4(d.r, d.g, d.b, __uint_as_float(mask));
    }
  };

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
    if constexpr (C == 1) {
      if (!__syncthreads_or(alive)) break;
    } else {
      if (!cluster_alive<C>(__syncthreads_or(alive), c)) break;
    }
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    if (tid < CHUNK && tid >= lo && tid < hi) stage(base, tid);
    __syncthreads();

    float s_ex[PIX];  // exclusive log-transmittance sum within the half
    float cr[PIX], cg[PIX], cbl[PIX], cd[PIX];
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      s_ex[j] = 0.0f;
      cr[j] = cg[j] = cbl[j] = cd[j] = 0.0f;
    }
    // 8 px: the live rows split evenly, the front group taking the
    // smaller half (it also joins); else the chunk's fixed halves
    const int mid = (lo + hi) / 2;
    const int h_lo = TILE == 8 ? (half == 0 ? lo : mid) : max(lo, half * HALF);
    const int h_hi =
        TILE == 8 ? (half == 0 ? mid : hi) : min(hi, half * HALF + HALF);
    for (int i = h_lo; i < h_hi; ++i) {
      if constexpr (C > 1) {  // the support misses this block's pixels
        if (!((__float_as_uint(s_col[i].w) >> rank) & 1u)) continue;
      }
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
        s_back[back[j]] = make_float4(cr[j], cg[j], cbl[j], cd[j]);
        s_back_lt[back[j]] = s_ex[j];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        // join the halves: the back half's weights start behind the front
        const float4 bk = s_back[back[j]];
        const float tf = expf(s_ex[j]);
        cr[j] += tf * bk.x;
        cg[j] += tf * bk.y;
        cbl[j] += tf * bk.z;
        cd[j] += tf * bk.w;
        s_ex[j] += s_back_lt[back[j]];
        const float tr = expf(lt[j]);
        acc_r[j] += tr * cr[j];
        acc_g[j] += tr * cg[j];
        acc_b[j] += tr * cbl[j];
        acc_d[j] += tr * cd[j];
        lt[j] += s_ex[j];
      }
    }
  }
  // no block leaves while a peer may still read its shared memory
  if constexpr (C > 1) coop::this_cluster().sync();

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

// Launches ``kernel`` (a composite_tile<TILE> kernel): one block per tile
// up to 16 px, one cluster of Composite<TILE>::CLUSTER blocks per tile
// above. Returns the launch's cudaError_t.
template <int TILE, class Kernel, class... Args>
int launch_composite(Kernel kernel, int num_tiles, cudaStream_t stream,
                     Args... args) {
  using G = Composite<TILE>;
  return launch_tiles<G::CLUSTER>(kernel, (unsigned)num_tiles * G::CLUSTER,
                                  G::THREADS, 0, stream, args...);
}

}  // namespace
