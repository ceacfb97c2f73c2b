#!/usr/bin/env python3
"""Time the design choices of the thread-block cluster rasterizers (K2, K3
and K4 at 32 and 64 px tiles) and of K2, K3 and K4 at 8 px tiles on one
GPU.

    python3 cluster_variants.py [VARIANT ...]

(default: every variant; ``shipped`` is timed first, and again where it is
named, so that its spread over the call shows).

Each variant is this tree's ``splatjax_torch/csrc`` with one design choice
changed (``VARIANTS``), built as ``splatjax_torch.kernels`` builds it, into
``build/cluster_variants/<variant>/``:

  shipped     the sources as they are: every block of a cluster produces
              the chunk's records itself, 64 px tiles as 16 blocks of
              16x16 pixels (a non-portable cluster), launch bounds that
              cap a cluster kernel at 64 registers (4 blocks an SM); K4
              pushes each block's partials of a row into the row's owner
              block's shared memory, in one buffer guarded by a second
              cluster barrier, and walks only the rows whose support
              reaches the block;
  split       the staging split over the cluster (``SPLIT``, patched into
              ``composite.cuh``): block r produces rows [r S, (r + 1) S) of
              each chunk, S = 128 / CLUSTER, into its own shared memory
              before the vote's cluster barrier (by chunk parity), and
              every block then copies the chunk's records from the
              cluster's slices through distributed shared memory;
  strips      64 px tiles as 8 blocks of 64x8 pixels (512 threads, the
              largest portable cluster);
  uncapped    no register cap;
  split_uncapped  the split staging with no register cap;
  k4_pull     K4's owner block reads the row's partials from each block's
              shared memory (``map_shared_rank``) after the barrier,
              instead of each block storing them into the owner's;
  k4_uncapped K4 with no register cap;
  k4_strips   K4's 64 px tiles as 8 blocks of 64x8 pixels (512 threads);
  k4_skip_test  K4 walking every row of a chunk and testing each row's
              bit, instead of only the reached rows;
  k4_double   K4's slots in two buffers by chunk parity, so one cluster
              barrier a chunk (not two), at 3 blocks an SM (not 4);

and at 8 px, where the shipped K2 and K3 (1) stage a chunk with all 128
threads, one row each, and (2) split the chunk's live rows [lo, hi)
evenly between the two thread groups at (lo + hi) / 2; (3) is a third
design part, not shipped: each warp skips the instances whose support
rectangle (``support_mask``, a bit for each 8x4 half of the tile) misses
its four pixel rows:

  parent8     none of the three: the first group of 64 threads stages,
              two rows each, the groups take the chunk's fixed halves
              [lo, 64) and [64, hi) (the design before them);
  stage8, split8, skip8  design part (1), (2) or (3) alone;
  all8        all three parts;
  double8     the shipped design with the chunk records in two buffers by
              chunk parity: chunk c + 1 is staged after chunk c's vote,
              before chunk c is walked, so two barriers a chunk (not
              three); a tile that stops has staged one chunk for nothing;
  quarter8    two pixels a thread and four one-warp groups, each walking
              a quarter of the live rows over the whole tile, the four
              segments joined in order;
  four8       one pixel a thread and four 64-thread groups (256 threads),
              each walking a quarter of the live rows, joined in order:
              quarter8's four-segment join without its two pixels a
              thread, from quarter8's own edits (no edit of its own).

With skip8 or all8 it also counts, on the shipped K2's walk at 8 px, the
rows a chunk's slowest warp walks with fixed halves, an even split and
the warp skip (``warp_walks``).

K4 at 8 px ships ``Backward<8>`` of ``rasterize_bwd.cu``: 64 threads, one
pixel each, (1) the warps' partials held half a chunk at a time (HALVES =
2) and (2) the chain rule's fast math (FAST_MATH: ``__expf`` for alpha and
T, ``__fdividef`` for the division by 1 - alpha); its variants:

  parent8_k4  neither: the partials of the whole chunk at once and the
              exact expf and division (the design before);
  k4_exact8   (1) alone;
  k4_fdiv8    (1) and the fast division alone;
  k4_fdiv_fexp8  (1), the fast division and the fast exp for T (expf for
              alpha);
  split8_k4   the split walk (``Backward8Split``, inserted): GROUPS = 4
              groups of 64 threads, each the whole tile, cut each chunk's
              live rows into contiguous segments of at least MIN_ROWS = 16
              rows, one a group, joined by a per-pixel pre-pass of each
              segment's sum of log(1 - alpha) and of alpha exp(l) (g . c);
  k4_groups2  split8_k4 with two groups (128 threads);
  k4_rows8, k4_rows32  split8_k4 with MIN_ROWS 8 or 32;
  k4_cap6, k4_cap8  split8_k4 with launch bounds that leave room for 6 or
              8 blocks an SM (a register cap of 40 or 32);
  k4_keep_s   split8_k4 with each live fragment's s = log(1 - alpha) kept
              in 32 KB of dynamic shared memory by the pre-pass and read
              by the walk in place of its log1p;
  k4_groups1  split8_k4 with one group of 64 threads (two rows each to
              stage and write): the parent's walk on its code;
  k4_pairs    split8_k4 walking two rows a step, the second row's fragment
              math predicated, both rows' 20 sums in one reduce-scatter
              butterfly (21 shuffles for two rows, not 24);
  k4_pairs1   k4_pairs on one group (k4_groups1);
  warp8_k4    one warp a tile, two pixels a thread (``Backward8Warp``,
              inserted): one butterfly an instance and no partials in
              shared memory; the lanes that hold the tile's sums write the
              row;
  k4_warp_ilp warp8_k4 with the two pixels computed with no branch on each
              one's hit.

On ``chip_smoke.py``'s 1M-splat 1920x1080 frame it times, per variant and
edge, K2 (32-byte rows, at the camera the bins were built for), K3 (at an
orbit eye) and K4 (16-byte rows, a seeded cotangent, as in training) by
CUDA events (``chip_smoke.kernel_ms``), the kernels a variant changes,
and at 8 px the device busy time of the 16-byte redraw (``render_binned``
through K3 at that eye) by torch.profiler (``chip_smoke.traced_busy``);
and at 8 px K4 also on 32-byte rows, on the deepest tile alone and on
the frame without its deepest 1% of tiles (chip_smoke.py's ``[tail]``
cases, ``k4_tail_cases``); prints each instantiation's registers, local
memory a thread and occupancy, and checks that its outputs equal the
shipped kernels' bit for bit (every variant computes the same sums in the
same order; K4 in 64x8 strips adds them in another, and is held to
chip_smoke.py's K4_TOL_FULL of the shipped rows, as is an 8 px K4 variant
whose rows are not bit-equal; the 8 px K2/K3 variants that split a chunk
otherwise are held to K2_TOL / K3_TOL of the plain versions on
chip_smoke.py's 64 sampled tiles, with chunks_done one value a tile).
Ends with the card's name and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "splatjax_torch", "csrc")
OUT = os.path.join(HERE, "build", "cluster_variants")
EDGES = (8, 32, 64)
# (source file, anchor in it, what replaces the anchor)
STRIPS = [(
    "composite.cuh", "// The block geometry of a TILE x TILE tile",
    "template <>\nstruct SubBlock<64> {\n  static constexpr int W = 64;\n"
    "  static constexpr int H = 8;\n};\n\n"
    "// The block geometry of a TILE x TILE tile")]
SPLIT = [(
    "composite.cuh", "template <int TILE, class Source>\n"
    "__device__ __forceinline__ void composite_tile(",
    """template <int SLICE>
struct Slices {
  float4 rec[2][3][SLICE];
};
template <int SLICE>
__device__ __forceinline__ Slices<SLICE>& slices() {
  __shared__ Slices<SLICE> s;
  return s;
}

template <int TILE, class Source>
__device__ __forceinline__ void composite_tile("""), (
    "composite.cuh",
    "      if (!cluster_alive<C>(__syncthreads_or(alive), c)) break;",
    """      constexpr int SLICE = CHUNK / C;
      {  // this block's slice, before the barrier
        const int base = astart + c * CHUNK;
        const int r = rank * SLICE + tid;
        auto& mine = slices<SLICE>().rec[c & 1];
        if (tid < SLICE && r >= start - base && r < end - base) {
          const Decoded d = src((long long)base + r);
          power_records<EXACT>(d, d.mx - ox, d.my - oy, mine[0][tid],
                               mine[1][tid]);
          const unsigned mask = support_mask<TILE, G::SUB_W, G::SUB_H>(
              d, d.mx - ox, d.my - oy, logf(fmaxf(d.opa, 1e-30f)));
          mine[2][tid] = make_float4(d.r, d.g, d.b, __uint_as_float(mask));
        }
      }
      if (!cluster_alive<C>(__syncthreads_or(alive), c)) break;"""), (
    "composite.cuh",
    "    if (tid < CHUNK && tid >= lo && tid < hi) stage(base, tid);\n",
    """    if constexpr (C > 1) {  // the chunk's records from the slices
      constexpr int SLICE = CHUNK / C;
      coop::cluster_group cluster = coop::this_cluster();
      auto& rec = slices<SLICE>().rec[c & 1];
      for (int k = tid; k < 3 * CHUNK; k += G::THREADS) {
        const int kind = k / CHUNK, r = k % CHUNK;
        if (r < lo || r >= hi) continue;
        const float4 v = *cluster.map_shared_rank(
            &rec[kind][r % SLICE], (unsigned)(r / SLICE));
        (kind == 0 ? s_pow : kind == 1 ? s_cut : s_col)[r] = v;
      }
    } else if (tid < CHUNK && tid >= lo && tid < hi) {
      stage(base, tid);
    }
""")]

# the cluster kernels without their 64-register cap
UNCAPPED = [(f, "__launch_bounds__(Composite<TILE>::THREADS,\n"
             "                                  Composite<TILE>::MIN_BLOCKS)",
             "__launch_bounds__(Composite<TILE>::THREADS)")
            for f in ("rasterize_fwd.cu", "rasterize_cached.cu")]

BWD = "rasterize_bwd.cu"
K4_PULL = [(
    BWD, """      float4* dst = cluster.map_shared_rank(
          &s_slot[(tid % OWNED) * C + rank][0],
          (unsigned)(tid / OWNED));""",
    "      float4* dst = &s_slot[tid][0];"), (
    BWD, "        const float4* in = &s_slot[tid * C + b][0];",
    "        const float4* in = cluster.map_shared_rank(&s_slot[r][0], b);")]
K4_UNCAPPED = [(
    BWD, "__launch_bounds__(BackwardCluster<TILE>::THREADS,\n"
    "                                  BackwardCluster<TILE>::MIN_BLOCKS)",
    "__launch_bounds__(BackwardCluster<TILE>::THREADS)")]
K4_STRIPS = [(
    BWD, "template <int TILE>\nstruct BackwardCluster {",
    "template <>\nstruct BackwardSub<64> {\n  static constexpr int W = 64;\n"
    "  static constexpr int H = 8;\n};\n\n"
    "template <int TILE>\nstruct BackwardCluster {")]
K4_SKIP_TEST = [(
    BWD, """    for (int wr = CHUNK / 32 - 1; wr >= 0; --wr) {
      for (unsigned bits = s_reach[wr]; bits != 0;) {
        const int i = wr * 32 + 31 - __clz(bits);
        bits &= ~(1u << (i % 32));""",
    """    for (int wr = 0; wr < 1; ++wr) {
      for (int i = hi - 1; i >= lo; --i) {
        if (!((s_mask[i] >> rank) & 1u)) continue;""")]

K4_DOUBLE = [(
    BWD, "SLOT_BYTES = CHUNK * 3 * 16;", "SLOT_BYTES = 2 * CHUNK * 3 * 16;"), (
    BWD, "&s_slot[(tid % OWNED) * C + rank][0]",
    "&s_slot[(c & 1) * CHUNK + (tid % OWNED) * C + rank][0]"), (
    BWD, "&s_slot[tid * C + b][0]", "&s_slot[(c & 1) * CHUNK + tid * C + b][0]"), (
    BWD, "    cluster_wait();  // the owners have read the slots",
    "    if (c == c_done - 1) cluster_wait();"), (
    BWD, "    cluster_arrive();\n  }\n  cluster_wait();\n}",
    "  }\n  if (c_done == 0) cluster_wait();\n}")]

CUH = "composite.cuh"
# the shipped 8 px design's two parts, each taken back to the design
# before it, and the warp skip put in
HALF_STAGES = [(
    CUH, "    if (tid < CHUNK && tid >= lo && tid < hi) stage(base, tid);\n",
    """    if constexpr (TILE == 8) {  // the first group, two rows each
      if (tid < GROUP) {
        for (int r = tid; r < CHUNK; r += GROUP) {
          if (r >= lo && r < hi) stage(base, r);
        }
      }
    } else if (tid < CHUNK && tid >= lo && tid < hi) {
      stage(base, tid);
    }
""")]
FIXED_HALVES = [(
    CUH, """    const int h_lo = TILE == 8 ? (half == 0 ? lo : mid) : max(lo, half * HALF);
    const int h_hi =
        TILE == 8 ? (half == 0 ? mid : hi) : min(hi, half * HALF + HALF);""",
    """    const int h_lo = max(lo, half * HALF);
    const int h_hi = min(hi, half * HALF + HALF);""")]
SKIP = [(
    CUH, """        if (!((__float_as_uint(s_col[i].w) >> rank) & 1u)) continue;
      }""", """        if (!((__float_as_uint(s_col[i].w) >> rank) & 1u)) continue;
      } else if constexpr (TILE == 8) {  // or this warp's 8x4 rows
        if (!((__float_as_uint(s_col[i].w) >> (q / 32)) & 1u)) continue;
      }"""), (
    CUH, """    if constexpr (C == 1) {
      s_col[r] = make_float4(d.r, d.g, d.b, 0.0f);
    } else {
      const unsigned mask = support_mask<TILE, G::SUB_W, G::SUB_H>(""",
    """    if constexpr (C == 1 && TILE != 8) {
      s_col[r] = make_float4(d.r, d.g, d.b, 0.0f);
    } else {
      const unsigned mask =
          support_mask<TILE, G::SUB_W, TILE == 8 ? 4 : G::SUB_H>(""")]
DOUBLE8 = [(CUH, f"  __shared__ float4 {name}[CHUNK];",
            f"  __shared__ float4 {name}[2 * CHUNK];")
           for name in ("s_pow", "s_cut", "s_col")] + [(
    CUH, "  int c = 0;\n  for (; c < n_chunks; ++c) {",
    """  if (n_chunks > 0 && tid >= start - astart && tid < min(end - astart, CHUNK)) {
    stage(astart, tid);  // chunk 0 into buffer 0
  }
  int c = 0;
  for (; c < n_chunks; ++c) {"""), (
    CUH, """    if (tid < CHUNK && tid >= lo && tid < hi) stage(base, tid);
    __syncthreads();
""", """    if (c + 1 < n_chunks) {  // chunk c + 1 into the other buffer
      const int next = base + CHUNK, buf = ((c + 1) & 1) * CHUNK;
      if (tid < min(end - next, CHUNK)) stage(next - buf, buf + tid);
    }
"""), (
    CUH, "    for (int i = h_lo; i < h_hi; ++i) {",
    """    const int cur = (c & 1) * CHUNK;
    for (int i = cur + h_lo; i < cur + h_hi; ++i) {""")]
QUARTER8 = [(
    CUH, "  static constexpr int PIX = SUB_P > CHUNK ? 2 : 1;",
    "  static constexpr int PIX = SUB_P > CHUNK || TILE == 8 ? 2 : 1;"), (
    CUH, "  static constexpr int THREADS = 2 * GROUP;",
    "  static constexpr int THREADS = (TILE == 8 ? 4 : 2) * GROUP;"), (
    CUH, "  __shared__ float4 s_back[G::SUB_P];",
    "  __shared__ float4 s_back[3 * G::SUB_P];"), (
    CUH, "  __shared__ float s_back_lt[G::SUB_P];",
    "  __shared__ float s_back_lt[3 * G::SUB_P];"), (
    CUH, """    const int h_lo = TILE == 8 ? (half == 0 ? lo : mid) : max(lo, half * HALF);
    const int h_hi =
        TILE == 8 ? (half == 0 ? mid : hi) : min(hi, half * HALF + HALF);""",
    """    const int h_lo = TILE == 8 ? lo + (hi - lo) * half / 4
                               : max(lo, half * HALF);
    const int h_hi = TILE == 8 ? lo + (hi - lo) * (half + 1) / 4
                               : min(hi, half * HALF + HALF);"""), (
    CUH, """    if (half == 1) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        s_back[back[j]] = make_float4(cr[j], cg[j], cbl[j], cd[j]);
        s_back_lt[back[j]] = s_ex[j];""", """    if (half >= 1) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        const int k = (half - 1) * G::SUB_P + back[j];
        s_back[k] = make_float4(cr[j], cg[j], cbl[j], cd[j]);
        s_back_lt[k] = s_ex[j];"""), (
    CUH, """        const float4 bk = s_back[back[j]];
        const float tf = expf(s_ex[j]);
        cr[j] += tf * bk.x;
        cg[j] += tf * bk.y;
        cbl[j] += tf * bk.z;
        cd[j] += tf * bk.w;
        s_ex[j] += s_back_lt[back[j]];""", """        for (int g = 0; g < G::THREADS / GROUP - 1; ++g) {
          const float4 bk = s_back[g * G::SUB_P + back[j]];
          const float tf = expf(s_ex[j]);
          cr[j] += tf * bk.x;
          cg[j] += tf * bk.y;
          cbl[j] += tf * bk.z;
          cd[j] += tf * bk.w;
          s_ex[j] += s_back_lt[g * G::SUB_P + back[j]];
        }""")]

# K4 at 8 px. The shipped kernel is Backward<8>, 64 threads, one pixel
# each, with its warps' partials held half a chunk at a time; the parent's
# held the whole chunk's. Two other kernels are inserted beside it and
# launched at 8 px in its place: the split walk (Backward8Split), with its
# thread groups, its fewest rows a segment, a register cap, each
# fragment's s kept from the pre-pass, or rows in pairs; and one warp a
# tile (Backward8Warp).
K4_EXACT8 = [(BWD, "  static constexpr bool FAST_MATH = TILE == 8;",
              "  static constexpr bool FAST_MATH = false;")]
PARENT8_K4 = [(BWD, "  static constexpr int HALVES = TILE == 8 ? 2 : 1;",
               "  static constexpr int HALVES = 1;"), (
    BWD, """        static_assert(THREADS >= CHUNK, "thread r adds chunk row r");
        if (tid >= lo && tid < hi) {
          write_grad_row<PACKED16, NWARPS>(s_part, s_pow, s_cut, s_aux, base,
                                           tid, grad);
        }""", """        for (int r = tid; r < CHUNK; r += THREADS) {
          if (r >= lo && r < hi) {
            write_grad_row<PACKED16, NWARPS>(s_part, s_pow, s_cut, s_aux,
                                             base, r, grad);
          }
        }""")] + K4_EXACT8
# the exact expf for alpha, and for T, with the fast division kept
K4_EXACT_ALPHA = [(
    BWD, "            const float alpha = G::FAST_MATH ? __expf(pe) : expf(pe);",
    "            const float alpha = expf(pe);")]
K4_EXACT_T = [(
    BWD, "            const float tk = G::FAST_MATH ? __expf(lt_k) : expf(lt_k);",
    "            const float tk = expf(lt_k);")]


def insert_8px(text, kernel, block):
    """The edits that put ``text`` (the definitions of the kernel template
    ``kernel`` over PACKED16 and its block geometry ``block``) before the
    cluster kernel and launch it at 8 px."""
    return [(
        BWD, "// The thread-block cluster of a TILE x TILE tile at 32 and 64 px",
        text + "\n// The thread-block cluster of a TILE x TILE tile at 32 and "
        "64 px"), (
        BWD, "  if constexpr (TILE > 16) {\n"
        "    return rasterize_bwd_cluster_kernel<TILE, PACKED16>;\n"
        "  } else {",
        "  if constexpr (TILE > 16) {\n"
        "    return rasterize_bwd_cluster_kernel<TILE, PACKED16>;\n"
        f"  }} else if constexpr (TILE == 8) {{\n"
        f"    return {kernel}<PACKED16>;\n"
        "  } else {"), (
        BWD, "template <>\nstruct BwdLaunch<32> : BackwardCluster<32> {};",
        "template <>\nstruct BwdLaunch<8> {\n"
        "  static constexpr int CLUSTER = 1;\n"
        f"  static constexpr int THREADS = {block}::THREADS;\n"
        "  static constexpr int DYN_BYTES = 0;\n};\n"
        "template <>\nstruct BwdLaunch<32> : BackwardCluster<32> {};")]


SPLIT8_KERNEL = """\
// The block of an 8 x 8 tile: GROUPS groups of 64 threads, each group the
// whole tile, one pixel a thread. One group walking a tile alone (64
// threads, as Backward<8> would) carries log T and S from row to row, so a
// deep tile's rows run one after another on two warps, each a dependent
// chain of shared loads, exp, log1p, exp, a division and the 5-level
// butterfly: the deepest tile of the 1M-splat 1920x1080 frame alone took
// 0.67 of the whole frame's K4 (PERF.md). So, as splatjax's kernel forms
// log T and S over a chunk by triangular matmuls, the groups split it:
// * the chunk's live rows [lo, hi), n of them, are cut into nseg =
//   min(GROUPS, n / MIN_ROWS) contiguous segments (one where n <=
//   MIN_ROWS), segment g = [hi - n (g + 1) / nseg, hi - n g / nseg), so
//   segment 0 is the back-most; group g walks segment g;
// * a pre-pass joins them: group g walks its segment front to back and
//   keeps, per pixel, L_g = the sum of s = log(1 - alpha) over its live
//   fragments and U_g = the sum of alpha_k exp(l_k) (g . c)_k, l_k the sum
//   of s over the segment's rows in front of k (l_k <= 0: nothing
//   overflows). From the chunk's back-edge state (lt, S), each pixel
//   forms segment g's start state, lt - sum_{h<g} L_h and S + sum_{h<g}
//   exp(lt_front_h) U_h, lt_front_h = lt - sum_{h'<=h} L_h' the log T in
//   front of segment h, summed over h in order, and the next chunk's
//   state by the same sums over every
//   segment: every group forms them alike, bit for bit. The state stays
//   in the log domain, so a stack whose T underflows keeps its front
//   gradients;
// * group g then walks its segment back to front from its start state, as
//   Backward<16> walks a chunk, into the partials of its two warps; the
//   segments are disjoint, so the groups share one s_part. A chunk of one
//   segment is walked by group 0 alone, with no pre-pass, which leaves its
//   end state in shared memory for the others.
// This reassociates each chunk's sums of log T and S (held to 1e-4 of each
// channel's max of the plain version). Two runs stay bit-identical.
struct Backward8Split {
  static constexpr int TILE = 8;
  static constexpr int P = TILE * TILE;
  static constexpr int GROUPS = 4;
  static constexpr int THREADS = GROUPS * P;
  static constexpr int MIN_ROWS = 16;  // the fewest rows a segment takes
  static_assert(THREADS >= CHUNK, "thread r stages and writes chunk row r");
};

template <bool PACKED16>
__global__ void __launch_bounds__(Backward8Split::THREADS)
rasterize_bwd8_split_kernel(const int4* __restrict__ rows,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends,
                      const int* __restrict__ order,
                      const float* __restrict__ out_saved,
                      const float* __restrict__ g_out, int gch,
                      const float* __restrict__ zbuf, void* __restrict__ grad,
                      int tiles_x, int has_clip, float log_clip,
                      int clamp_log_om, int om_floor) {
  using G = Backward8Split;
  constexpr int TILE = G::TILE, P = G::P;
  constexpr bool EXACT = ExactPower<TILE>::value;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, mean x - tile centre x
  __shared__ float2 s_aux[CHUNK];  // mean y - tile centre y, opacity
  __shared__ float s_part[2][CHUNK][NSUM];  // a group's two warps
  __shared__ float2 s_seg[G::GROUPS][P];    // (L, U) of each segment
  __shared__ float2 s_state[P];  // (log T, S) after a one-segment chunk

  const int t = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int group = tid / P, q = tid % P;  // q: the thread's pixel
  const int lane = tid % 32;
  const int slot = scatter_slot(lane);
  float* const part = slot >= 0 ? &s_part[q / 32][0][slot] : nullptr;
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const float* saved = out_saved + (long long)t * OUT_ROWS * P;
  const int c_done = (int)saved[4 * P];

  const float x = (float)(q % TILE) + 0.5f - 0.5f * TILE;
  const float xx = x * x;
  float y[1], xy[1], yy[1], zb[1];
  y[0] = (float)(q / TILE) + 0.5f - 0.5f * TILE;
  xy[0] = x * y[0];
  yy[0] = y[0] * y[0];
  zb[0] = zbuf != nullptr ? zbuf[(long long)t * P + q] : -CUDART_INF_F;
  const float ox = (float)((t % tiles_x) * TILE) + 0.5f * TILE;
  const float oy = (float)((t / tiles_x) * TILE) + 0.5f * TILE;
  const float* go = g_out + (long long)t * gch * P;
  const float gr = go[0 * P + q], gg = go[1 * P + q];
  const float gb = go[2 * P + q];
  const float gd = gch > 4 ? go[5 * P + q] : 0.0f;
  float lt = saved[6 * P + q];  // log T behind the chunk
  const float gtt = go[3 * P + q] * expf(lt);
  float S = 0.0f;  // sum over the fragments behind the chunk of alpha T (g . c)

  for (int c = c_done - 1; c >= 0; --c) {
    const int base = astart + c * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    __syncthreads();  // the previous chunk's readers of shared memory
    if (tid >= lo && tid < hi) {  // hi <= 128: the first 128 threads
      stage_row<PACKED16, EXACT>(rows, base, tid, ox, oy, s_pow, s_cut,
                                 s_col, s_aux);
    }
    __syncthreads();

    const int n = hi - lo;
    const int nseg = n > G::MIN_ROWS ? min(G::GROUPS, n / G::MIN_ROWS) : 1;
    const int seg_hi = hi - n * group / nseg;
    const int seg_lo = hi - n * (group + 1) / nseg;
    float lt_after = lt;  // log T behind the current instance
    float s_behind = S;   // alpha T (g . c) summed behind it
    if (nseg > 1) {
      if (group < nseg) {  // the pre-pass, front to back
        float l = 0.0f, u = 0.0f;
        for (int i = seg_lo; i < seg_hi; ++i) {
          const float4 ct = s_cut[i];
          float power[1];
          bool hit[1];
          eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy, zb, power, hit);
          if (hit[0]) {
            const float4 col = s_col[i];
            const float pe = has_clip ? fminf(power[0], log_clip) : power[0];
            const float alpha = expf(pe);
            float s = log1pf(-alpha);
            if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
            const float gdotc =
                gr * col.x + gg * col.y + gb * col.z + gd * ct.w;
            u += alpha * expf(l) * gdotc;
            l += s;
          }
        }
        s_seg[group][q] = make_float2(l, u);
      }
      __syncthreads();
      // the segments' start states, back to front, and the chunk's end
      float lt_h = lt, s_h = S;
      for (int h = 0; h < nseg; ++h) {
        if (h == group) {
          lt_after = lt_h;
          s_behind = s_h;
        }
        const float2 lu = s_seg[h][q];
        lt_h -= lu.x;  // log T in front of segment h
        s_h += expf(lt_h) * lu.y;
      }
      lt = lt_h;
      S = s_h;
    }

    if (group < nseg) {  // the segment, back to front
      for (int i = seg_hi - 1; i >= seg_lo; --i) {
        const float4 ct = s_cut[i];
        float power[1];
        bool hit[1];
        const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy,
                                           zb, power, hit);
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
          float g_alpha = tg - (s_behind + gtt) / om;
          if (has_clip && !(power[0] < log_clip)) g_alpha = 0.0f;
          const float g_pow = g_alpha * alpha;
          const float w = alpha * tk;
          s_behind += alpha * tg;
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
    if (nseg == 1 && group == 0) s_state[q] = make_float2(lt_after, s_behind);
    __syncthreads();
    if (nseg == 1) {  // group 0's end state
      const float2 st = s_state[q];
      lt = st.x;
      S = st.y;
    }

    if (tid >= lo && tid < hi) {
      write_grad_row<PACKED16, 2>(s_part, s_pow, s_cut, s_aux, base, tid,
                                  grad);
    }
  }
}
"""
SPLIT8 = insert_8px(SPLIT8_KERNEL, "rasterize_bwd8_split_kernel",
                    "Backward8Split")
K4_GROUPS2 = [(BWD, "  static constexpr int GROUPS = 4;",
               "  static constexpr int GROUPS = 2;")]


def k4_min_rows(n):
    return [(BWD, "  static constexpr int MIN_ROWS = 16;",
             f"  static constexpr int MIN_ROWS = {n};")]


def k4_cap(blocks):
    return [(BWD, "__global__ void __launch_bounds__(Backward8Split::THREADS)"
             "\n", f"__global__ void __launch_bounds__(Backward8Split::"
             f"THREADS, {blocks})\n")]


K4_KEEP_S = [(
    BWD, "  __shared__ float2 s_state[P];  // (log T, S) after a one-segment "
    "chunk\n",
    "  __shared__ float2 s_state[P];  // (log T, S) after a one-segment "
    "chunk\n  extern __shared__ float s_keep[];  // the pre-pass's s\n"), (
    BWD, "            l += s;\n",
    "            l += s;\n            s_keep[i * P + q] = s;\n"), (
    BWD, """          float s = log1pf(-alpha);
          if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
          const float lt_k = lt_after - s;  // log T in front of i
          const float tk = expf(lt_k);
          const float gdotc = gr * col.x + gg * col.y + gb * col.z + gd * ct.w;
          const float tg = tk * gdotc;
          float om = 1.0f - alpha;
          if (om_floor) om = om > 1e-6f ? om : 1e-6f;
          float g_alpha = tg - (s_behind + gtt) / om;""",
    """          float s;
          if (nseg > 1) {
            s = s_keep[i * P + q];
          } else {
            s = log1pf(-alpha);
            if (clamp_log_om) s = fmaxf(s, LOG_OM_MIN);
          }
          const float lt_k = lt_after - s;  // log T in front of i
          const float tk = expf(lt_k);
          const float gdotc = gr * col.x + gg * col.y + gb * col.z + gd * ct.w;
          const float tg = tk * gdotc;
          float om = 1.0f - alpha;
          if (om_floor) om = om > 1e-6f ? om : 1e-6f;
          float g_alpha = tg - (s_behind + gtt) / om;"""), (
    BWD, "  static constexpr int DYN_BYTES = 0;\n};\ntemplate <>\n"
    "struct BwdLaunch<32>",
    "  static constexpr int DYN_BYTES = CHUNK * Backward8Split::P * 4;\n};\n"
    "template <>\nstruct BwdLaunch<32>")]

# the split walk with one group (64 threads, so each thread stages and
# writes two rows): the parent's walk on its code, nseg always 1
K4_GROUPS1 = [(
    BWD, "  static constexpr int GROUPS = 4;",
    "  static constexpr int GROUPS = 1;"), (
    BWD, '  static_assert(THREADS >= CHUNK, "thread r stages and writes chunk '
    'row r");',
    '  static_assert(CHUNK % THREADS == 0, "whole rounds of rows");'), (
    BWD, """    if (tid >= lo && tid < hi) {  // hi <= 128: the first 128 threads
      stage_row<PACKED16, EXACT>(rows, base, tid, ox, oy, s_pow, s_cut,
                                 s_col, s_aux);
    }""", """    for (int r = tid; r < CHUNK; r += G::THREADS) {
      if (r >= lo && r < hi) {
        stage_row<PACKED16, EXACT>(rows, base, r, ox, oy, s_pow, s_cut,
                                   s_col, s_aux);
      }
    }"""), (
    BWD, """    if (tid >= lo && tid < hi) {
      write_grad_row<PACKED16, 2>(s_part, s_pow, s_cut, s_aux, base, tid,
                                  grad);
    }""", """    for (int r = tid; r < CHUNK; r += G::THREADS) {
      if (r >= lo && r < hi) {
        write_grad_row<PACKED16, 2>(s_part, s_pow, s_cut, s_aux, base, r,
                                    grad);
      }
    }""")]
# the split walk two rows a step: the second row's fragment math
# predicated, and both rows' 20 sums in one reduce-scatter butterfly (21
# shuffles, not 24)
K4_PAIRS = [(
    BWD, "// The block of an 8 x 8 tile: GROUPS groups",
    """// Which of two rows' 20 sums warp_reduce_scatter20 leaves on `lane`, or
// -1: 10 b4 + 5 b3 + j, j = 0, 1, 2, 3, 4 for (b2, b1, b0) = 000, 001,
// 010, 100, 101.
__device__ __forceinline__ int scatter_slot20(int lane) {
  const int j4 = (lane & 1) + ((lane >> 1) & 1) * 2;
  const int j3 = j4 + ((lane >> 2) & 1) * 3;
  return j4 >= 3 || j3 >= 5 ? -1 : 10 * ((lane >> 4) & 1) +
                                       5 * ((lane >> 3) & 1) + j3;
}

// Sums v[0..19] over the 32 lanes of a warp: 20 -> 10 (xor 16), 10 -> 5
// (xor 8), 5 -> 3 (xor 4, one padded), 3 -> 2 (xor 2, one padded), 2 -> 1
// (xor 1). Returns the warp sum of v[scatter_slot20(lane)] where that is
// >= 0.
__device__ __forceinline__ float warp_reduce_scatter20(
    const float (&v)[2 * NSUM], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  const bool b0 = lane & 1;
  float w[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const float keep = b4 ? v[m + 10] : v[m];
    const float send = b4 ? v[m] : v[m + 10];
    w[m] = keep + __shfl_xor_sync(FULL, send, 16);
  }
  float u[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const float keep = b3 ? w[m + 5] : w[m];
    const float send = b3 ? w[m] : w[m + 5];
    u[m] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  float z[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float upper = m + 3 < 5 ? u[m + 3] : 0.0f;
    const float keep = b2 ? upper : u[m];
    const float send = b2 ? u[m] : upper;
    z[m] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  float p[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float upper = m + 2 < 3 ? z[m + 2] : 0.0f;
    const float keep = b1 ? upper : z[m];
    const float send = b1 ? z[m] : upper;
    p[m] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  return (b0 ? p[1] : p[0]) + __shfl_xor_sync(FULL, b0 ? p[0] : p[1], 1);
}

// The block of an 8 x 8 tile: GROUPS groups"""), (
    BWD, "  float* const part = slot >= 0 ? &s_part[q / 32][0][slot] : "
    "nullptr;\n",
    "  const int slot20 = scatter_slot20(lane), row20 = slot20 / NSUM;\n"
    "  float* const part20 =\n"
    "      slot20 >= 0 ? &s_part[q / 32][0][slot20 % NSUM] : nullptr;\n"), (
    BWD, """      for (int i = seg_hi - 1; i >= seg_lo; --i) {
        const float4 ct = s_cut[i];
        float power[1];
        bool hit[1];
        const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy,
                                           zb, power, hit);
        float v[NSUM];""", """      for (int i0 = seg_hi - 1; i0 >= seg_lo; i0 -= 2) {
        const bool two = i0 - 1 >= seg_lo;
        float v2[2 * NSUM];
        bool any2 = false;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
        const int i = two ? i0 - r : i0;
        const float4 ct = s_cut[i];
        float power[1];
        bool hit[1];
        const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy,
                                           zb, power, hit) &&
                         (r == 0 || two);
        float* const v = v2 + r * NSUM;"""), (
    BWD, """        const float sum =
            __any_sync(FULL, any) ? warp_reduce_scatter(v, lane) : 0.0f;
        if (part != nullptr) part[i * NSUM] = sum;
      }
    }
    if (nseg == 1 && group == 0)""", """        any2 |= any;
        }
        const float sum =
            __any_sync(FULL, any2) ? warp_reduce_scatter20(v2, lane) : 0.0f;
        if (part20 != nullptr && (row20 == 0 || two)) {
          part20[(i0 - row20) * NSUM] = sum;
        }
      }
    }
    if (nseg == 1 && group == 0)""")]

WARP8_KERNEL = """\
// The lanes that warp_reduce_scatter leaves sums 0, 1, 2 and 9 on.
constexpr int SUM0_LANE = 0, SUM1_LANE = 2, SUM2_LANE = 4, SUM9_LANE = 26;

// Instance base + r's gradient row from a whole tile's sums of chunk row r,
// one sum a lane as warp_reduce_scatter leaves them (sum `slot`, or none
// where slot < 0): the lanes of sums 1 and 2 swap them for the mean's two
// channels, and for bf16 pairs also take sums 0 and 9, the opacity and
// depth channels that pair with channels 0 and 1. Each lane then writes its
// channel (f32) or its pair (bf16) into the zero-filled output, in
// store_grad_row's arithmetic; channels 10-15 stay zero.
template <bool PACKED16>
__device__ __forceinline__ void store_grad_sums(float sum, int slot, int lane,
                                                const float4* s_pow,
                                                const float4* s_cut,
                                                const float2* s_aux, int base,
                                                int r,
                                                void* __restrict__ grad) {
  const float other =
      __shfl_sync(FULL, sum, lane == SUM1_LANE ? SUM2_LANE : SUM1_LANE);
  const float extra = PACKED16 ? __shfl_sync(FULL, sum, lane == SUM1_LANE
                                                              ? SUM0_LANE
                                                              : SUM9_LANE)
                               : 0.0f;
  if (slot < 0) return;
  const float opa = s_aux[r].y;
  const float opa_c = fabsf(opa) > 1e-12f ? opa : 1e-12f;
  const long long kk = (long long)base + r;
  float ch;
  int c;  // the channel: slot 0 -> 8 (opacity), 1 -> 0, 2 -> 1, k -> k - 1
  if (slot == 1 || slot == 2) {
    // the conic from its exact power coefficients (-ca/2, -cb, -cc/2)
    const float ca = -2.0f * s_pow[r].w, cb = -s_cut[r].x;
    const float cc = -2.0f * s_cut[r].y;
    ch = slot == 1 ? ca * sum + cb * other : cb * other + cc * sum;
    c = slot - 1;
  } else if (slot == 0) {
    ch = sum / opa_c;
    c = 8;
  } else {
    ch = slot == 3 || slot == 5 ? -0.5f * sum : slot == 4 ? -sum : sum;
    c = slot == 9 ? 9 : slot - 1;
  }
  if (PACKED16) {
    if (c >= 8) return;  // carried by the lanes of channels 0 and 1
    const float hi = slot == 1 ? extra / opa_c : slot == 2 ? extra : 0.0f;
    reinterpret_cast<int*>(grad)[8 * kk + c] = pack_pair(ch, hi);
  } else {
    reinterpret_cast<float*>(grad)[16 * kk + c] = ch;
  }
}

// The block of an 8 x 8 tile: one warp, two pixels a thread (rows py and
// py + 4 of column px). A block of 64 threads, one pixel each (Backward<8>),
// reduces each instance twice, once a warp, into warps' partials in shared
// memory that one thread a row then adds after a barrier. Its K4 on the
// 1M-splat 1920x1080 frame took 0.90 ms without the deepest 1% of tiles
// and 1.00 ms with them, in proportion to the walked instances, so it is
// bound by how much an SM gets through, not by the deepest tile's serial
// walk (0.67 ms alone; PERF.md). One warp a tile reduces each instance
// once, over both its pixels in registers and then the warp, and writes the
// row from the lanes that hold its sums (store_grad_sums): no partials in
// shared memory, no fold, no block barrier, and 7 KB of shared memory a
// tile leave room for more tiles, and twice the pixels, in flight on an SM.
struct Backward8Warp {
  static constexpr int TILE = 8;
  static constexpr int P = TILE * TILE;
  static constexpr int THREADS = 32;
  static constexpr int PIX = P / THREADS;  // pixels a thread, in a column
};

template <bool PACKED16>
__global__ void __launch_bounds__(Backward8Warp::THREADS)
rasterize_bwd8_warp_kernel(const int4* __restrict__ rows,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends,
                      const int* __restrict__ order,
                      const float* __restrict__ out_saved,
                      const float* __restrict__ g_out, int gch,
                      const float* __restrict__ zbuf, void* __restrict__ grad,
                      int tiles_x, int has_clip, float log_clip,
                      int clamp_log_om, int om_floor) {
  using G = Backward8Warp;
  constexpr int TILE = G::TILE, P = G::P, PIX = G::PIX;
  constexpr bool EXACT = ExactPower<TILE>::value;
  __shared__ float4 s_pow[CHUNK];  // c0, c1, c2, c3
  __shared__ float4 s_cut[CHUNK];  // c4, c5, log-alpha threshold, depth
  __shared__ float4 s_col[CHUNK];  // r, g, b, mean x - tile centre x
  __shared__ float2 s_aux[CHUNK];  // mean y - tile centre y, opacity

  const int t = order[blockIdx.x];
  const int lane = threadIdx.x;
  const int slot = scatter_slot(lane);
  const int start = starts[t];
  const int end = ends[t];
  const int astart = (start / CHUNK) * CHUNK;
  const float* saved = out_saved + (long long)t * OUT_ROWS * P;
  const int c_done = (int)saved[4 * P];

  const int px = lane % TILE;
  const int py0 = lane / TILE;
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
    const int py = py0 + j * (G::THREADS / TILE);
    const int pp = py * TILE + px;
    y[j] = (float)py + 0.5f - 0.5f * TILE;
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
    __syncwarp();  // the previous chunk's readers of shared memory
    for (int r = lane; r < CHUNK; r += G::THREADS) {
      if (r >= lo && r < hi) {
        stage_row<PACKED16, EXACT>(rows, base, r, ox, oy, s_pow, s_cut,
                                   s_col, s_aux);
      }
    }
    __syncwarp();

    for (int i = hi - 1; i >= lo; --i) {
      const float4 ct = s_cut[i];
      float power[PIX];
      bool hit[PIX];
      const bool any = eval_power<EXACT>(s_pow[i], ct, x, xx, y, xy, yy, zb,
                                         power, hit);
      if (!__any_sync(FULL, any)) continue;  // no fragment: the row stays 0
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
      store_grad_sums<PACKED16>(warp_reduce_scatter(v, lane), slot, lane,
                                s_pow, s_cut, s_aux, base, i, grad);
    }
  }
}
"""
WARP8 = insert_8px(WARP8_KERNEL, "rasterize_bwd8_warp_kernel",
                   "Backward8Warp")
# the one-warp kernel's two pixels a thread computed with no branch on each
# pixel's hit (alpha 0 where it misses), so their chains can interleave
K4_WARP_ILP = [(
    BWD, """      if (!__any_sync(FULL, any)) continue;  // no fragment: the row stays 0
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
          const float alpha = expf(pe);""", """      if (!__any_sync(FULL, any)) continue;  // no fragment: the row stays 0
      float v[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
      if (any) {
        const float4 col = s_col[i];
        const float myl = s_aux[i].x;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          const float pe = has_clip ? fminf(power[j], log_clip) : power[j];
          const float alpha = hit[j] ? expf(pe) : 0.0f;""")]

# variant -> (the kernels it changes, its edits of the sources, the edges
# it is timed at)
FORWARD, BACKWARD = ("K2", "K3"), ("K4",)
WIDE = (32, 64)
VARIANTS = {
    "shipped": (FORWARD + BACKWARD, [], EDGES),
    "split": (FORWARD, SPLIT, WIDE),
    "strips": (FORWARD, STRIPS, WIDE),
    "uncapped": (FORWARD, UNCAPPED, WIDE),
    "split_uncapped": (FORWARD, SPLIT + UNCAPPED, WIDE),
    "k4_pull": (BACKWARD, K4_PULL, WIDE),
    "k4_uncapped": (BACKWARD, K4_UNCAPPED, WIDE),
    "k4_strips": (BACKWARD, K4_STRIPS, WIDE),
    "k4_skip_test": (BACKWARD, K4_SKIP_TEST, WIDE),
    "k4_double": (BACKWARD, K4_DOUBLE, WIDE),
    "parent8": (FORWARD, HALF_STAGES + FIXED_HALVES, (8,)),
    "stage8": (FORWARD, FIXED_HALVES, (8,)),
    "split8": (FORWARD, HALF_STAGES, (8,)),
    "skip8": (FORWARD, HALF_STAGES + FIXED_HALVES + SKIP, (8,)),
    "all8": (FORWARD, SKIP, (8,)),
    "double8": (FORWARD, DOUBLE8, (8,)),
    "quarter8": (FORWARD, QUARTER8, (8,)),
    "four8": (FORWARD, QUARTER8[1:], (8,)),
    "parent8_k4": (BACKWARD, PARENT8_K4, (8,)),
    "split8_k4": (BACKWARD, SPLIT8, (8,)),
    "warp8_k4": (BACKWARD, WARP8, (8,)),
    "k4_exact8": (BACKWARD, K4_EXACT8, (8,)),
    "k4_fdiv8": (BACKWARD, K4_EXACT_ALPHA + K4_EXACT_T, (8,)),
    "k4_fdiv_fexp8": (BACKWARD, K4_EXACT_ALPHA, (8,)),
    "k4_warp_ilp": (BACKWARD, WARP8 + K4_WARP_ILP, (8,)),
    "k4_groups2": (BACKWARD, SPLIT8 + K4_GROUPS2, (8,)),
    "k4_rows8": (BACKWARD, SPLIT8 + k4_min_rows(8), (8,)),
    "k4_rows32": (BACKWARD, SPLIT8 + k4_min_rows(32), (8,)),
    "k4_cap6": (BACKWARD, SPLIT8 + k4_cap(6), (8,)),
    "k4_cap8": (BACKWARD, SPLIT8 + k4_cap(8), (8,)),
    "k4_keep_s": (BACKWARD, SPLIT8 + K4_KEEP_S, (8,)),
    "k4_groups1": (BACKWARD, SPLIT8 + K4_GROUPS1, (8,)),
    "k4_pairs": (BACKWARD, SPLIT8 + K4_PAIRS, (8,)),
    "k4_pairs1": (BACKWARD, SPLIT8 + K4_GROUPS1 + K4_PAIRS, (8,)),
}
# K4 variants that group a 64 px tile's pixels otherwise, so add each
# instance's sums in another order: held to K4_TOL_FULL of the shipped rows
REGROUPED = ("k4_strips",)
# 8 px variants that split a chunk's rows otherwise, so associate its sums
# in another order: held to K2_TOL / K3_TOL of the plain versions
RESPLIT = ("parent8", "stage8", "skip8", "quarter8", "four8")
# kernel -> (its library, C entry, counter)
LIBRARY = {"K2": ("rasterize_fwd", "splat_rasterize_fwd", "rasterize_fwd"),
           "K3": ("rasterize_cached", "splat_rasterize_cached_fwd",
                  "rasterize_cached"),
           "K4": ("rasterize_bwd", "splat_rasterize_bwd", "rasterize_bwd")}


def variant_sources(name: str) -> str:
    """Write variant ``name``'s sources; returns their directory."""
    src = os.path.join(OUT, name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for fname, anchor, new in VARIANTS[name][1]:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        assert text.count(anchor) == 1, f"{name}: {anchor!r} in {fname}"
        with open(path, "w") as f:
            f.write(text.replace(anchor, new))
    return src


def use_sources(src: str) -> None:
    """Point ``splatjax_torch.kernels`` at the sources in ``src``, built
    beside them; drops every loaded library."""
    from pathlib import Path
    from splatjax_torch import kernels

    kernels.CSRC = Path(src)
    kernels.BUILD_DIR = Path(src).parent / "build"
    kernels._libs.clear()
    kernels._functions.clear()


def warp_walks(rows, b, cfg, out) -> None:
    """How the 8 px K2 walk of the frame spreads over its four warps, a
    count of rows that prices the warp skip of skip8 and all8: with
    ``out`` the shipped K2's output on ``b``'s bins (32-byte ``rows``),
    the rows a (tile, chunk)'s slowest warp walks, summed over them, with
    the chunk's fixed halves [lo, 64) and [64, hi), with its live rows
    split evenly at (lo + hi) / 2 (shipped), and split evenly with each
    warp skipping the rows whose support rectangle (``support_rect``)
    misses its 8x4 half of the tile; and the share of walked instances
    that reach each half. Each walked row costs a warp its power
    polynomial and cutoff test."""
    import torch
    import chip_smoke as cs
    from splatjax_torch.ops.rasterize import CHUNK, decode_rows, support_rect

    tile = cfg.tile_w
    starts = b.starts.long()
    walked_ends = starts + cs.walked_per_tile(b, out)
    k = torch.arange(int(walked_ends.max()), device=rows.device)
    t = b.tile_id[:k.numel()].long()
    walked = t < cfg.num_tiles
    t = t.clamp_max(cfg.num_tiles - 1)
    walked &= (k >= starts[t]) & (k < walked_ends[t])
    k, t = k[walked], t[walked]
    f = decode_rows(rows[k], False)
    ox = (t % cfg.tiles_x).float() * tile + 0.5 * tile
    oy = (t // cfg.tiles_x).float() * tile + 0.5 * tile
    x0, x1, y0, y1 = support_rect(f[0] - ox, f[1] - oy, f[2], f[3], f[4],
                                  f[8].clamp_min(1e-30).log(), tile)
    h = 0.5 * tile  # the pixel rows of a half; pixel centres lo .. lo + h - 1
    hit_x = ~((x0 > h - 0.5) | (x1 < 0.5 - h))
    reach = torch.stack([hit_x & ~((y0 > lo + h - 1) | (y1 < lo))
                         for lo in (0.5 - h, 0.5)], dim=1)      # (n, 2)
    off = k - starts[t] // CHUNK * CHUNK
    chunk, i = off // CHUNK, off % CHUNK
    n_chunks = int(chunk.max()) + 1
    uniq, inv = torch.unique(t * n_chunks + chunk, return_inverse=True)
    lo = torch.full((uniq.numel(),), CHUNK, device=k.device).scatter_reduce(
        0, inv, i, "amin")
    hi = torch.zeros_like(lo).scatter_reduce(0, inv, i + 1, "amax")
    back = i >= (lo + hi)[inv] // 2

    def slowest(cols):  # a chunk's slowest warp's rows, summed over chunks
        per = torch.zeros((uniq.numel(), cols.shape[1]), dtype=torch.int64,
                          device=k.device).index_add_(0, inv, cols.long())
        return int(per.amax(1).sum())

    fixed = slowest(torch.stack([i < CHUNK // 2, i >= CHUNK // 2], 1))
    even = slowest(torch.stack([~back, back], 1))
    skip = slowest(torch.cat([reach & ~back[:, None],
                              reach & back[:, None]], 1))
    n = k.numel()
    cs.log(f"[variant] K2 warps at {tile} px: {n} walked rows over "
           f"{uniq.numel()} (tile, chunk)s, {n / uniq.numel():.1f} a chunk; "
           "a chunk's slowest warp walks, summed over them: fixed halves "
           f"{fixed}, live rows split evenly {even}, split evenly with the "
           f"warp skip {skip}; instances reaching rows 0-3 "
           f"{float(reach[:, 0].float().mean()):.3f}, rows 4-7 "
           f"{float(reach[:, 1].float().mean()):.3f}, both "
           f"{float(reach.all(1).float().mean()):.3f}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("cluster_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.io import load_splat, tile_scene
    from splatjax_torch.ops.binning import features_from_projection
    from splatjax_torch.ops.rasterize import (
        gather_rows, pack_table, rasterize_cached_fwd,
        rasterize_cached_fwd_plain, rasterize_fwd, rasterize_fwd_plain,
    )
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd
    from splatjax_torch.render import render_binned

    scene = tile_scene(load_splat(cs.FIXTURE), cs.N_SPLATS)
    cam = make_camera(cs.EYE, (0, 0, 0), width=cs.WIDTH, height=cs.HEIGHT)
    eye = make_camera(cs.ORBIT[1], (0, 0, 0), width=cs.WIDTH,
                      height=cs.HEIGHT)
    start = cs.noisy_start(scene)
    # shipped first; named again, it is timed again there
    names = ["shipped"] + (argv or [v for v in VARIANTS if v != "shipped"])
    # the shipped kernels at the edges of the variants asked for
    edges = sorted({t for n in names if n != "shipped"
                    for t in VARIANTS[n][2]} or EDGES)
    calls, plain = {}, {}
    for tile in edges:
        _, capacity = cs.edge_capacity(scene, start, cam, tile)
        cfg, b, rows = cs.binned_rows(scene, cam, capacity, 1e-4, tile=tile)
        k2 = (rows, b.starts, b.ends, cfg, 0.999, 1e-4)
        _, capacity_e = cs.redraw_capacity(scene, tile)
        bins = cs.cached_bins(scene, cam, capacity_e, tile)
        k3 = cs.k3_args(bins, eye, 0.999, 1e-4, tile)
        calls[tile] = {
            "K2": lambda a=k2: rasterize_fwd(*a),
            "K3": lambda a=k3: rasterize_cached_fwd(*a)}
        if tile == 8:  # the plain versions on the sampled tiles
            walk8 = rows, b, cfg
            calls[tile]["redraw"] = lambda b=bins: render_binned(
                scene, eye, b, tile_size=tile, feature_bytes=16,
                alpha_clip=0.999, early_stop=1e-4)
            t2 = cs.sample_tiles(b, cfg, rows.device)
            t3 = cs.sample_tiles(bins.bins, cfg, rows.device)
            plain[tile, "K2"] = t2, rasterize_fwd_plain(*k2, tiles=t2)
            plain[tile, "K3"] = t3, rasterize_cached_fwd_plain(*k3,
                                                               tiles=t3)
            # K4 as chip_smoke.py's [tail] lines run it, and 32-byte rows
            k4 = cs.k4_case(scene, cam, capacity, False, 0.999, False, 4,
                            tile=tile)[2]
            calls[tile]["K4 32-byte"] = lambda a=k4: rasterize_bwd(*a)
            with torch.no_grad():
                rows16 = gather_rows(pack_table(features_from_projection(
                    cs.projected(scene, cam, 1e-4)), True), b.gauss_id)
            walked = cs.walked_per_tile(b, rasterize_fwd(*k2)).double()
            for case, a in cs.k4_tail_cases(rows16, b, cfg, walked).items():
                key = "K4" if case == "frame" else f"K4 {case}"
                calls[tile][key] = lambda a=a: rasterize_bwd(*a,
                                                             packed16=True)
        else:
            k4 = cs.k4_case(scene, cam, capacity, True, 0.999, False, 4,
                            tile=tile)[2]
            calls[tile]["K4"] = lambda a=k4: rasterize_bwd(*a, packed16=True)
    want = {}
    for name in names:
        changed, _, at = VARIANTS[name]
        at = edges if name == "shipped" else at
        use_sources(variant_sources(name))
        kernels.build(sorted({LIBRARY[k][0] for k in changed}))
        for tile in at:
            if "K3" in changed and "redraw" in calls[tile]:
                busy, _ = cs.traced_busy(calls[tile]["redraw"], 5,
                                         "rasterize_cached")
                cs.log(f"[variant] {name}: 16-byte redraw at {tile} px, "
                       f"device busy {cs.ms_or_not(busy)} ms a frame "
                       "(torch.profiler)")
            for key, fn in calls[tile].items():
                kernel = key.split()[0]
                if kernel not in changed:
                    continue
                packed16 = key != "K4 32-byte"
                lib, entry, counter = LIBRARY[kernel]
                out = fn()
                cs.sync()
                held = "outputs bit-equal to shipped"
                if name == "shipped":
                    want[tile, key] = out
                elif kernel == "K4" and (tile == 8 or (
                        name in REGROUPED and tile == 64)) \
                        and not torch.equal(out, want[tile, key]):
                    cs.compare_k4(out, want[tile, key], packed16,
                                  f"{name} against shipped, {key} at "
                                  f"{tile} px", tol=cs.K4_TOL_FULL)
                    held = "outputs within K4_TOL_FULL of shipped"
                elif name in RESPLIT:
                    tiles, out_p = plain[tile, kernel]
                    what = f"{name}, {tile} px, sampled tiles"
                    cs.compare_k2(out[tiles], out_p, what, kernel=kernel,
                                  tol=cs.K2_TOL if kernel == "K2"
                                  else cs.K3_TOL)
                    cs.check_chunks_uniform(out, f"{name}, {tile} px",
                                            kernel=kernel)
                    held = f"outputs within {kernel}_TOL of plain"
                elif not torch.equal(out, want[tile, key]):
                    raise AssertionError(f"{name}: {key} at {tile} px "
                                         "differs from the shipped kernel")
                ms, timed = cs.kernel_ms(fn, 10, (lib, entry))
                a = kernels.rasterizer_attributes(
                    counter, tile, packed16=kernel == "K4" and packed16)
                cs.log(f"[variant] {name}: {key} at {tile} px {ms:.4f} ms "
                       f"({timed}), {a['num_regs']} registers, "
                       f"{a['local_bytes']} B local, blocks of "
                       f"{a['max_threads']}, {a['blocks_per_sm']} blocks an "
                       f"SM, {a['clusters']} clusters at once" + (
                           "" if name == "shipped" else f", {held}"))
    if {"skip8", "all8"} & set(names):
        warp_walks(*walk8, want[8, "K2"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
