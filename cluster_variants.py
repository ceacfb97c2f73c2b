#!/usr/bin/env python3
"""Time the design choices of the thread-block cluster rasterizers (K2, K3
and K4 at 32 and 64 px tiles) and of K2 and K3 at 8 px tiles on one GPU.

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

On ``chip_smoke.py``'s 1M-splat 1920x1080 frame it times, per variant and
edge, K2 (32-byte rows, at the camera the bins were built for), K3 (at an
orbit eye) and K4 (16-byte rows, a seeded cotangent, as in training) by
CUDA events (``chip_smoke.kernel_ms``), the kernels a variant changes,
and at 8 px the device busy time of the 16-byte redraw (``render_binned``
through K3 at that eye) by torch.profiler (``chip_smoke.traced_busy``);
prints each instantiation's registers, local memory a thread and
occupancy, and checks that its outputs equal the shipped kernels' bit for
bit (every variant computes the same sums in the same order; K4 in 64x8
strips adds them in another, and is held to chip_smoke.py's K4_TOL_FULL
of the shipped rows; the 8 px variants that split a chunk otherwise are
held to K2_TOL / K3_TOL of the plain versions on chip_smoke.py's 64
sampled tiles, with chunks_done one value a tile). Ends with the card's
name and power limit.
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
    from splatjax_torch.ops.rasterize import (
        rasterize_cached_fwd, rasterize_cached_fwd_plain, rasterize_fwd,
        rasterize_fwd_plain,
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
        else:  # K4 at 8 px is not the 8 px variants'
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
            for kernel in changed:
                if kernel not in calls[tile]:
                    continue
                fn = calls[tile][kernel]
                lib, entry, counter = LIBRARY[kernel]
                out = fn()
                cs.sync()
                held = "outputs bit-equal to shipped"
                if name == "shipped":
                    want[tile, kernel] = out
                elif name in REGROUPED and tile == 64:
                    cs.compare_k4(out, want[tile, kernel], True,
                                  f"{name} against shipped, {tile} px",
                                  tol=cs.K4_TOL_FULL)
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
                elif not torch.equal(out, want[tile, kernel]):
                    raise AssertionError(f"{name}: {kernel} at {tile} px "
                                         "differs from the shipped kernel")
                ms, timed = cs.kernel_ms(fn, 10, (lib, entry))
                a = kernels.rasterizer_attributes(counter, tile,
                                                  packed16=kernel == "K4")
                cs.log(f"[variant] {name}: {kernel} at {tile} px {ms:.4f} ms "
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
