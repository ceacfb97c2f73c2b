#!/usr/bin/env python3
"""Time the design choices of the thread-block cluster rasterizers (K2, K3
and K4 at 32 and 64 px tiles) on one GPU.

    python3 cluster_variants.py [VARIANT ...]

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
              barrier a chunk (not two), at 3 blocks an SM (not 4).

On ``chip_smoke.py``'s 1M-splat 1920x1080 frame it times, per variant and
edge, K2 (32-byte rows, at the camera the bins were built for), K3 (at an
orbit eye) and K4 (16-byte rows, a seeded cotangent, as in training) by
CUDA events (``chip_smoke.kernel_ms``), the kernels a variant changes;
prints each instantiation's registers, local memory a thread and
occupancy, and checks that its outputs equal the shipped kernels' bit for
bit (every variant computes the same sums in the same order; K4 in 64x8
strips adds them in another, and is held to chip_smoke.py's K4_TOL_FULL
of the shipped rows). Ends with the card's name and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "splatjax_torch", "csrc")
OUT = os.path.join(HERE, "build", "cluster_variants")
EDGES = (32, 64)
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
    "    if constexpr (GROUP < CHUNK) {  // fewer threads than rows: loop",
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
    } else if constexpr (GROUP < CHUNK) {  // fewer threads than rows""")]

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

# variant -> (the kernels it changes, its edits of the sources)
FORWARD, BACKWARD = ("K2", "K3"), ("K4",)
VARIANTS = {
    "shipped": (FORWARD + BACKWARD, []),
    "split": (FORWARD, SPLIT),
    "strips": (FORWARD, STRIPS),
    "uncapped": (FORWARD, UNCAPPED),
    "split_uncapped": (FORWARD, SPLIT + UNCAPPED),
    "k4_pull": (BACKWARD, K4_PULL),
    "k4_uncapped": (BACKWARD, K4_UNCAPPED),
    "k4_strips": (BACKWARD, K4_STRIPS),
    "k4_skip_test": (BACKWARD, K4_SKIP_TEST),
    "k4_double": (BACKWARD, K4_DOUBLE),
}
# K4 variants that group a 64 px tile's pixels otherwise, so add each
# instance's sums in another order: held to K4_TOL_FULL of the shipped rows
REGROUPED = ("k4_strips",)
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
        rasterize_cached_fwd, rasterize_fwd,
    )
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd

    scene = tile_scene(load_splat(cs.FIXTURE), cs.N_SPLATS)
    cam = make_camera(cs.EYE, (0, 0, 0), width=cs.WIDTH, height=cs.HEIGHT)
    eye = make_camera(cs.ORBIT[1], (0, 0, 0), width=cs.WIDTH,
                      height=cs.HEIGHT)
    start = cs.noisy_start(scene)
    calls = {}
    for tile in EDGES:
        _, capacity = cs.edge_capacity(scene, start, cam, tile)
        cfg, b, rows = cs.binned_rows(scene, cam, capacity, 1e-4, tile=tile)
        k2 = (rows, b.starts, b.ends, cfg, 0.999, 1e-4)
        _, capacity_e = cs.redraw_capacity(scene, tile)
        k3 = cs.k3_args(cs.cached_bins(scene, cam, capacity_e, tile), eye,
                        0.999, 1e-4, tile)
        k4 = cs.k4_case(scene, cam, capacity, True, 0.999, False, 4,
                        tile=tile)[2]
        calls[tile] = {
            "K2": lambda a=k2: rasterize_fwd(*a),
            "K3": lambda a=k3: rasterize_cached_fwd(*a),
            "K4": lambda a=k4: rasterize_bwd(*a, packed16=True)}
    want = {}
    for name in ["shipped"] + [v for v in argv or VARIANTS if v != "shipped"]:
        changed = VARIANTS[name][0]
        use_sources(variant_sources(name))
        kernels.build(sorted({LIBRARY[k][0] for k in changed}))
        for tile in EDGES:
            for kernel in changed:
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
