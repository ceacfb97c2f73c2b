#!/usr/bin/env python3
"""Time the design choices of the thread-block cluster rasterizers (K2 and
K3 at 32 and 64 px tiles) on one GPU.

    python3 cluster_variants.py [VARIANT ...]

Each variant is this tree's ``splatjax_torch/csrc`` with one design choice
changed (``VARIANTS``), built as ``splatjax_torch.kernels`` builds it, into
``build/cluster_variants/<variant>/``:

  shipped     the sources as they are: every block of a cluster produces
              the chunk's records itself, 64 px tiles as 16 blocks of
              16x16 pixels (a non-portable cluster), launch bounds that
              cap a cluster kernel at 64 registers (4 blocks an SM);
  split       the staging split over the cluster (``SPLIT``, patched into
              ``composite.cuh``): block r produces rows [r S, (r + 1) S) of
              each chunk, S = 128 / CLUSTER, into its own shared memory
              before the vote's cluster barrier (by chunk parity), and
              every block then copies the chunk's records from the
              cluster's slices through distributed shared memory;
  strips      64 px tiles as 8 blocks of 64x8 pixels (512 threads, the
              largest portable cluster);
  uncapped    no register cap;
  split_uncapped  the split staging with no register cap.

On ``chip_smoke.py``'s 1M-splat 1920x1080 frame it times, per variant and
edge, K2 (32-byte rows, at the camera the bins were built for) and K3 (at
an orbit eye) by CUDA events (``chip_smoke.kernel_ms``), prints each
instantiation's registers and local memory a thread, and checks that its
outputs equal the shipped kernels' bit for bit (every variant computes the
same sums in the same order). Ends with the card's name and power limit.
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


# variant -> its edits of the sources
VARIANTS = {
    "shipped": [],
    "split": SPLIT,
    "strips": STRIPS,
    "uncapped": UNCAPPED,
    "split_uncapped": SPLIT + UNCAPPED,
}


def variant_sources(name: str) -> str:
    """Write variant ``name``'s sources; returns their directory."""
    src = os.path.join(OUT, name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for fname, anchor, new in VARIANTS[name]:
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
        calls[tile] = {
            "K2": (lambda a=k2: rasterize_fwd(*a),
                   ("rasterize_fwd", "splat_rasterize_fwd"), "rasterize_fwd"),
            "K3": (lambda a=k3: rasterize_cached_fwd(*a),
                   ("rasterize_cached", "splat_rasterize_cached_fwd"),
                   "rasterize_cached")}
    want = {}
    for name in ["shipped"] + [v for v in argv or VARIANTS if v != "shipped"]:
        use_sources(variant_sources(name))
        kernels.build(["rasterize_fwd", "rasterize_cached"])
        for tile in EDGES:
            for kernel, (fn, entry, counter) in calls[tile].items():
                out = fn()
                cs.sync()
                if name == "shipped":
                    want[tile, kernel] = out
                elif not torch.equal(out, want[tile, kernel]):
                    raise AssertionError(f"{name}: {kernel} at {tile} px "
                                         "differs from the shipped kernel")
                ms, timed = cs.kernel_ms(fn, 10, entry)
                a = kernels.rasterizer_attributes(counter, tile)
                cs.log(f"[variant] {name}: {kernel} at {tile} px {ms:.4f} ms "
                       f"({timed}), {a['num_regs']} registers, "
                       f"{a['local_bytes']} B local, blocks of "
                       f"{a['max_threads']}" + (
                           "" if name == "shipped" else
                           ", outputs bit-equal to shipped"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
