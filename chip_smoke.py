#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``splatjax_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build the CUDA kernels from ``splatjax_torch/csrc`` (one nvcc each,
     started together); the projection pair (``project_params``) against
     its plain version at 1M splats without SH at 1920x1080 and 3M with
     SH 3 at 1237x822: the mask equal, the other fields within 1e-6 of
     each gaussian's largest |value| (bit-equal as measured), the tile
     lists binning builds on both (differing instances listed), every
     gradient's worst leaf against the hand-written plain backward within
     3x the plain backward's own distance from autograd through the plain
     composition plus 1e-5 of that leaf's largest |gradient|; each
     kernel's time by CUDA events beside its byte bound and the plain
     versions'; then the row pack and gather (``pack_gather_rows``)
     against its plain version (the table pack and torch's gather) bit
     for bit, both layouts, at those two shapes over their tile lists and
     on non-finite features; its time in each cell's layout beside its
     byte bound, the plain version's and torch's gather alone;
  2. K1 (expansion) against its plain version on the full-width frame and
     on edge cases (a long row of empty gaussians, screen-filling ones,
     capacity above and below the total, a long tail of gaussians at
     cum_d == capacity, and cumsums past 2^31 saturated at 2^31 - 1):
     integer-equal; its time by CUDA events, and ``repeat_interleave``'s
     beside it;
  3. K2 (forward rasterize), 32-byte and 16-byte rows, against its plain
     version: <= 1e-4 on r, g, b, T and depth, chunks_done equal, on 64
     sampled tiles of the full-width frame and on every tile of 192x128
     frames; chunks_done one value over every pixel of every tile of the
     full-width frame;
  4. K4 (backward rasterize) against its plain version: every tile of the
     192x128 gate scene for both row widths, clip 0.999 and none, with and
     without a z-buffer, with 4- and 8-channel cotangents; then the
     instances of 64 sampled tiles of the full-width frame; <= 1e-4 of each
     gradient channel's largest |value| on the gate scene and 1e-3 on the
     full-width frame, whose deepest tiles carry log T through thousands of
     instances, summed in another order (16-byte rows: plus one bf16 ulp,
     2^-7 of the value, where the two round f32 sums to bf16 apart); two
     runs on the full-width frame give bit-identical rows;
  5. K5, K6, K7 (segment sums) on the full-width backward's rows (2.8M
     instances onto 1M gaussians): the direct entries on gid-sorted rows
     against their plain versions, and the slot entries the training path
     takes (rows in tile order, read through the tile sort's inverse)
     against the gid-sort plain path, run twice (bit-identical); K6
     bit-equal, K5/K7 within (run length) x 2^-23 x (sum of |rows|) per run;
     the same on long runs (33 to 70,000 rows: the whole-block sums and
     K6's int64 chunk sums), both entries bit-equal to each other;
     then the tail diagnostics (``[tail]``): walked instances per tile
     (mean, p99, max); K2, K3 and K4 on the deepest tile alone beside the
     whole frame; K4 with its tiles ordered by walked instances against
     the bins' order by list length (the rows must be bit-identical);
  6. parity gate: the tiled renderer against the O(N x P) reference, 2000
     splats at 192x128, early_stop=0, alpha_clip=None, < 1e-3;
  7. gradient gate: the same scene with 32-byte rows, early_stop=0 and
     SPLATJAX_GRAD_GATHER=f32 (K5): gradients w.r.t. every
     TrainableGaussians leaf against torch.autograd through
     render_reference, atol 2e-3 x max, rtol 2e-3;
  8. K3 (fused cached-viewer forward) against its plain version: <= 1e-4
     on r, g, b, T and depth, chunks_done equal, on every tile of the
     192x128 gate scene with bins built at its camera and drawn there and
     at a moved eye (clip 0.999 and none, early stop 1e-4 and 0), then on
     64 sampled tiles of the full-width frame at an orbit eye;
  9. fused quality gate: the full-width 16-byte fused redraw at the bins'
     camera within 1e-3 of the 32-byte render, and no further from it than
     the packed 16-byte cached redraw (K2-16);
 10. the main paths, each with the launch counts reset just before and read
     just after:
     a. serving: the trained fixture tiled to 1M splats, 1920x1080 from eye
        (0, 0, 2.8), 10 frames through ``SplatRenderer`` (K1, K2, one row
        pack a K2);
     b. training: ``fit()`` 6 Adam steps from that scene with seeded noise
        on colors and opacities towards its 32-byte render, FitConfig
        defaults (16-byte rows; K1, K2, K4, K7, one 16-byte row pack a
        K2); the loss must fall;
     c. one 32-byte gradient step (K6), and one under
        SPLATJAX_GRAD_GATHER=f32 (K5), one row pack each;
     d. the stale-order redraw: ``SplatRenderer(feature_bytes=16,
        resort_interval=8)`` over splatjax bench.py's orbit (eyes
        (0.02 sin t, 0.02 cos t, 2.8), 8 t over [0, 2 pi)), two laps = 16
        frames: 16 K3 launches, 2 K1 (one per rebuilt index), no K2, no
        row pack;
     e. the same renderer with 32-byte rows, 8 frames at the unchanged
        camera: K2 and no K3, within 1e-4 of ``render()``;
     f. assets: the 1M-splat scene written by ``save_ply`` and as .splat
        under ``build/``; the .ply loaded by the native converter and by
        NumPy (means, quaternions, colors bit-equal, scales and opacities
        within 4 ulps, rows ordered apart only at importance near-ties);
        3 frames of ``SplatRenderer(src="file://.../scene.ply",
        progress=cb)`` bit-equal to ``render()`` of the NumPy-loaded scene,
        ``cb`` seeing one done event at the file's size; the .splat through
        ``SplatRenderer.from_stream(stream_chunks(...))`` equal to
        ``load_splat``'s scene; host load times (K1, K2);
     g. densify + checkpoint: ``fit()`` 8 steps from a fresh noisy start
        with ``DensifyConfig(every=3)`` (passes after steps 2 and 5; the
        gradient threshold the 90th percentile of a probe step's mean
        gradients), ``checkpoint_every=3``: twice uninterrupted (A, B),
        once resumed from A's step-3 checkpoint; the first pass must clone
        or split and grow the rows; the resumed run bit-identical to A if
        A and B are, else no further from A than B; ``export_ply`` bytes
        equal to ``save_ply`` of A's scene (K1, K2 16-byte, K4, K7);
     h. multi-card, on a one-rank NCCL group that ``init_distributed``
        starts (a FileStore under ``build/``): ``render_sharded`` of the
        serving scene under ``make_mesh(1)`` and ``make_mesh_2d((1, 1))``,
        all_to_all and all_gather, load-balanced and equal bands, at
        pair_capacity = N, each within 1e-4 of ``render()`` with overflow
        0 (8 frames: exactly 8 K1, 8 row pack and 8 K2 launches), and the
        defaults' frame once (pair_capacity 6N); ``fit(mesh=make_mesh(1))``
        one step within the gradient gate of ``make_train_step``'s; the
        (view, band) step twice from one start, within the gate and
        compared bit for bit; ``fit`` on ``make_mesh_2d((1, 1), ("view",
        "band"))`` 6 steps: the loss falls, drops 0 (K1, K2 16-byte, K4,
        K7); the collectives alone by CUDA events;
     i. tooling and examples, in the same ``build/`` directory after path
        f: the viewer-oracle gate (K1, K2: ``render(viewer_exact=True,
        early_stop=0)`` of test_reference_rasterizer.py's 40-splat scene
        and its 60-splat cutout scene, parsed from .splat bytes, 48x32,
        within PARITY_TOL of ``reference.viewer_math.viewer_render``, the
        scalar WebGL-viewer pipeline); ``tools.make_fixture`` at its
        defaults with tests/test_fixture.py's checks on the files it
        writes; ``examples.fit_trained_fixture`` at its defaults, held-out
        PSNR (min of 2 views) >= 25 dB, loss falling; the demos at their
        defaults, demo_render / demo_orbit / demo_stereo / demo_cutout on
        path f's .splat
        (demo_render bit-equal to ``render()``, demo_orbit exactly 24 K3,
        3 K1 and no K2, the clipped frame unlike the full one,
        demo_train's held-out PSNR above its start), every PNG decoded
        back to its frame (K1, K2, K2 16-byte, K3, K4, K7);
     j. tile edges: the registers, local (spill) bytes and largest block of
        K2 (both widths), K3 and K4 (both widths) at every edge by
        cudaFuncGetAttributes (the 8 px kernels and the 32 and 64 px
        thread-block cluster kernels must not spill); K2 (32- and 16-byte
        rows), K3 and K4 at 8, 32 and 64 px
        tiles against their plain versions on every tile of the 192x128 gate
        scene and on the full-width frame (as phases 3, 4 and 8; chunks_done
        one value over every pixel of every tile of the full frame, for K2
        and K3 at every edge); at 8 px K2 (both widths), K3 and K4 (both
        widths) again on the
        gate scene with the instance rows moved 0, 1, 63, 64, 65 and 127
        rows on in their buffer, which moves the global chunk grid under
        the tiles (``check_shifted_chunks``); the parity and gradient gates
        at each edge, the tail diagnostics at 8, 32 and 64 px (at 8 px K4
        also on the frame without its deepest 1% of tiles); then,
        counted: a one-rank
        ``render_sharded(tile_size=32)`` within 1e-4 of ``render()``, and
        at 8, 16, 32 and 64 px a serving frame through
        ``SplatRenderer(tile_size=t)``, 3 L1 + Adam steps of
        ``render(feature_bytes=16, tile_size=t)`` (the loss must fall) and
        the 16-byte stale-order redraw over the orbit; ``[tiles]`` and
        ``[tile-table]`` lines (instances, fragments, K2/K3/K4 times and
        bounds at each edge);
     capacity = the measured demand of both scenes + 3% (paths a-c, h, and
     at each edge j), of
     the base eye and the orbit + 3% (d, e), of the loaded scene + 3% (f),
     ``default_capacity`` of the row count (g); overflow == 0 (path i
     runs the entry points at their own default capacity and reads no
     overflow).
Then one line with the card's name and power limit, one JSON line with the
kernel table, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints no result and exits with 1.

Kernel times come from CUDA events around each launch, queued behind a
device wait (``kernel_ms``); each ``[k*]`` line says how many launches
were timed. Bounds take their peaks and work counts from
``h100_bench/roofline.py``. This script times no path: frame and step
times, device busy and the per-layer times come from the benchmark
(``h100_bench/run.py``, ``BENCHMARK.json``) only.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "trained_scene.splat")
N_SPLATS = 1_000_000
WIDTH, HEIGHT = 1920, 1080
EYE = (0.0, 0.0, 2.8)
FRAMES = 10
TRAIN_STEPS = 6
NOISE = 0.5            # std of the seeded noise on colors / logit opacities
K2_TOL = 1e-4          # r, g, b, T, depth: kernel vs plain (f32 order)
K4_TOL = 1e-4          # x each gradient channel's max |value| (f32 order)
K4_TOL_FULL = 1e-3     # the same on the full-width frame (deep stacks)
SEG_ULP = 2.0 ** -23   # K5/K7: run length x SEG_ULP x sum |rows| per run
PARITY_TOL = 1e-3      # tiled renderer vs reference (viewer-parity budget)
GRAD_TOL = 2e-3        # gradient gate: atol GRAD_TOL x max, rtol GRAD_TOL
SAMPLE_TILES = 64
K3_TOL = 1e-4          # r, g, b, T, depth: K3 vs plain (f32 order)
FUSED_TOL = 1e-3       # fused 16-byte redraw vs the 32-byte render
ORBIT = [(0.02 * math.sin(t), 0.02 * math.cos(t), 2.8)
         for t in (2.0 * math.pi * i / 8 for i in range(8))]
REDRAW_LAPS = 2
QUEUE_CYCLES = 20_000_000  # device wait (~10 ms) that kernel_ms queues behind
# the projection pair against its plain version: (splats, SH bands, width,
# height), the jump frame's and the fit step's shapes
PROJ_SHAPES = ((1_000_000, 0, 1920, 1080), (3_000_000, 15, 1237, 822))
PROJ_TOL = 1e-6        # projection kernel vs plain: float fields, relative
# gradients: the kernel within 3x what the plain backward differs from
# autograd through the plain composition (f32 rounding, amplified where a
# gaussian's 2D eigenvalues nearly meet), plus PROJ_GRAD_TOL, each as a
# share of the leaf's largest |gradient|
PROJ_GRAD_TOL = 1e-5
RESORT_INTERVAL = 8
ASSET_FRAMES = 3       # frames of SplatRenderer(src=.ply) in the asset path
DENSE_STEPS = 8        # fit() steps of the densify + checkpoint path
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls on the device's stream, by
    CUDA events, after one warm-up call (the plain versions: their own
    launch gaps count)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps: int, entry: tuple[str, str], tries: int = 3
              ) -> tuple[float, str]:
    """Device time of one launch of the kernel behind C entry ``entry``
    (library, name), over ``reps`` calls of ``fn``: CUDA events around each
    launch (``kernels.timed_launches``), so the wrapper's host time and
    other device work (tens of microseconds, more than K1 itself) do not
    count. The launches queue behind a device wait of QUEUE_CYCLES, so no
    event waits on the host; if the wait ended before the host had queued
    every launch, the measurement is taken again with twice the wait, at
    most ``tries`` times. Returns the mean and "n/reps launches timed" for
    the caller's line."""
    import torch
    from splatjax_torch import kernels

    fn()
    sync()
    cycles = QUEUE_CYCLES
    for attempt in range(1, tries + 1):
        with kernels.timed_launches(*entry) as pairs:
            torch.cuda._sleep(cycles)
            waited = torch.cuda.Event()
            waited.record()
            for _ in range(reps):
                fn()
            drained = waited.query()
            sync()
        if len(pairs) != reps:
            raise AssertionError(f"{len(pairs)} launches of {entry[1]} timed "
                                 f"for {reps} calls")
        if not drained:
            ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
            return ms, f"{len(pairs)}/{reps} launches timed" + (
                f", wait {cycles} cycles" if attempt > 1 else "")
        log(f"[timing] {entry[1]}: the device wait of {cycles} cycles ended "
            f"before {reps} launches were queued; again with twice the wait")
        cycles *= 2
    raise AssertionError(f"{tries} timings of {entry[1]} outran their wait")


def traced_kernels(fn, calls: int, *, want: str = "", count: int = 0,
                   tries: int = 3) -> list:
    """The device-side kernel records (torch.profiler ``key_averages``) of
    a trace of the host and the device over ``calls`` calls of ``fn``,
    after one warm-up call. torch.profiler can return
    a trace that lacks kernels the calls ran (dropped CUPTI records), so
    a trace with no kernel record whose name holds ``want`` (or, with
    ``count``, with another number of them) is taken again, at most
    ``tries`` times, and then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA, ProfilerActivity.CPU]
    fn()
    sync()
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            sync()
        # device-side kernels only: a user annotation
        # (Optimizer.step#Adam.step) spans kernels counted on their own
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        n = sum(e.count for e in kern if want in e.key)
        if n > 0 and (count == 0 or n == count):
            return kern
        log(f"[timing] a profiler trace held {len(kern)} kernel records, "
            f"{n} named {want!r} (want {count or 'some'}); tracing again")
    raise AssertionError(f"no {want!r} kernel records in {tries} profiler "
                         "traces")


def roofline():
    """``h100_bench/roofline.py``: the H100's peaks and the rasterizers'
    operations per fragment and per instance, shared with the benchmark."""
    bench = os.path.join(HERE, "h100_bench")
    if bench not in sys.path:
        sys.path.append(bench)
    import roofline

    return roofline


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    r = roofline()
    t_bytes = bytes_moved / r.PEAK_BYTES_PER_S * 1e3
    t_ops = ops / r.PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def projected(scene, cam, early_stop):
    from splatjax_torch.ops.projection import project_gaussians
    from splatjax_torch.scene import build_covariances

    return project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection,
        cam.width, cam.height, max_scales=scene.scales.amax(dim=-1),
        support_eps=early_stop,
    )


def binned_rows(scene, cam, capacity, early_stop, packed16=False, tile=16):
    """The K2 inputs of the main path: tile-sorted packed rows + bounds,
    at tile edge ``tile``."""
    from splatjax_torch.ops.binning import (
        TileConfig, bin_gaussians, features_from_projection,
    )
    from splatjax_torch.ops.rasterize import pack_gather_rows

    import torch

    with torch.no_grad():
        proj = projected(scene, cam, early_stop)
        cfg = TileConfig(cam.width, cam.height, tile, tile)
        b = bin_gaussians(proj, cfg, capacity)
        if int(b.overflow) != 0:
            raise AssertionError(f"overflow {int(b.overflow)} at {capacity}")
        rows = pack_gather_rows(features_from_projection(proj), b.gauss_id,
                                packed16)
    return cfg, b, rows


def projection_inputs(n, bands, seed=21):
    """A ``tile_scene`` of the fixture at ``n`` splats with unit
    quaternions and, with ``bands``, SH drawn N(0, 0.1) (the fit cell's)."""
    import dataclasses

    import torch
    from splatjax_torch.io import load_splat, tile_scene

    scene = tile_scene(load_splat(FIXTURE), n).normalized()
    if bands:
        g = torch.Generator(device=scene.device).manual_seed(seed)
        scene = dataclasses.replace(scene, sh=0.1 * torch.randn(
            (n, bands, 3), generator=g, device=scene.device))
    return scene


def projection_bytes(n, bands):
    """(forward, backward) bytes the pair must move: each parameter,
    cotangent and output row once."""
    sh = 12 * bands
    color = 12 if bands else 0
    fwd = n * (12 + 16 + 12 + 4 + color + sh + 8 + 12 + 4 + 1 + 8 + color)
    bwd = n * 2 * (12 + 16 + 12 + color + sh) + n * (8 + 12 + 4 + color)
    return fwd, bwd


def bins_of(proj, cfg):
    """Tile lists of a projection: bin_gaussians at its own demand."""
    import torch
    from splatjax_torch.ops.binning import bin_gaussians

    with torch.no_grad():
        need = int(bin_gaussians(proj, cfg, 1024).num_instances)
        return bin_gaussians(proj, cfg, -(-need // 1024) * 1024)


def check_projection():
    """project_params' kernel pair against its plain version at the jump
    frame's and the fit step's shapes: every forward field (the mask
    equal, the rest within PROJ_TOL relative), every gradient of seeded
    cotangents (worst leaf against that leaf's largest gradient, against
    the hand-written plain backward and against autograd through the
    plain composition), and the tile lists that binning builds on both.
    Times each kernel by CUDA events beside its byte bound, the plain
    forward and backward, and autograd's backward of the composition."""
    import torch
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.ops import projection as P
    from splatjax_torch.ops.binning import TileConfig
    from splatjax_torch.scene import build_covariances

    fields = ("mean2d", "conic", "depth", "bbox_half", "color")
    leaves = ("means", "quats", "scales", "colors", "sh")
    rows = {}
    for n, bands, w, h in PROJ_SHAPES:
        what = f"{n} splats, SH bands {bands}, {w}x{h}"
        scene = projection_inputs(n, bands)
        cam = make_camera(EYE, (0, 0, 0), width=w, height=h)
        mv, pr = cam.modelview, cam.projection
        args = (scene.means, scene.colors, scene.opacities, mv, pr, w, h)
        kw = dict(quats=scene.quats, scales=scene.scales, sh=scene.sh,
                  support_eps=1e-4)

        def plain_fwd(lv=None):
            lv = lv or dict(means=scene.means, quats=scene.quats,
                            scales=scene.scales, colors=scene.colors,
                            sh=scene.sh)
            return P.project_gaussians(
                lv["means"], build_covariances(lv["quats"], lv["scales"]),
                lv["colors"], scene.opacities, mv, pr, w, h,
                max_scales=lv["scales"].amax(dim=-1), sh=lv["sh"],
                support_eps=1e-4)

        with torch.no_grad():
            kernels.reset_launches()
            pk = P.project_params(*args, **kw)
            sync()
            if kernels.LAUNCHES["project_fwd"] != 1:
                raise AssertionError(f"project_fwd launches "
                                     f"{kernels.LAUNCHES['project_fwd']}")
            pp = plain_fwd()
        flipped = int((pk.mask != pp.mask).sum())
        if flipped:
            raise AssertionError(f"[project] {what}: mask differs at "
                                 f"{flipped} gaussians")
        errs, differ = {}, {}
        for f in fields:
            a, b = getattr(pk, f), getattr(pp, f)
            a, b = a.reshape(n, -1), b.reshape(n, -1)
            scale = b.abs().amax(-1, keepdim=True).clamp_min(1e-30)
            errs[f] = float(((a - b).abs() / scale).nan_to_num(0.0).max())
            differ[f] = float((a != b).any(-1).float().mean())
        log(f"[project] {what}: mask equal ({int(pk.mask.sum())} kept); "
            "max error against the gaussian's largest |value| (share of "
            "gaussians not bit-equal) " + ", ".join(
                f"{f} {e:.3g} ({differ[f]:.3g})" for f, e in errs.items()))
        if max(errs.values()) > PROJ_TOL:
            raise AssertionError(f"[project] {what}: {errs} over {PROJ_TOL}")

        cfg = TileConfig(w, h, 16, 16)
        bk, bp = bins_of(pk, cfg), bins_of(pp, cfg)
        nk, npl = int(bk.num_instances), int(bp.num_instances)
        key_k = bk.tile_id[:nk].long() * n + bk.gauss_id[:nk].long()
        key_p = bp.tile_id[:npl].long() * n + bp.gauss_id[:npl].long()
        same = nk == npl and bool(torch.equal(key_k, key_p))
        only_k = key_k[~torch.isin(key_k, key_p)]
        only_p = key_p[~torch.isin(key_p, key_k)]

        def pairs(keys):
            return [(int(t), int(i)) for t, i in zip(
                (keys[:8] // n).tolist(), (keys[:8] % n).tolist())]

        log(f"[project] {what}: binning {nk} / {npl} instances (kernel / "
            f"plain), tile lists {'equal' if same else 'differ'}; "
            f"{only_k.numel()} (tile, gaussian) instances only in the "
            f"kernel's {pairs(only_k)}, {only_p.numel()} only in the "
            f"plain's {pairs(only_p)}")
        del bk, bp, key_k, key_p

        g = torch.Generator(device=scene.device).manual_seed(3)
        cot = {f: torch.randn(getattr(pp, f).shape, generator=g,
                              device=scene.device)
               for f in ("mean2d", "conic", "depth", "color")}
        setup = P._Setup(w, h, False, 1e-4, bands, bands > 0)
        bwd_in = (scene.means, scene.quats, scene.scales, scene.colors,
                  scene.sh, mv, pr, setup, cot["mean2d"], cot["conic"],
                  cot["depth"], cot["color"] if bands else None)
        kernels.reset_launches()
        got = P._backward_kernel(*bwd_in)
        sync()
        if kernels.LAUNCHES["project_bwd"] != 1:
            raise AssertionError(f"project_bwd launches "
                                 f"{kernels.LAUNCHES['project_bwd']}")
        hand = P.project_backward_plain(*bwd_in)
        lv = {k: getattr(scene, k).clone().requires_grad_()
              for k in leaves if getattr(scene, k) is not None}
        comp = plain_fwd(dict(dict(sh=None), **lv))
        names = [k for k in leaves if k in lv and (bands or k != "colors")]
        auto = torch.autograd.grad(
            sum((getattr(comp, f) * c).sum() for f, c in cot.items()
                if bands or f != "color"), [lv[k] for k in names])
        worst = {}
        for k, a in zip(names, auto):
            i = leaves.index(k)
            scale = float(a.abs().max())
            worst[k] = (float((got[i] - hand[i]).abs().max()) / scale,
                        float((got[i] - a).abs().max()) / scale,
                        float((hand[i] - a).abs().max()) / scale)
            if not torch.isfinite(got[i]).all():
                raise AssertionError(f"[project] {what}: d{k} not finite")
        log(f"[project] {what}: gradients, max |diff| / leaf max (kernel vs "
            "plain, kernel vs autograd, plain vs autograd): " + "; ".join(
                f"{k} {a:.3g} {b:.3g} {c:.3g}"
                for k, (a, b, c) in worst.items()))
        if any(a > 3.0 * c + PROJ_GRAD_TOL for a, _, c in worst.values()):
            raise AssertionError(f"[project] {what}: {worst}")
        del comp, auto, hand, got, lv

        fwd_bytes, bwd_bytes = projection_bytes(n, bands)
        with torch.no_grad():
            fwd_ms, fwd_note = kernel_ms(
                lambda: P.project_params(*args, **kw), 20,
                ("project", "splat_project_fwd"))
            plain_fwd_ms = cuda_ms(plain_fwd, 5)
        bwd_ms, bwd_note = kernel_ms(lambda: P._backward_kernel(*bwd_in), 20,
                                     ("project", "splat_project_bwd"))
        plain_bwd_ms = cuda_ms(lambda: P.project_backward_plain(*bwd_in), 5)
        lv = {k: getattr(scene, k).clone().requires_grad_()
              for k in leaves if getattr(scene, k) is not None}

        def autograd_step():
            comp = plain_fwd(dict(dict(sh=None), **lv))
            torch.autograd.grad(
                sum((getattr(comp, f) * c).sum() for f, c in cot.items()
                    if bands or f != "color"), [lv[k] for k in names])

        autograd_ms = cuda_ms(autograd_step, 5)
        for name, ms, note, nbytes, plain_ms in (
                ("project_fwd", fwd_ms, fwd_note, fwd_bytes, plain_fwd_ms),
                ("project_bwd", bwd_ms, bwd_note, bwd_bytes, plain_bwd_ms)):
            bound_ms = nbytes / roofline().PEAK_BYTES_PER_S * 1e3
            log(f"[project] {what}: {name} {ms:.4f} ms ({note}), bound "
                f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), "
                f"{100 * bound_ms / ms:.1f}% of it; plain {plain_ms:.3f} ms")
            rows.setdefault(name, dict(ms=ms, bound_ms=bound_ms,
                                       bound_by="bytes", plain_ms=plain_ms,
                                       max_abs_err=0.0))
            rows[name][f"ms@{n}x{bands}"] = ms
        log(f"[project] {what}: autograd forward + backward of the plain "
            f"composition {autograd_ms:.3f} ms")
        rows["project_fwd"]["max_abs_err"] = max(
            rows["project_fwd"]["max_abs_err"], max(errs.values()))
        rows["project_bwd"]["max_abs_err"] = max(
            rows["project_bwd"]["max_abs_err"],
            max(v[0] for v in worst.values()))
        del scene, pk, pp, lv
        torch.cuda.empty_cache()
    return rows


PACK_CASES = ((1_000_000, 0, 1920, 1080, False), (3_000_000, 15, 1237, 822,
                                                  True))


def pack_nonfinite(device, n=4096, k=12_000, seed=7):
    """Features holding NaN (both signs), +-inf, values below 0 and above
    1, means off the 16-bit range and on its quantization half-steps, and
    ids with a zero-filled tail, as the binning's unused slots hold."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    feat = torch.rand((n, 16), generator=g)
    feat[:, :2] = feat[:, :2] * 3000.0 - 500.0
    specials = torch.tensor([float("nan"), -float("nan"), float("inf"),
                             -float("inf"), -0.3, 1.7, 1e9, -1e9, -0.0,
                             0.5 / 65535.0, 1.5 / 255.0, -2048.0 + 0.0625,
                             6143.9375, 1e-40])
    pick = torch.randint(0, specials.numel(), (n // 2, 10), generator=g)
    feat[: n // 2, :10] = specials[pick]
    gid = torch.randint(0, n, (k,), generator=g, dtype=torch.int32)
    gid[k - 1000:] = 0
    return feat.to(device), gid.to(device)


def check_pack_rows():
    """pack_gather_rows' kernel against its plain version (the table pack
    and torch's gather, on the card) bit for bit, in both layouts: at the
    jump frame's shape (1M splats, SH 0, 1920x1080) and the fit step's (3M,
    SH 3, 1237x822), over the tile lists binning builds there, and on
    non-finite features (:func:`pack_nonfinite`). Times the kernel in the
    cell's layout by CUDA events beside its byte bound (each instance's id,
    the two 32-byte sectors of its feature row and its 32-byte row once),
    the plain version and torch's gather alone on the packed table."""
    import torch
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.ops import projection as P
    from splatjax_torch.ops.binning import TileConfig, features_from_projection
    from splatjax_torch.ops.rasterize import (
        gather_rows, pack_gather_rows, pack_gather_rows_plain, pack_table,
    )

    def compare(feat, gid, packed16, what):
        kernels.reset_launches()
        got = pack_gather_rows(feat, gid, packed16)
        sync()
        counter = "pack_rows16" if packed16 else "pack_rows"
        if kernels.LAUNCHES[counter] != 1:
            raise AssertionError(f"[pack] {what}: {counter} launches "
                                 f"{kernels.LAUNCHES[counter]}")
        want = pack_gather_rows_plain(feat, gid, packed16)
        bad = (got != want).any(-1)
        if bool(bad.any()):
            i = int(bad.nonzero()[0])
            raise AssertionError(
                f"[pack] {what}: {int(bad.sum())} of {gid.numel()} rows "
                f"differ; row {i} (gaussian {int(gid[i])}, features "
                f"{feat[int(gid[i]), :10].tolist()}): kernel "
                f"{[hex(v & 0xFFFFFFFF) for v in got[i].tolist()]}, plain "
                f"{[hex(v & 0xFFFFFFFF) for v in want[i].tolist()]}")
        return got

    rows = {}
    with torch.no_grad():
        feat, gid = pack_nonfinite(torch.device("cuda"))
        for packed16 in (False, True):
            got = compare(feat, gid, packed16, f"non-finite features, "
                          f"{16 if packed16 else 32}-byte rows")
            nan_row = int(feat[gid.long(), 5].isnan().nonzero()[0])
            log(f"[pack] non-finite features, {16 if packed16 else 32}-byte"
                f" rows: {gid.numel()} rows bit-equal; a row whose red is "
                f"NaN: {[hex(v & 0xFFFFFFFF) for v in got[nan_row].tolist()]}")
        for n, bands, w, h, cell16 in PACK_CASES:
            what = f"{n} splats, SH bands {bands}, {w}x{h}"
            scene = projection_inputs(n, bands)
            cam = make_camera(EYE, (0, 0, 0), width=w, height=h)
            proj = P.project_params(
                scene.means, scene.colors, scene.opacities, cam.modelview,
                cam.projection, w, h, quats=scene.quats, scales=scene.scales,
                sh=scene.sh, support_eps=1e-4)
            b = bins_of(proj, TileConfig(w, h, 16, 16))
            feat = features_from_projection(proj)
            gid = b.gauss_id
            k = gid.numel()
            for packed16 in (False, True):
                compare(feat, gid, packed16,
                        f"{what}, {16 if packed16 else 32}-byte rows")
            counter = "pack_rows16" if cell16 else "pack_rows"
            ms, note = kernel_ms(lambda: pack_gather_rows(feat, gid, cell16),
                                 20, ("pack_rows", "splat_pack_rows"))
            plain_ms = cuda_ms(
                lambda: pack_gather_rows_plain(feat, gid, cell16), 5)
            table = pack_table(feat, cell16)
            library_ms = cuda_ms(lambda: gather_rows(table, gid), 5)
            nbytes = k * (4 + 64 + 32)
            bound_ms, by = bound(nbytes, 0)
            log(f"[pack] {what}: {k} rows ({int(b.num_instances)} "
                f"instances) bit-equal in both layouts; {counter} "
                f"{ms:.4f} ms ({note}), bound {bound_ms:.4f} ms ({by}, "
                f"{nbytes / 1e6:.1f} MB), {100 * bound_ms / ms:.1f}% of it;"
                f" plain (table pack + gather) {plain_ms:.4f} ms; torch's "
                f"gather of the packed table alone {library_ms:.4f} ms")
            rows[counter] = dict(ms=ms, bound_ms=bound_ms, bound_by=by,
                                 plain_ms=plain_ms, library_ms=library_ms,
                                 max_abs_err=0.0)
            del scene, proj, b, feat, gid, table
            torch.cuda.empty_cache()
    return rows


def sample_tiles(b, cfg, device):
    """The 32 busiest tiles and 32 others drawn with a fixed seed."""
    import torch

    per_tile = (b.ends - b.starts).long()
    g = torch.Generator(device="cpu").manual_seed(0)
    busiest = torch.argsort(per_tile.cpu(), descending=True)
    busiest = busiest[: SAMPLE_TILES // 2]
    rest = torch.ones(cfg.num_tiles, dtype=torch.bool)
    rest[busiest] = False
    rest = rest.nonzero()[:, 0]
    rand = rest[torch.randperm(rest.numel(), generator=g)]
    tiles = torch.cat([busiest, rand[: SAMPLE_TILES - busiest.numel()]])
    return tiles.sort().values.to(device)


def check_k1(scene, cam, capacity):
    import torch
    from splatjax_torch.ops.binning import TileConfig, depth_order
    from splatjax_torch.ops.expand import (
        expand_instances, expand_instances_plain,
    )

    cfg = TileConfig(cam.width, cam.height)
    d = depth_order(projected(scene, cam, 1e-4), cfg)
    args = (d.x0_d, d.y0_d, d.spanw_d, d.cum_d, d.perm, capacity,
            cfg.tiles_x, cfg.num_tiles)
    tile_k, gid_k = expand_instances(*args)
    tile_p, gid_p = expand_instances_plain(*args)
    sync()
    if not (torch.equal(tile_k, tile_p) and torch.equal(gid_k, gid_p)):
        bad = int(((tile_k != tile_p) | (gid_k != gid_p)).sum())
        raise AssertionError(f"K1 differs from its plain version at {bad} "
                             "slots")
    n = d.cum_d.shape[0]
    ms, timed = kernel_ms(lambda: expand_instances(*args), 20,
                           ("expand", "splat_expand_instances"))
    plain_ms = cuda_ms(lambda: expand_instances_plain(*args), 3)
    total = int(d.cum_d[-1])
    lib_ms = cuda_ms(lambda: torch.repeat_interleave(
        d.perm, d.count_d, output_size=total), 10)
    slots = capacity
    b_ms, b_by = bound(
        5 * 4 * n + 2 * 4 * slots,
        slots * (math.ceil(math.log2(max(n, 2))) + 8),
    )
    log(f"[k1] N={n} capacity={capacity} integer-equal; kernel {ms:.4f} ms "
        f"by events ({timed}), plain {plain_ms:.4f} ms, "
        f"repeat_interleave(perm, count_d) {lib_ms:.4f} ms (the gid half "
        f"only), bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_k1_edges(device):
    """K1 against its plain version where the full-width frame does not
    go: empty gaussians between full ones (a run of 3,000 wider than a
    block's window of staged gaussians), gaussians of 8,160 slots (a
    screen-filling splat at 1080p), capacity above and below the total,
    and saturated cumsums: a long tail of gaussians at cum_d == capacity,
    and a count sum past 2^31 saturated at 2^31 - 1 as ``bin_gaussians``
    leaves it (a gaussian of 2^31 instances)."""
    import torch
    from splatjax_torch.ops.binning import CUM_MAX
    from splatjax_torch.ops.expand import (
        expand_instances, expand_instances_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(4)
    n, tiles_x, num_tiles = 20_000, 120, 8160
    counts = torch.randint(0, 4, (n,), generator=gen)
    counts[5000:8000] = 0
    counts[torch.randperm(n, generator=gen)[:6]] = 8160
    spanw = torch.randint(1, 121, (n,), generator=gen).minimum(
        counts.clamp_min(1))
    x0 = torch.randint(0, 40, (n,), generator=gen)
    y0 = torch.randint(0, 40, (n,), generator=gen)
    cum = counts.cumsum(0)
    perm = torch.randperm(n, generator=gen)
    total = int(cum[-1])
    cut = total * 2 // 3
    huge = counts.clone()
    huge[n // 2] = 2 ** 31
    cases = (
        ("capacity above the total", cum, total + 1000),
        ("capacity below the total", cum, cut),
        ("cum_d saturated at the capacity", cum.clamp(max=cut), cut),
        ("cum_d saturated at 2^31 - 1", huge.cumsum(0).clamp(max=CUM_MAX),
         int(huge[: n // 2].sum()) + 5000),
    )
    for what, c, capacity in cases:
        ins = [t.int().to(device) for t in (x0, y0, spanw, c, perm)]
        args = (*ins, capacity, tiles_x, num_tiles)
        got = expand_instances(*args)
        want = expand_instances_plain(*args)
        sync()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K1 differs from its plain version on the "
                                 f"edge case: {what} ({capacity})")
        tail = int((c >= capacity).sum())
        log(f"[k1] edge case {what}: capacity {capacity}, {tail} gaussians "
            f"at or past it; integer-equal")
    log(f"[k1] edge cases ({n} gaussians, 3,000 empty in a row, six of "
        f"8,160 slots, total {total}): integer-equal")


def compare_k2(out_k, out_p, what, kernel="K2", tol=K2_TOL):
    import torch

    rows = [0, 1, 2, 3, 5]
    err = float((out_k[:, rows] - out_p[:, rows]).abs().max())
    if not torch.equal(out_k[:, 4], out_p[:, 4]):
        raise AssertionError(f"{kernel} chunks_done differs ({what})")
    if not err <= tol:
        raise AssertionError(f"{kernel} differs from plain by {err} ({what})")
    log(f"[{kernel.lower()}] {what}: max |err| {err:.3g}, chunks_done equal")
    return err


def check_chunks_uniform(out, what, kernel="K2"):
    """Output row 4 (chunks_done) must be one value over every pixel of
    every tile: the tile stops at once, and K4 re-walks the chunks_done it
    reads at the tile's pixel 0."""
    import torch

    done = out[:, 4]
    if not torch.equal(done, done[:, :1].expand_as(done)):
        bad = int((done != done[:, :1]).any(dim=1).sum())
        raise AssertionError(f"{kernel} chunks_done varies within {bad} "
                             f"tiles ({what})")
    log(f"[{kernel.lower()}] {what}: chunks_done one value a tile over all "
        f"{out.shape[0]} tiles")


def walked_per_tile(b, out):
    """Instances K2 walked in each tile, (T,) int64: [start, min(end,
    astart + 128 chunks_done)), with ``out`` its output on ``b``'s bounds."""
    from splatjax_torch.ops.rasterize import CHUNK

    start = b.starts.long()
    astart = start // CHUNK * CHUNK
    done = out[:, 4, 0].long()
    stop = b.ends.long().minimum(astart + CHUNK * done)
    return (stop - start).clamp_min(0)


def walked_instances(b, out) -> int:
    return int(walked_per_tile(b, out).sum())


def gate_zbuf(cfg, device):
    import torch
    from splatjax_torch.ops.rasterize import zbuffer_to_tiles

    return zbuffer_to_tiles(torch.full((cfg.height, cfg.width), -2.45,
                                       device=device), cfg)


def at_tile(tile):
    """The tile edge in a log line: empty at the default 16 px."""
    return "" if tile == 16 else f", {tile} px tiles"


def check_k2_small(gate_scene, gate_cam, packed16, tile=16):
    from splatjax_torch.ops.rasterize import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    err = 0.0
    cfg, b, rows = binned_rows(gate_scene, gate_cam, 1 << 16, 1e-4,
                               packed16, tile)
    zb = gate_zbuf(cfg, rows.device)
    for clip, es, z in ((0.999, 1e-4, None), (None, 0.0, None),
                        (0.999, 1e-4, zb)):
        out_k = rasterize_fwd(rows, b.starts, b.ends, cfg, clip, es, z,
                              packed16)
        out_p = rasterize_fwd_plain(rows, b.starts, b.ends, cfg, clip, es,
                                    z, packed16=packed16)
        err = max(err, compare_k2(
            out_k, out_p, f"{16 if packed16 else 32}-byte rows, all "
            f"{cfg.num_tiles} tiles of {cfg.width}x{cfg.height}, clip={clip} "
            f"early_stop={es} zbuf={'yes' if z is not None else 'no'}"
            + at_tile(tile)))
    return err


def check_k2_full(scene, cam, capacity, packed16, tile=16):
    from splatjax_torch.ops.rasterize import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    cfg, b, rows = binned_rows(scene, cam, capacity, 1e-4, packed16, tile)
    args = (rows, b.starts, b.ends, cfg, 0.999, 1e-4, None)
    out_k = rasterize_fwd(*args, packed16)
    tiles = sample_tiles(b, cfg, rows.device)
    out_p = rasterize_fwd_plain(*args, tiles=tiles, packed16=packed16)
    err = compare_k2(out_k[tiles], out_p,
                     f"{16 if packed16 else 32}-byte rows, {tiles.numel()} "
                     f"sampled tiles of {cfg.width}x{cfg.height}"
                     + at_tile(tile))
    check_chunks_uniform(out_k, f"{16 if packed16 else 32}-byte rows, full "
                         f"frame" + at_tile(tile))
    ms, timed = kernel_ms(lambda: rasterize_fwd(*args, packed16), 10,
                           ("rasterize_fwd", "splat_rasterize_fwd"))
    plain_ms = cuda_ms(lambda: rasterize_fwd_plain(*args,
                                                   packed16=packed16), 1)
    walked = walked_instances(b, out_k)
    p = cfg.pixels_per_tile
    b_ms, b_by = bound(
        walked * (16 if packed16 else 32) + cfg.num_tiles * (8 * p * 4 + 8),
        walked * p * roofline().FWD_OPS_PER_FRAGMENT,
    )
    log(f"[k2] full frame, {16 if packed16 else 32}-byte rows"
        f"{at_tile(tile)}: {int(b.num_instances)} instances, {walked} "
        "walked, kernel "
        f"{ms:.4f} ms ({timed}), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


SHIFTS = (0, 1, 63, 64, 65, 127)   # dummy rows put before the instance rows


def check_shifted_chunks(gate_scene, gate_cam, tile):
    """K2 (both row widths) and K3 on every tile of the gate scene against
    their plain versions with the instance rows moved s rows on in their
    buffer (s dummy rows before them, ``starts``/``ends`` moved by s), for
    each s in SHIFTS: the chunks are aligned to global multiples of 128,
    so each s moves the chunk grid under the tiles; chunks whose live rows
    lie all past row 64, all before it, or are one row must each occur
    (``chunk_kinds``, counted over the shifts and printed). chunks_done
    must be one value a tile at every s. Then K4 (both row widths, an
    8-channel cotangent) on the kernel's forward output on the same moved
    rows, against its plain version at K4_TOL: the 8 px K4 walks and adds
    a chunk's back half (rows 64-127) before its front half, so the same
    kinds of chunk give it an empty front half, an empty back half and a
    single row. Returns the largest error of each kernel's counter."""
    import torch
    from splatjax_torch.ops.rasterize import (
        rasterize_cached_fwd, rasterize_cached_fwd_plain, rasterize_fwd,
        rasterize_fwd_plain,
    )
    from splatjax_torch.ops.rasterize_vjp import (
        rasterize_bwd, rasterize_bwd_plain,
    )

    def k2_case(packed16):
        cfg, b, rows = binned_rows(gate_scene, gate_cam, 1 << 16, 1e-4,
                                   packed16, tile)

        def run(r, starts, ends, clip, es):
            return (rasterize_fwd(r, starts, ends, cfg, clip, es, None,
                                  packed16),
                    rasterize_fwd_plain(r, starts, ends, cfg, clip, es, None,
                                        packed16=packed16))
        return ("rasterize_fwd16" if packed16 else "rasterize_fwd", "K2",
                K2_TOL, f"{16 if packed16 else 32}-byte rows", rows,
                b.starts, b.ends, run)

    bins = cached_bins(gate_scene, gate_cam, 1 << 16, tile)
    prm, camera, _, _, cfg = k3_args(bins, gate_cam, None, None, tile)[:5]

    def run_k3(r, starts, ends, clip, es):
        return (rasterize_cached_fwd(r, camera, starts, ends, cfg, clip, es),
                rasterize_cached_fwd_plain(r, camera, starts, ends, cfg, clip,
                                           es))

    cases = [k2_case(False), k2_case(True),
             ("rasterize_cached", "K3", K3_TOL, "cached rows", prm,
              bins.bins.starts, bins.bins.ends, run_k3)]
    err = {}
    for name, kernel, tol, what, rows, starts, ends, run in cases:
        err[name] = 0.0
        kinds = [sum(n) for n in zip(*(chunk_kinds(starts + s, ends + s)
                                       for s in SHIFTS))]
        log(f"[{kernel.lower()}] {what}{at_tile(tile)}, rows moved "
            f"{', '.join(map(str, SHIFTS))} on: (tile, chunk)s whose live "
            f"rows lie all past row 64 {kinds[0]}, all before it "
            f"{kinds[1]}, one row {kinds[2]}")
        if min(kinds) == 0:
            raise AssertionError(f"{kernel} ({what}): the row shifts miss a "
                                 f"kind of chunk: {kinds}")
        for s in SHIFTS:
            moved = torch.cat([rows.new_zeros((s,) + rows.shape[1:]), rows])
            for clip, es in ((0.999, 1e-4), (None, 0.0)):
                out_k, out_p = run(moved, starts + s, ends + s, clip, es)
                label = (f"{what}, rows moved {s} on, all "
                         f"{out_k.shape[0]} tiles, clip={clip} "
                         f"early_stop={es}" + at_tile(tile))
                err[name] = max(err[name], compare_k2(
                    out_k, out_p, label, kernel=kernel, tol=tol))
                check_chunks_uniform(out_k, label, kernel=kernel)
    if tile != 8:
        return err
    err["rasterize_bwd"] = 0.0
    for packed16 in (False, True):
        cfg, b, rows = binned_rows(gate_scene, gate_cam, 1 << 16, 1e-4,
                                   packed16, tile)
        what = f"{16 if packed16 else 32}-byte rows"
        kinds = [sum(n) for n in zip(*(chunk_kinds(b.starts + s, b.ends + s)
                                       for s in SHIFTS))]
        log(f"[k4] {what}{at_tile(tile)}, rows moved "
            f"{', '.join(map(str, SHIFTS))} on: (tile, chunk)s whose live "
            f"rows lie all past row 64 {kinds[0]}, all before it "
            f"{kinds[1]}, one row {kinds[2]}")
        if min(kinds) == 0:
            raise AssertionError(f"K4 ({what}): the row shifts miss a kind "
                                 f"of chunk: {kinds}")
        g = torch.Generator(device=rows.device).manual_seed(0)
        g_out = torch.randn((cfg.num_tiles, 8, cfg.pixels_per_tile),
                            generator=g, device=rows.device)
        for s in SHIFTS:
            moved = torch.cat([rows.new_zeros((s,) + rows.shape[1:]), rows])
            starts, ends = b.starts + s, b.ends + s
            for clip, es in ((0.999, 1e-4), (None, 0.0)):
                out = rasterize_fwd(moved, starts, ends, cfg, clip, es, None,
                                    packed16)
                args = (moved, starts, ends, out, g_out, cfg, clip)
                err["rasterize_bwd"] = max(err["rasterize_bwd"], compare_k4(
                    rasterize_bwd(*args, packed16=packed16),
                    rasterize_bwd_plain(*args, packed16=packed16), packed16,
                    f"{what}, rows moved {s} on, all {cfg.num_tiles} tiles, "
                    f"clip={clip} early_stop={es}" + at_tile(tile)))
    return err


def chunk_kinds(starts, ends):
    """Of the (tile, chunk)s of the tiles' rows [starts, ends) on the global
    grid of CHUNK rows, those whose live rows [lo, hi) lie all past row 64
    (lo >= 64), all before it (hi <= 64), and those of one row."""
    from splatjax_torch.ops.rasterize import CHUNK

    live = ends > starts
    start, end = starts[live].long(), ends[live].long()
    astart = start // CHUNK * CHUNK
    kinds = [0, 0, 0]
    for c in range(int((end - astart - 1).max()) // CHUNK + 1
                   if start.numel() else 0):
        base = astart + c * CHUNK
        on = base < end
        lo = (start - base).clamp_min(0)[on]
        hi = (end - base).clamp_max(CHUNK)[on]
        for i, hit in enumerate((lo >= CHUNK // 2, hi <= CHUNK // 2,
                                 hi - lo == 1)):
            kinds[i] += int(hit.sum())
    return kinds


def cached_bins(scene, cam, capacity, tile=16):
    from splatjax_torch.render import bin_scene

    bins = bin_scene(scene, cam, tile_size=tile, capacity=capacity,
                     cache_params=True)
    if int(bins.bins.overflow) != 0:
        raise AssertionError(f"overflow {int(bins.bins.overflow)} at "
                             f"{capacity}")
    return bins


def k3_args(bins, cam, clip, es, tile=16):
    from splatjax_torch.ops.binning import TileConfig
    from splatjax_torch.ops.rasterize import cached_camera

    return (bins.prm, cached_camera(cam.modelview, cam.projection, cam.width,
                                    cam.height),
            bins.bins.starts, bins.bins.ends,
            TileConfig(cam.width, cam.height, tile, tile), clip, es)


def check_k3_small(gate_scene, gate_cam, tile=16):
    """K3 on every tile of the gate scene: bins at the gate camera, drawn
    there and at a moved eye."""
    from splatjax_torch import make_camera
    from splatjax_torch.ops.rasterize import (
        rasterize_cached_fwd, rasterize_cached_fwd_plain,
    )

    bins = cached_bins(gate_scene, gate_cam, 1 << 16, tile)
    moved = make_camera((0.13, -0.18, 2.4), (0, 0, 0), width=gate_cam.width,
                        height=gate_cam.height)
    err = 0.0
    for name, c in (("bin camera", gate_cam), ("moved eye", moved)):
        for clip in (0.999, None):
            for es in (1e-4, 0.0):
                args = k3_args(bins, c, clip, es, tile)
                err = max(err, compare_k2(
                    rasterize_cached_fwd(*args),
                    rasterize_cached_fwd_plain(*args),
                    f"all {args[4].num_tiles} tiles of {c.width}x"
                    f"{c.height}, {name}, clip={clip} early_stop={es}"
                    + at_tile(tile), kernel="K3", tol=K3_TOL))
    return err


def check_k3_full(scene, cam, capacity, tile=16):
    """K3 on the full-width frame: bins at ``cam``, drawn at the orbit's
    second eye; 64 sampled tiles against the plain version, kernel and
    plain times, bound."""
    from splatjax_torch import make_camera
    from splatjax_torch.ops.rasterize import (
        rasterize_cached_fwd, rasterize_cached_fwd_plain,
    )

    bins = cached_bins(scene, cam, capacity, tile)
    eye = make_camera(ORBIT[1], (0, 0, 0), width=WIDTH, height=HEIGHT)
    args = k3_args(bins, eye, 0.999, 1e-4, tile)
    out_k = rasterize_cached_fwd(*args)
    tiles = sample_tiles(bins.bins, args[4], out_k.device)
    out_p = rasterize_cached_fwd_plain(*args, tiles=tiles)
    err = compare_k2(out_k[tiles], out_p,
                     f"{tiles.numel()} sampled tiles of {WIDTH}x{HEIGHT} at "
                     "an orbit eye" + at_tile(tile), kernel="K3", tol=K3_TOL)
    check_chunks_uniform(out_k, "full frame at an orbit eye" + at_tile(tile),
                         kernel="K3")
    ms, timed = kernel_ms(lambda: rasterize_cached_fwd(*args), 10,
                           ("rasterize_cached", "splat_rasterize_cached_fwd"))
    plain_ms = cuda_ms(lambda: rasterize_cached_fwd_plain(*args), 1)
    walked = walked_instances(bins.bins, out_k)
    cfg = args[4]
    p = cfg.pixels_per_tile
    b_ms, b_by = bound(
        walked * 64 + cfg.num_tiles * (8 * p * 4 + 8),
        walked * (p * roofline().FWD_OPS_PER_FRAGMENT
                  + roofline().CACHED_OPS_PER_INSTANCE),
    )
    log(f"[k3] full frame{at_tile(tile)}: {int(bins.bins.num_instances)} "
        "instances, "
        f"{walked} walked, kernel {ms:.4f} ms ({timed}), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def fused_quality_gate(scene, cam, capacity):
    """The full-width fused 16-byte redraw at the bins' camera against the
    32-byte render, and the packed 16-byte cached redraw (K2-16) beside
    it."""
    from splatjax_torch.render import render, render_binned

    bins = cached_bins(scene, cam, capacity)
    kw = dict(alpha_clip=0.999, early_stop=1e-4)
    exact = render(scene, cam, capacity=capacity, feature_bytes=32, **kw)
    fused = render_binned(scene, cam, bins, feature_bytes=16, **kw)
    # asking for depth takes the packed path (splatjax's condition)
    packed, _ = render_binned(scene, cam, bins, feature_bytes=16,
                              return_depth=True, **kw)
    err_fused = float((fused - exact).abs().max())
    err_packed = float((packed - exact).abs().max())
    log(f"[fused] {WIDTH}x{HEIGHT} at the bins' camera vs the 32-byte "
        f"render: fused 16-byte redraw (K3) max |err| {err_fused:.3g}, "
        f"packed 16-byte cached redraw (K2-16) {err_packed:.3g}")
    if not err_fused <= FUSED_TOL:
        raise AssertionError(f"fused redraw {err_fused} from the 32-byte "
                             "render")
    if not err_fused <= err_packed:
        raise AssertionError("fused redraw further from the 32-byte render "
                             f"than the packed one: {err_fused} > "
                             f"{err_packed}")


def k4_case(scene, cam, capacity, packed16, clip, zbuf, gch, seed=0,
            tile=16):
    """Forward by the kernel, then a seeded random planar cotangent."""
    import torch
    from splatjax_torch.ops.rasterize import rasterize_fwd

    cfg, b, rows = binned_rows(scene, cam, capacity, 1e-4, packed16, tile)
    zb = gate_zbuf(cfg, rows.device) if zbuf else None
    out = rasterize_fwd(rows, b.starts, b.ends, cfg, clip, 1e-4, zb,
                        packed16)
    g = torch.Generator(device=rows.device).manual_seed(seed)
    g_out = torch.randn((cfg.num_tiles, gch, cfg.pixels_per_tile),
                        generator=g, device=rows.device)
    return cfg, b, (rows, b.starts, b.ends, out, g_out, cfg, clip, zb)


def compare_k4(g_k, g_p, packed16, what, tol=K4_TOL):
    """Max |kernel - plain| after checking it against K4_TOL x each
    channel's max |value| (plus one bf16 ulp for packed rows)."""
    from splatjax_torch.ops.segreduce import unpack_bf16_pairs

    extra = 0.0
    if packed16:
        g_k, g_p = unpack_bf16_pairs(g_k), unpack_bf16_pairs(g_p)
        extra = 2.0 ** -7 * g_p.abs()
    scale = g_p.abs().amax(dim=0).clamp_min(1e-30)
    err = (g_k - g_p).abs()
    rel = err / scale
    worst = rel.argmax(dim=0)
    log(f"[k4]   per channel, max |err| / channel max: " + " ".join(
        f"{float(rel[int(worst[c]), c]):.2e}" for c in range(10))
        + "; instances over 1e-4: " + " ".join(
        str(int((rel[:, c] > 1e-4).sum())) for c in range(10))
        + "; |plain| / max at the worst: " + " ".join(
        f"{float(g_p[int(worst[c]), c].abs() / scale[c]):.2e}"
        for c in range(10)))
    if not bool((err <= tol * scale + extra).all()):
        raise AssertionError(f"K4 differs from plain ({what}): "
                             f"{float(rel.max()):.3g} of a channel's max")
    if not bool(g_k.isfinite().all()) or float(g_p.abs().max()) == 0.0:
        raise AssertionError(f"K4 rows not finite or all zero ({what})")
    e = float(err.max())
    log(f"[k4] {what}: max |err| {e:.3g} ({float(rel.max()):.3g} "
        "of a channel's max)")
    return e


def check_k4_small(gate_scene, gate_cam, tile=16):
    from splatjax_torch.ops.rasterize_vjp import (
        rasterize_bwd, rasterize_bwd_plain,
    )

    err = 0.0
    for packed16 in (False, True):
        for clip in (0.999, None):
            for zbuf in (False, True):
                for gch in (4, 8):
                    cfg, _, args = k4_case(gate_scene, gate_cam, 1 << 16,
                                           packed16, clip, zbuf, gch,
                                           tile=tile)
                    err = max(err, compare_k4(
                        rasterize_bwd(*args, packed16=packed16),
                        rasterize_bwd_plain(*args, packed16=packed16),
                        packed16,
                        f"{16 if packed16 else 32}-byte rows, all "
                        f"{cfg.num_tiles} tiles of {cfg.width}x"
                        f"{cfg.height}, clip={clip} "
                        f"zbuf={'yes' if zbuf else 'no'} {gch}-channel "
                        "cotangent" + at_tile(tile)))
    return err


def check_k4_full(scene, cam, capacity, packed16, tile=16):
    """K4 on the full-width frame: the instances of 64 sampled tiles
    against the plain version, kernel and plain times, bound. Returns the
    numbers and the kernel's gradient rows (the segment sums' input)."""
    import torch
    from splatjax_torch.ops.rasterize_vjp import (
        rasterize_bwd, rasterize_bwd_plain,
    )

    cfg, b, args = k4_case(scene, cam, capacity, packed16, 0.999, False, 4,
                           tile=tile)
    g_k = rasterize_bwd(*args, packed16=packed16)
    if not torch.equal(g_k, rasterize_bwd(*args, packed16=packed16)):
        raise AssertionError(f"K4 rows differ between two runs "
                             f"({16 if packed16 else 32}-byte rows"
                             f"{at_tile(tile)})")
    log(f"[k4] full frame, {16 if packed16 else 32}-byte rows"
        f"{at_tile(tile)}: two runs bit-identical")
    tiles = sample_tiles(b, cfg, g_k.device)
    g_p = rasterize_bwd_plain(*args, tiles=tiles, packed16=packed16)
    idx = torch.cat([torch.arange(int(b.starts[t]), int(b.ends[t]),
                                  device=g_k.device) for t in tiles])
    deepest = int((b.ends - b.starts)[tiles].max())
    width = 16 if packed16 else 32
    err = compare_k4(g_k[idx], g_p[idx], packed16,
                     f"{width}-byte rows, the {idx.numel()} instances of "
                     f"{tiles.numel()} sampled tiles of {cfg.width}x"
                     f"{cfg.height} (deepest walks {deepest} instances)"
                     + at_tile(tile), tol=K4_TOL_FULL)
    ms, timed = kernel_ms(lambda: rasterize_bwd(*args, packed16=packed16),
                           10, ("rasterize_bwd", "splat_rasterize_bwd"))
    plain_ms = cuda_ms(lambda: rasterize_bwd_plain(*args,
                                                   packed16=packed16), 1)
    out = args[3]
    walked = walked_instances(b, out)
    p = cfg.pixels_per_tile
    out_bytes = 32 if packed16 else 64
    b_ms, b_by = bound(
        walked * (32 + out_bytes) + cfg.num_tiles * (8 + 8 * p * 4
                                                     + 4 * p * 4),
        walked * p * roofline().BWD_OPS_PER_FRAGMENT,
    )
    log(f"[k4] full frame, {width}-byte rows{at_tile(tile)}: {walked} "
        "walked instances, "
        f"kernel {ms:.4f} ms ({timed}), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by), b, g_k


def k4_tail_cases(rows16, b, cfg, walked):
    """K4's arguments (16-byte rows, as in training, a seeded 4-channel
    cotangent) for the ``[tail]`` lines, by name: ``alone``, the deepest
    tile by ``walked`` (instances per tile) alone, every other tile given
    ends = starts; at 8 px ``bulk``, the frame with its deepest 1% of
    tiles emptied so; ``frame``, the whole frame. Each takes the forward's
    output on its bounds."""
    import torch
    from splatjax_torch.ops.rasterize import rasterize_fwd

    g = torch.Generator(device=rows16.device).manual_seed(0)
    g_out = torch.randn((cfg.num_tiles, 4, cfg.pixels_per_tile),
                        generator=g, device=rows16.device)
    deep = int(walked.argmax())
    bounds = {"alone": b.starts.clone()}
    bounds["alone"][deep] = b.ends[deep]
    if cfg.tile_w == 8:
        top = walked.topk(-(-cfg.num_tiles // 100)).indices
        bounds["bulk"] = b.ends.clone()
        bounds["bulk"][top] = b.starts[top]
    bounds["frame"] = b.ends
    return {name: (rows16, b.starts, ends,
                   rasterize_fwd(rows16, b.starts, ends, cfg, 0.999, 1e-4,
                                 packed16=True), g_out, cfg, 0.999)
            for name, ends in bounds.items()}


def tail_diagnostics(scene, cam, capacity, tile=16):
    """How the full-width frame's work spreads over its tiles at tile edge
    ``tile``, and whether the rasterizers are tail-bound: the
    walked-instance distribution per tile; K2 (32-byte rows), K3 (at the
    bins' camera) and K4 (16-byte rows, as in training) on the deepest tile
    alone (every other tile given ends = starts; K4 takes the forward's
    output on those bounds) beside the whole frame, and at 8 px K4 on the
    frame without its deepest 1% of tiles (``k4_tail_cases``); and K4 with
    its tiles ordered by walked instances (each tile's end cut to its
    walked end, past which K4 never reads, so the wrapper's order by list
    length becomes the order by walked instances) against the bins'
    order."""
    import torch
    from splatjax_torch.ops.binning import features_from_projection
    from splatjax_torch.ops.rasterize import (
        pack_gather_rows, rasterize_cached_fwd, rasterize_fwd,
    )
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd

    cfg, b, rows = binned_rows(scene, cam, capacity, 1e-4, tile=tile)
    with torch.no_grad():
        rows16 = pack_gather_rows(features_from_projection(
            projected(scene, cam, 1e-4)), b.gauss_id, True)
    fwd = dict(alpha_clip=0.999, early_stop=1e-4)
    walked = walked_per_tile(b, rasterize_fwd(rows, b.starts, b.ends, cfg,
                                              **fwd)).double()
    deep = int(walked.argmax())
    log(f"[tail] walked instances per tile over {cfg.num_tiles} tiles"
        f"{at_tile(tile)}: mean "
        f"{float(walked.mean()):.1f}, p99 "
        f"{float(torch.quantile(walked, 0.99)):.1f}, max {int(walked[deep])} "
        f"(tile {deep}, {deep / cfg.num_tiles:.2f} of the way through the "
        "tile index)")
    alone = b.starts.clone()
    alone[deep] = b.ends[deep]
    k4 = k4_tail_cases(rows16, b, cfg, walked)
    cb = cached_bins(scene, cam, capacity, tile)
    prm, camera, starts3 = k3_args(cb, cam, None, None, tile)[:3]
    alone3 = starts3.clone()
    alone3[deep] = cb.bins.ends[deep]
    out = {}
    for name, ends, ends3 in (("alone", alone, alone3),
                              ("frame", b.ends, cb.bins.ends)):
        out["k2", name] = kernel_ms(
            lambda: rasterize_fwd(rows, b.starts, ends, cfg, **fwd), 10,
            ("rasterize_fwd", "splat_rasterize_fwd"))
        out["k3", name] = kernel_ms(
            lambda: rasterize_cached_fwd(prm, camera, starts3, ends3, cfg,
                                         **fwd), 10,
            ("rasterize_cached", "splat_rasterize_cached_fwd"))
    for name, args in k4.items():
        out["k4", name] = kernel_ms(
            lambda: rasterize_bwd(*args, packed16=True), 10,
            ("rasterize_bwd", "splat_rasterize_bwd"))
    for k, what in (("k2", "K2 32-byte"), ("k3", "K3 at the bins' camera"),
                    ("k4", "K4 16-byte")):
        (a_ms, a_tr), (f_ms, f_tr) = out[k, "alone"], out[k, "frame"]
        log(f"[tail] {what}{at_tile(tile)}: deepest tile alone {a_ms:.4f} "
            f"ms ({a_tr}), "
            f"whole frame {f_ms:.4f} ms ({f_tr}; {a_ms / f_ms:.3f} of it)")
    if "bulk" in k4:
        bulk_ms, bulk_tr = out["k4", "bulk"]
        n_top = -(-cfg.num_tiles // 100)
        log(f"[tail] K4 16-byte{at_tile(tile)}: the frame without its "
            f"deepest 1% of tiles ({n_top} emptied, "
            f"{int(walked.topk(n_top).values.sum())} walked instances) "
            f"{bulk_ms:.4f} ms ({bulk_tr}), the deepest tile alone "
            f"{out['k4', 'alone'][0]:.4f}, the whole frame "
            f"{out['k4', 'frame'][0]:.4f}")

    args = k4["frame"][3:]  # the forward's output, cotangent, cfg, clip
    walked16 = walked_per_tile(b, args[0])
    walked_ends = (b.starts.long() + walked16).to(torch.int32)
    if tile > 16:
        k4_balance(rows16, b, cfg, walked_ends)
    by_len = rasterize_bwd(rows16, b.starts, b.ends, *args, packed16=True)
    by_walked = rasterize_bwd(rows16, b.starts, walked_ends, *args,
                              packed16=True)
    if not torch.equal(by_len, by_walked):
        raise AssertionError("K4 rows depend on the tile order")
    len_ms, len_tr = kernel_ms(
        lambda: rasterize_bwd(rows16, b.starts, b.ends, *args,
                              packed16=True), 10, ("rasterize_bwd", "splat_rasterize_bwd"))
    walk_ms, walk_tr = kernel_ms(
        lambda: rasterize_bwd(rows16, b.starts, walked_ends, *args,
                              packed16=True), 10, ("rasterize_bwd", "splat_rasterize_bwd"))
    log(f"[tail] K4 16-byte{at_tile(tile)}, tiles by list length (the "
        "bins' order) "
        f"{len_ms:.4f} ms ({len_tr}), by walked instances {walk_ms:.4f} ms "
        f"({walk_tr}); rows bit-identical")


def k4_balance(rows16, b, cfg, walked_ends):
    """How the 32 and 64 px K4 cluster's walk spreads over its blocks on
    the full frame: the (instance, 16x16 sub-block) pairs a block walks
    (``support_rect``, the plain twin of the kernel's support mask, on
    the 16-byte rows), and, since every block waits at a cluster barrier
    each chunk, the busiest block's pairs summed over the frame's (tile,
    chunk)s beside the mean block's, over all tiles and on the deepest
    one; and each tile's busiest block over all its chunks, summed over
    the tiles: the walk if blocks waited only at the tile's end. A
    ``[tail]`` line."""
    import torch
    from splatjax_torch.ops.rasterize import CHUNK, decode_rows, support_rect

    tile, sub = cfg.tile_w, 16
    cols = tile // sub
    starts, ends = b.starts.long(), walked_ends.long()
    k = torch.arange(int(ends.max()), device=rows16.device)
    t = b.tile_id[:k.numel()].long()
    walked = (t < cfg.num_tiles)
    t = t.clamp_max(cfg.num_tiles - 1)
    walked &= (k >= starts[t]) & (k < ends[t])
    k, t = k[walked], t[walked]
    f = decode_rows(rows16[k], True)
    ox = (t % cfg.tiles_x).float() * tile + 0.5 * tile
    oy = (t // cfg.tiles_x).float() * tile + 0.5 * tile
    x0, x1, y0, y1 = support_rect(f[0] - ox, f[1] - oy, f[2], f[3], f[4],
                                  f[8].clamp_min(1e-30).log(), tile)
    lo = torch.arange(cols, device=k.device).float() * sub - 0.5 * tile + 0.5
    hit_x = ~((x0[:, None] > lo + sub - 1) | (x1[:, None] < lo))
    hit_y = ~((y0[:, None] > lo + sub - 1) | (y1[:, None] < lo))
    reach = (hit_y[:, :, None] & hit_x[:, None, :]).reshape(-1, cols * cols)
    # (tile, chunk) of each walked instance, chunks counted from astart
    chunk = (k - starts[t] // CHUNK * CHUNK) // CHUNK
    n_chunks = int(chunk.max()) + 1
    uniq, inv = torch.unique(t * n_chunks + chunk, return_inverse=True)
    per = torch.zeros((uniq.numel(), cols * cols), dtype=torch.int64,
                      device=k.device)
    per.index_add_(0, inv, reach.long())
    busiest, mean = per.amax(dim=1), per.float().mean(dim=1)
    per_tile = torch.zeros((cfg.num_tiles, cols * cols), dtype=torch.int64,
                           device=k.device)
    per_tile.index_add_(0, uniq // n_chunks, per)
    deep = int((ends - starts).clamp_min(0).argmax())
    on_deep = uniq // n_chunks == deep
    log(f"[tail] K4 blocks{at_tile(tile)}: {int(reach.sum())} (instance, "
        f"16x16 sub-block) pairs walked, {float(reach.sum()) / k.numel():.2f}"
        f" sub-blocks an instance, over {uniq.numel()} (tile, chunk)s; "
        f"busiest block {int(busiest.sum())} pairs summed over them, mean "
        f"block {float(mean.sum()):.0f} (balance "
        f"{float(mean.sum() / busiest.sum()):.3f}); each tile's busiest "
        f"block over all its chunks {int(per_tile.amax(dim=1).sum())}; "
        f"deepest tile's {int(on_deep.sum())} chunks: busiest "
        f"{int(busiest[on_deep].sum())}, mean "
        f"{float(mean[on_deep].sum()):.0f}, busiest over all "
        f"{int(per_tile[deep].max())}")


def _check_runs(k, p, abs_sum, run_len, name):
    tol = run_len[:, None].float() * SEG_ULP * abs_sum
    err = (k - p).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name} differs from plain beyond (run length)"
                             f" x 2^-23 x sum|rows|: max {float(err.max())}")
    return float(err.max())


def check_segreduce(b, g32, g16):
    """K5, K6, K7 against their plain versions on the full-width
    backward's rows; times, bounds and the library calls' times."""
    import torch
    from splatjax_torch.ops.binning import (
        _effective_cum, _gid_order, quantize_grad_u16,
    )
    from splatjax_torch.ops import segreduce as sr

    k = g32.shape[0]
    eff = _effective_cum(b.cum, b.count, b.perm, b.cum_d, b.count_d,
                         b.overflow, k)
    n = eff.shape[0]
    order = _gid_order(b.gauss_id)
    run_len = torch.diff(eff.long(), prepend=eff.new_zeros(1).long())
    total = int(eff[-1])
    gid_sorted = b.gauss_id.index_select(0, order)[:total].long()
    rows32 = g32.index_select(0, order)
    packed_u16 = quantize_grad_u16(g32)[0].index_select(0, order)
    rows16 = g16.index_select(0, order)
    cases = (
        ("segreduce_rows", sr.segment_reduce_rows,
         sr.segment_reduce_rows_plain, rows32, rows32, 64,
         ("segreduce", "splat_segreduce_f32")),
        ("segreduce_u16", sr.segment_reduce_packed_u16,
         sr.segment_reduce_packed_u16_plain, packed_u16,
         sr.unpack_u16_pairs(packed_u16).float(), 32,
         ("segreduce", "splat_segreduce_packed")),
        ("segreduce_bf16", sr.segment_reduce_packed_bf16,
         sr.segment_reduce_packed_bf16_plain, rows16,
         sr.unpack_bf16_pairs(rows16), 32, ("segreduce", "splat_segreduce_packed")),
    )
    out = {}
    for name, fn, plain, rows, decoded, row_bytes, kname in cases:
        got, want = fn(rows, eff), plain(rows, eff)
        sync()
        if name == "segreduce_u16":
            if not torch.equal(got, want):
                raise AssertionError("K6 is not bit-equal to its plain "
                                     "version")
            err = 0.0
        else:
            abs_sum = sr.segment_reduce_rows_plain(decoded.abs(), eff)
            err = _check_runs(got, want, abs_sum, run_len, name)
        ms, timed = kernel_ms(lambda: fn(rows, eff), 10, kname)
        plain_ms = cuda_ms(lambda: plain(rows, eff), 3)
        data = decoded[:total].contiguous()
        seg_ms = cuda_ms(lambda: torch.segment_reduce(
            data, "sum", lengths=run_len, axis=0), 10)
        add_ms = cuda_ms(lambda: torch.zeros(
            (n, 16), device=data.device).index_add_(0, gid_sorted, data), 10)
        b_ms, b_by = bound(total * row_bytes + n * 4 + n * 64, total * 16)
        log(f"[seg] {name}: {total} rows onto {n} gaussians, max |err| "
            f"{err:.3g}; kernel {ms:.4f} ms ({timed}), plain "
            f"{plain_ms:.4f} ms, "
            f"torch.segment_reduce {seg_ms:.4f} ms, index_add_ "
            f"{add_ms:.4f} ms (on the decoded f32 rows), bound {b_ms:.4f} "
            f"ms ({b_by})")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=seg_ms)
    return out


def check_segreduce_slots(b, g32, g16):
    """The main path's K5, K6, K7: the slot entries on the full-width
    backward's rows in tile order (slot_pos the inverse of the tile sort),
    against the gid-sort plain path (K6 bit-equal, K5/K7 within the run
    tolerance) and run twice (bit-identical); kernel, plain, bound and the
    index_add_ yardstick's times."""
    import torch
    from splatjax_torch.ops import segreduce as sr
    from splatjax_torch.ops.binning import (
        _effective_cum, _gid_order, quantize_grad_u16, tile_slot_positions,
    )

    k = g32.shape[0]
    eff = _effective_cum(b.cum, b.count, b.perm, b.cum_d, b.count_d,
                         b.overflow, k)
    n = eff.shape[0]
    order = _gid_order(b.gauss_id)
    run_len = torch.diff(eff.long(), prepend=eff.new_zeros(1).long())
    total = int(eff[-1])
    slot_pos = tile_slot_positions(b.by_tile)
    gid = b.gauss_id.long()
    packed_u16 = quantize_grad_u16(g32)[0]
    cases = (
        ("segreduce_rows", sr._segment_reduce_slots_rows,
         sr._segment_reduce_slots_rows_plain,
         sr.segment_reduce_rows_plain, g32, g32, 64,
         "splat_segreduce_slots_f32"),
        ("segreduce_u16", sr._segment_reduce_slots_packed_u16,
         sr._segment_reduce_slots_packed_u16_plain,
         sr.segment_reduce_packed_u16_plain, packed_u16,
         sr.unpack_u16_pairs(packed_u16).float(), 32,
         "splat_segreduce_slots_packed"),
        ("segreduce_bf16", sr._segment_reduce_slots_packed_bf16,
         sr._segment_reduce_slots_packed_bf16_plain,
         sr.segment_reduce_packed_bf16_plain, g16,
         sr.unpack_bf16_pairs(g16), 32, "splat_segreduce_slots_packed"),
    )
    out = {}
    for name, fn, plain, gid_plain, rows, decoded, row_bytes, entry in cases:
        args = (rows, slot_pos, b.cum_d, b.perm)
        got, again = fn(*args), fn(*args)
        want = gid_plain(rows.index_select(0, order), eff)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} (slots) differs between two runs")
        if name == "segreduce_u16":
            if not torch.equal(got, want):
                raise AssertionError("K6 (slots) is not bit-equal to the "
                                     "gid-sort plain path")
            err = 0.0
        else:
            abs_sum = sr.segment_reduce_rows_plain(
                decoded.abs().index_select(0, order), eff)
            err = _check_runs(got, want, abs_sum, run_len, name + " (slots)")
        ms, timed = kernel_ms(lambda: fn(*args), 10, ("segreduce", entry))
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        lib_ms = cuda_ms(lambda: torch.zeros(
            (n, decoded.shape[1]), device=decoded.device).index_add_(
            0, gid, decoded), 10)
        b_ms, b_by = bound(total * (row_bytes + 4) + n * (8 + 64),
                           total * 16)
        log(f"[seg] {name}, slot entry (the training path): {total} rows in "
            f"tile order onto {n} gaussians, max |err| {err:.3g} against "
            f"the gid-sort plain path, two runs bit-identical; kernel "
            f"{ms:.4f} ms ({timed}), plain {plain_ms:.4f} ms, index_add_ "
            f"{lib_ms:.4f} ms (on the decoded f32 rows in tile order), "
            f"bound {b_ms:.4f} ms ({b_by})")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return out


def check_long_runs(device):
    """K5, K6, K7 on runs that the whole block sums (longer than 32 rows,
    up to a screen-filling 8,160 tiles) and on one that K6 sums in int64
    (70,000 rows of q = 32,767, past int32), through the direct and the
    slot entries on the same rows: K6 bit-equal to its plain version, K5/K7
    within the run tolerance, the two entries bit-equal to each other, two
    runs bit-identical."""
    import torch
    from splatjax_torch.ops import segreduce as sr
    from splatjax_torch.ops.rasterize_vjp import _pack_grad_bf16

    gen = torch.Generator(device="cpu").manual_seed(3)
    n = 4096
    counts = torch.randint(0, 6, (n,), generator=gen)
    longest = (33, 100, 257, 1000, 8160, 70000)
    at = torch.randperm(n, generator=gen)[:len(longest)]
    counts[at] = torch.tensor(longest)
    cum = counts.cumsum(0)
    k = int(cum[-1]) + 77                  # slots past every run
    perm = torch.randperm(n, generator=gen)
    slot_pos = torch.randperm(k, generator=gen)
    u = torch.randint(1, 65536, (k, 16), generator=gen)
    big = slot_pos[int(cum[at[-1]]) - 70000:int(cum[at[-1]])]
    u[big] = 65535                         # that run sums 70,000 x 32,767
    packed_u16 = ((u[:, 8:] << 16) | u[:, :8]).int()
    f32 = torch.randn((k, 16), generator=gen)
    rows_of = dict(segreduce_rows=f32, segreduce_u16=packed_u16,
                   segreduce_bf16=_pack_grad_bf16(torch.randn(
                       (k, 16), generator=gen)))
    entries = dict(
        segreduce_rows=(sr.segment_reduce_rows, sr.segment_reduce_rows_plain,
                        sr._segment_reduce_slots_rows, lambda r: r),
        segreduce_u16=(sr.segment_reduce_packed_u16,
                       sr.segment_reduce_packed_u16_plain,
                       sr._segment_reduce_slots_packed_u16,
                       lambda r: sr.unpack_u16_pairs(r).float()),
        segreduce_bf16=(sr.segment_reduce_packed_bf16,
                        sr.segment_reduce_packed_bf16_plain,
                        sr._segment_reduce_slots_packed_bf16,
                        sr.unpack_bf16_pairs))
    i32 = dict(cum_d=cum.int().to(device), perm=perm.int().to(device),
               slot_pos=slot_pos.int().to(device))
    errs = {}
    for name, (direct, plain, slots, decode) in entries.items():
        rows = rows_of[name].to(device)
        grouped = rows.index_select(0, i32["slot_pos"].long()).contiguous()
        d_got = direct(grouped, i32["cum_d"])
        s_args = (rows, i32["slot_pos"], i32["cum_d"], i32["perm"])
        s_got, s_again = slots(*s_args), slots(*s_args)
        want = plain(grouped, i32["cum_d"])
        sync()
        if not torch.equal(s_got, s_again):
            raise AssertionError(f"{name}: two runs differ on long runs")
        if not torch.equal(s_got.index_select(0, i32["perm"].long()),
                           d_got):
            raise AssertionError(f"{name}: slot and direct entries differ "
                                 "on long runs")
        if name == "segreduce_u16":
            if not torch.equal(d_got, want):
                raise AssertionError("K6 on long runs is not bit-equal to "
                                     "its plain version")
            errs[name] = 0.0
        else:
            abs_sum = sr.segment_reduce_rows_plain(decode(grouped).abs(),
                                                   i32["cum_d"])
            errs[name] = _check_runs(d_got, want, abs_sum,
                                     counts.to(device), name + " long runs")
    log(f"[seg] long runs ({n} gaussians, runs of " + ", ".join(
        str(c) for c in longest) + " rows among runs of 0-5): direct and "
        "slot entries bit-equal, two runs bit-identical, max |err| against "
        "plain " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def parity_gate(gate_scene, gate_cam, tile=16, capacity=None):
    """``capacity``: None for render()'s default (4 N, which the gate scene
    overflows at 8 px tiles)."""
    from splatjax_torch.reference import render_reference
    from splatjax_torch.render import render

    img, overflow = render(gate_scene, gate_cam, tile_size=tile,
                           capacity=capacity, early_stop=0.0,
                           alpha_clip=None, return_overflow=True)
    if int(overflow) != 0:
        raise AssertionError(f"parity gate overflow {int(overflow)}")
    ref = render_reference(gate_scene, gate_cam)
    err = float((img - ref).abs().max())
    if not err < PARITY_TOL:
        raise AssertionError(f"parity gate failed{at_tile(tile)}: max err "
                             f"{err}")
    log(f"[parity] 2000 splats 192x128 vs reference{at_tile(tile)}: max err "
        f"{err:.3g}")
    return err


def gradient_gate(gate_scene, gate_cam, tile=16, capacity=None):
    """Port gradients (32-byte rows, exact blend, f32 gather -> K5) against
    torch.autograd through the O(N x P) reference, every leaf."""
    import torch
    from splatjax_torch import kernels
    from splatjax_torch.reference import render_reference
    from splatjax_torch.render import render
    from splatjax_torch.scene import TrainableGaussians

    params = TrainableGaussians.from_scene(gate_scene)
    g = torch.Generator(device=gate_scene.device).manual_seed(1)
    tgt = torch.randn((gate_cam.height, gate_cam.width, 4), generator=g,
                      device=gate_scene.device)
    prev = os.environ.get("SPLATJAX_GRAD_GATHER")
    os.environ["SPLATJAX_GRAD_GATHER"] = "f32"
    try:
        kernels.reset_launches()
        img, overflow = render(params.to_scene(), gate_cam, tile_size=tile,
                               capacity=capacity, early_stop=0.0,
                               return_overflow=True)
        (img * tgt).sum().backward()
        sync()
        launched = dict(kernels.LAUNCHES)
    finally:
        if prev is None:
            del os.environ["SPLATJAX_GRAD_GATHER"]
        else:
            os.environ["SPLATJAX_GRAD_GATHER"] = prev
    if int(overflow) != 0:
        raise AssertionError(f"gradient gate overflow {int(overflow)}")
    got = torch.cat([getattr(params, k).grad.ravel() for k in LEAVES])
    params.zero_grad()
    (render_reference(params.to_scene(), gate_cam) * tgt).sum().backward()
    want = torch.cat([getattr(params, k).grad.ravel() for k in LEAVES])
    scale = float(want.abs().max())
    err = (got - want).abs()
    if not (bool(got.isfinite().all()) and scale > 0 and bool(
            (err <= GRAD_TOL * scale + GRAD_TOL * want.abs()).all())):
        raise AssertionError(f"gradient gate failed: max err "
                             f"{float(err.max())} at scale {scale}")
    for name in (kernels.tiled_counter("rasterize_bwd", tile),
                 "segreduce_rows"):
        if launched[name] == 0:
            raise AssertionError(f"gradient gate skipped {name}: {launched}")
    log(f"[grad] 2000 splats 192x128{at_tile(tile)}, 32-byte rows, f32 "
        "gather: max err "
        f"{float(err.max()):.3g} = {float(err.max()) / scale:.3g} of the "
        f"largest |gradient| {scale:.4g}; launches {launched}")
    return float(err.max()) / scale


def demand(scene, cam, feature_bytes=32, tile=16):
    """Instances the frame needs (capacity 1024 plus the overflow)."""
    import torch
    from splatjax_torch.render import render

    with torch.no_grad():
        _, probe = render(scene, cam, tile_size=tile, capacity=1024,
                          return_overflow=True, feature_bytes=feature_bytes)
    return 1024 + int(probe)


def noisy_start(scene):
    """TrainableGaussians of ``scene`` with seeded noise on the raw colors
    and logit opacities."""
    import torch
    from splatjax_torch.scene import TrainableGaussians

    params = TrainableGaussians.from_scene(scene)
    g = torch.Generator(device=scene.device).manual_seed(7)
    with torch.no_grad():
        for leaf in (params.colors, params.logit_opacities):
            leaf.add_(NOISE * torch.randn(leaf.shape, generator=g,
                                          device=leaf.device))
    return params


def serving_path(scene, cam, capacity):
    """Path a: 10 frames through SplatRenderer. Returns the launches."""
    import torch
    from splatjax_torch import SplatRenderer, kernels

    renderer = SplatRenderer(scene=scene, capacity=capacity)
    img, overflow = renderer.render(cam, return_overflow=True)
    if int(overflow) != 0:
        raise AssertionError(f"overflow {int(overflow)} at capacity "
                             f"{capacity}")
    kernels.reset_launches()
    for _ in range(FRAMES):
        img = renderer.render(cam)
    sync()
    launches = dict(kernels.LAUNCHES)
    if tuple(img.shape) != (HEIGHT, WIDTH, 4) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError("full-width frame is not finite (H, W, 4)")
    alpha = img[..., 3]
    if not (float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0
            and float(alpha.mean()) > 0.05):
        raise AssertionError("full-width frame alpha out of range or empty")
    log(f"[serving] {FRAMES} frames 1M splats {WIDTH}x{HEIGHT}: mean alpha "
        f"{float(alpha.mean()):.4f}")
    return launches


def training_path(start, cam, target, capacity):
    """Path b: fit() for TRAIN_STEPS steps, FitConfig defaults. Returns the
    launches and the trained parameters."""
    import torch
    from splatjax_torch import kernels
    from splatjax_torch.render import render
    from splatjax_torch.train import FitConfig, fit

    cfg = FitConfig(steps=TRAIN_STEPS, log_every=1, capacity=capacity)
    sync()
    kernels.reset_launches()
    params, hist = fit(start, [cam], [target], cfg)
    sync()
    launches = dict(kernels.LAUNCHES)
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    for leaf in LEAVES:
        if not bool(getattr(params, leaf).isfinite().all()):
            raise AssertionError(f"parameter {leaf} is not finite")
    with torch.no_grad():
        _, overflow = render(params.to_scene(), cam, capacity=capacity,
                             feature_bytes=cfg.feature_bytes,
                             return_overflow=True)
    if int(overflow) != 0:
        raise AssertionError(f"overflow {int(overflow)} after training")
    log(f"[training] fit() {TRAIN_STEPS} steps, 1M splats {WIDTH}x{HEIGHT}, "
        f"16-byte rows: loss {' -> '.join(f'{x:.5f}' for x in losses)}; "
        f"psnr {hist[0]['psnr']:.3f} -> {hist[-1]['psnr']:.3f} dB")
    return launches, params


def gradient_step_path(params, cam, target, capacity, mode):
    """Path c: one 32-byte training step under SPLATJAX_GRAD_GATHER=mode.
    Returns its launches."""
    import dataclasses
    from splatjax_torch import kernels
    from splatjax_torch.train import FitConfig, make_train_step
    from splatjax_torch.train.fit import _optimizer

    cfg = dataclasses.replace(FitConfig(capacity=capacity),
                              feature_bytes=32)
    step = make_train_step([cam], cfg, capacity)
    opt = _optimizer(params, cfg)
    prev = os.environ.get("SPLATJAX_GRAD_GATHER")
    os.environ["SPLATJAX_GRAD_GATHER"] = mode
    try:
        sync()
        kernels.reset_launches()
        loss, _, gnorm = step(params, opt, cam.modelview, cam.projection,
                              target)
        sync()
        launches = dict(kernels.LAUNCHES)
    finally:
        if prev is None:
            del os.environ["SPLATJAX_GRAD_GATHER"]
        else:
            os.environ["SPLATJAX_GRAD_GATHER"] = prev
    if not (math.isfinite(float(loss)) and bool(gnorm.isfinite().all())):
        raise AssertionError(f"32-byte step ({mode}) is not finite")
    log(f"[step32] one 32-byte step, gather {mode}: loss {float(loss):.5f}; "
        f"launches {launches}")
    return launches


def check_frame(img, what):
    import torch

    if tuple(img.shape) != (HEIGHT, WIDTH, 4) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what}: frame is not finite (H, W, 4)")
    alpha = img[..., 3]
    if not (float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0
            and float(alpha.mean()) > 0.05):
        raise AssertionError(f"{what}: frame alpha out of range or empty")
    return float(alpha.mean())


def redraw_capacity(scene, tile=16):
    """Instances the base eye and the orbit need, + 3% (bench.py's
    capacity probe)."""
    from splatjax_torch import make_camera
    from splatjax_torch.render import bin_scene

    need = 0
    for eye in [EYE] + ORBIT:
        c = make_camera(eye, (0, 0, 0), width=WIDTH, height=HEIGHT)
        need = max(need, int(bin_scene(scene, c, tile_size=tile,
                                       capacity=1024).num_instances))
    return need, -(-int(need * 1.03) // 1024) * 1024


def redraw_path(scene, capacity):
    """Path d: the stale-order redraw over the orbit, 16-byte rows. Returns
    the launches."""
    from splatjax_torch import SplatRenderer, kernels, make_camera

    eyes = [make_camera(e, (0, 0, 0), width=WIDTH, height=HEIGHT)
            for e in ORBIT * REDRAW_LAPS]
    renderer = SplatRenderer(scene=scene, capacity=capacity,
                             feature_bytes=16,
                             resort_interval=RESORT_INTERVAL,
                             alpha_clip=0.999, early_stop=1e-4)
    sync()
    kernels.reset_launches()
    for i, c in enumerate(eyes):
        img = renderer.render(c)
        if i % RESORT_INTERVAL == 0 and \
                int(renderer._bins.bins.overflow) != 0:
            raise AssertionError(f"redraw overflow at capacity {capacity}")
    sync()
    launches = dict(kernels.LAUNCHES)
    mean_alpha = check_frame(img, "redraw")
    log(f"[redraw16] {len(eyes)} orbit frames, 1M splats {WIDTH}x{HEIGHT}, "
        f"16-byte rows, resort_interval {RESORT_INTERVAL}: mean alpha "
        f"{mean_alpha:.4f}")
    return launches


def redraw32_path(scene, cam, capacity):
    """Path e: the stale-order redraw with 32-byte rows at the unchanged
    camera; the frame against render(). Returns the launches."""
    from splatjax_torch import SplatRenderer, kernels
    from splatjax_torch.render import render

    kw = dict(alpha_clip=0.999, early_stop=1e-4)
    renderer = SplatRenderer(scene=scene, capacity=capacity,
                             feature_bytes="auto",
                             resort_interval=RESORT_INTERVAL, **kw)
    sync()
    kernels.reset_launches()
    for _ in range(RESORT_INTERVAL):
        img = renderer.render(cam)
    sync()
    launches = dict(kernels.LAUNCHES)
    check_frame(img, "32-byte redraw")
    err = float((img - render(scene, cam, capacity=capacity, **kw)
                 ).abs().max())
    if not err <= K2_TOL:
        raise AssertionError(f"32-byte redraw differs from render() by {err}")
    log(f"[redraw32] {RESORT_INTERVAL} frames, 32-byte rows, unchanged "
        f"camera: max |err| vs render() {err:.3g}; launches {launches}")
    return launches


def _scene_equal(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("means", "scales", "quats", "colors", "opacities"))


def check_native_ply(nat, ref):
    """The native .ply converter against the NumPy parser (the semantics of
    record): means, quaternions and colors bit-equal and scales and
    opacities within 4 f32 ulps on every row the two importance orders
    share; a row they order apart must be a near-tie (importances within
    a relative 1e-6). Returns (rows ordered apart, max ulps)."""
    import numpy as np

    def host(scene):
        return {f: getattr(scene, f).cpu().numpy() for f in
                ("means", "scales", "quats", "colors", "opacities")}

    a, b = host(nat), host(ref)
    same = (a["means"] == b["means"]).all(axis=-1)
    imp_a = a["scales"].prod(axis=-1) * a["opacities"]
    imp_b = b["scales"].prod(axis=-1) * b["opacities"]
    moved = ~same
    if moved.any() and not np.allclose(imp_a[moved], imp_b[moved],
                                       rtol=1e-6, atol=0.0):
        raise AssertionError("native .ply order differs beyond near-ties")
    for f in ("quats", "colors"):
        if not np.array_equal(a[f][same], b[f][same]):
            raise AssertionError(f"native .ply {f} differ from NumPy's")
    ulps = 0
    for f in ("scales", "opacities"):
        d = np.abs(a[f][same].view(np.int32).astype(np.int64)
                   - b[f][same].view(np.int32).astype(np.int64))
        ulps = max(ulps, int(d.max()) if d.size else 0)
    if ulps > 4:
        raise AssertionError(f"native .ply scales/opacities {ulps} ulps "
                             "from NumPy's")
    return int(moved.sum()), ulps


def asset_path(scene, cam, smi, workdir):
    """Path f: the 1M-splat scene written as .ply (``save_ply``) and
    .splat, the .ply loaded by the native converter and by NumPy, served
    through ``SplatRenderer(src="file://...scene.ply", progress=cb)`` and
    the .splat streamed through ``SplatRenderer.from_stream``. Returns the
    launches."""
    import torch
    from splatjax_torch import SplatRenderer, kernels
    from splatjax_torch.io import load_ply, load_splat, save_ply, save_splat
    from splatjax_torch.io.stream import stream_chunks
    from splatjax_torch.render import render

    ply = os.path.join(workdir, "scene.ply")
    splat = os.path.join(workdir, "scene.splat")
    t0 = time.perf_counter()
    save_ply(ply, scene)
    save_splat(splat, scene)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(ply)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    from splatjax_torch.io import native

    _, build_s = timed(native.ensure_built)   # g++, once per checkout
    ref, numpy_s = timed(lambda: load_ply(ply, backend="numpy"))
    nat, native_s = timed(lambda: load_ply(ply, backend="native"))
    moved, ulps = check_native_ply(nat, ref)
    events = []
    capacity = -(-int(demand(ref, cam) * 1.03) // 1024) * 1024
    want = render(ref, cam, capacity=capacity)
    # the counted window: the renderer built from the .ply and its frames
    sync()
    kernels.reset_launches()
    renderer, src_s = timed(lambda: SplatRenderer(
        src="file://" + ply, progress=events.append, capacity=capacity))
    for _ in range(ASSET_FRAMES):
        img = renderer.render(cam)
    sync()
    launches = dict(kernels.LAUNCHES)
    done = [e for e in events if e.done]
    if len(done) != 1 or done[0].bytes_read != size:
        raise AssertionError(f"progress: done events {done}, file {size} B")
    if not _scene_equal(renderer.scene, ref):
        raise AssertionError("SplatRenderer(src=.ply) scene differs from "
                             "load_ply's")
    if renderer.capacity != capacity or not torch.equal(img, want):
        raise AssertionError("SplatRenderer(src=.ply) frame differs from "
                             "render() of the NumPy-loaded scene")
    mean_alpha = check_frame(img, "asset path")
    streamed, stream_s = timed(lambda: SplatRenderer.from_stream(
        stream_chunks(splat)))
    streamed._materialize()
    if not _scene_equal(streamed.scene, load_splat(splat,
                                                   backend="numpy")):
        raise AssertionError("from_stream scene differs from load_splat's")
    log(f"[asset] {scene.num_gaussians} splats: .ply {size} B, .splat "
        f"{os.path.getsize(splat)} B, written in {write_s:.3f} s; host "
        f"load of the .ply: native {native_s:.4f} s (its g++ build before "
        f"it {build_s:.3f} s), NumPy {numpy_s:.4f} s; "
        f"SplatRenderer(src=file://.ply) {src_s:.4f} s; streamed .splat "
        f"(from_stream) {stream_s:.4f} s; {smi}")
    log(f"[asset] native vs NumPy: {moved} rows ordered apart (near-ties), "
        f"scales/opacities within {ulps} ulps, the rest bit-equal; "
        f"{ASSET_FRAMES} frames bit-equal to render(), mean alpha "
        f"{mean_alpha:.4f}; progress events {len(events)}, done at "
        f"{done[0].bytes_read} B; launches of the renderer's build and "
        f"frames {launches}")
    return launches


def densify_path(start, cam, target, workdir):
    """Path g: ``fit()`` with densify and checkpoints from the noisy 1M
    start, twice uninterrupted and once resumed from step 3's checkpoint;
    ``export_ply`` of the result; K1, K4 and K7 against their plain
    versions on the grown bucket. Returns the launches and the kernels'
    errors there."""
    import shutil

    import torch
    from splatjax_torch import kernels
    from splatjax_torch.io import save_ply
    from splatjax_torch.render import default_capacity
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train import (
        CheckpointManager, DensifyConfig, FitConfig, export_ply, fit,
        make_train_step,
    )
    from splatjax_torch.train.fit import _optimizer

    def fresh():
        return TrainableGaussians(**{
            k: None if getattr(start, k) is None
            else getattr(start, k).detach().clone()
            for k in TrainableGaussians.LEAVES})

    cfg = FitConfig(steps=DENSE_STEPS, log_every=1)
    # the gradient threshold: the 90th percentile of one step's mean
    # gradients, so about a tenth of the gaussians clone or split
    probe = fresh()
    step = make_train_step([cam], cfg, default_capacity(probe.num_gaussians))
    popt = _optimizer(probe, cfg)
    _, _, gnorm = step(probe, popt, cam.modelview, cam.projection, target)
    threshold = float(torch.quantile(gnorm[gnorm > 0].float(), 0.9))
    dense = DensifyConfig(start=0, stop=DENSE_STEPS, every=3,
                          grad_threshold=threshold)
    n0 = probe.num_gaussians
    del probe, popt, step

    sync()
    kernels.reset_launches()
    runs, reports, hists = {}, {}, {}
    for name in ("A", "B"):
        events = []
        runs[name], hists[name] = fit(
            fresh(), [cam], [target], cfg,
            checkpoint_dir=os.path.join(workdir, name), checkpoint_every=3,
            densify=dense, densify_seed=1, log_fn=events.append)
        reports[name] = [e for e in events if "densify" in e]
    ck = os.path.join(workdir, "resume")
    os.makedirs(ck)
    shutil.copy(os.path.join(workdir, "A", "step_3.pt"), ck)
    if CheckpointManager(ck).latest_step() != 3:
        raise AssertionError("step 3's checkpoint is missing")
    resumed, rhist = fit(fresh(), [cam], [target], cfg, checkpoint_dir=ck,
                         checkpoint_every=3, resume=True, densify=dense,
                         densify_seed=1)
    sync()
    launches = dict(kernels.LAUNCHES)

    first = reports["A"][0]["densify"]
    if first["cloned"] + first["split"] <= 0 or first["capacity"] <= n0:
        raise AssertionError(f"the first densify pass grew nothing: {first}")
    a, b = runs["A"], runs["B"]
    losses = [h["loss"] for h in hists["A"]]
    if not all(math.isfinite(x) for x in losses) or \
            [h["step"] for h in rhist] != list(range(3, DENSE_STEPS)):
        raise AssertionError(f"densify run: losses {losses}, resumed steps "
                             f"{[h['step'] for h in rhist]}")
    leaves = [k for k in TrainableGaussians.LEAVES
              if getattr(a, k) is not None]

    def spread(x, y):
        if x.num_gaussians != y.num_gaussians:
            return math.inf
        return max(float((getattr(x, k) - getattr(y, k)).detach().abs()
                         .max()) for k in leaves)

    ab, ra = spread(a, b), spread(resumed, a)
    identical = ab == 0.0
    if ra == math.inf:
        raise AssertionError(f"resumed run has {resumed.num_gaussians} "
                             f"rows, run A {a.num_gaussians}")
    if identical and ra != 0.0:
        raise AssertionError(f"two runs are bit-identical but the resumed "
                             f"one differs by {ra}")
    if not identical and not ra <= ab:
        raise AssertionError(f"resumed run differs from run A by {ra}, "
                             f"more than run B does ({ab})")
    grown = check_grown(a, cam)
    with torch.no_grad():
        final = a.to_scene()
    export_ply(os.path.join(workdir, "export.ply"), a)
    save_ply(os.path.join(workdir, "save.ply"), final)
    with open(os.path.join(workdir, "export.ply"), "rb") as f, \
            open(os.path.join(workdir, "save.ply"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("export_ply bytes differ from save_ply's")

    log(f"[densify] threshold {threshold:.4g} (90th percentile of a step's "
        f"mean gradients at {n0} splats)")
    log(f"[densify] run A passes: "
        f"{[(e['step'], e['densify']) for e in reports['A']]}; loss "
        f"{' -> '.join(f'{x:.5f}' for x in losses)}")
    log(f"[densify] runs A and B {'bit-identical' if identical else 'differ'}"
        f" (max |A - B| {ab:.3g}); resumed from step 3 vs A: max "
        f"{ra:.3g}; reports A == B: {reports['A'] == reports['B']}; "
        f"export_ply == save_ply bytes; launches {launches}")
    return launches, grown


def check_grown(params, cam):
    """K1, K4 and K7's slot entry against their plain versions on the
    grown bucket's binning, as ``fit()`` draws it after densify: dead and
    padding rows among the live ones, ``default_capacity`` of the grown
    row count (a long tail of empty slots). K1 integer-equal, K4 on 64
    sampled tiles at K4_TOL_FULL, K7 within the run tolerance."""
    import torch
    from splatjax_torch.ops import segreduce as sr
    from splatjax_torch.ops.binning import (
        TileConfig, _effective_cum, _gid_order, depth_order,
        tile_slot_positions,
    )
    from splatjax_torch.ops.expand import (
        expand_instances, expand_instances_plain,
    )
    from splatjax_torch.ops.rasterize_vjp import (
        rasterize_bwd, rasterize_bwd_plain,
    )
    from splatjax_torch.render import default_capacity

    n = params.num_gaussians
    capacity = default_capacity(n)
    with torch.no_grad():
        scene = params.to_scene()
    cfg = TileConfig(cam.width, cam.height)
    d = depth_order(projected(scene, cam, 1e-4), cfg)
    args = (d.x0_d, d.y0_d, d.spanw_d, d.cum_d, d.perm, capacity,
            cfg.tiles_x, cfg.num_tiles)
    got, want = expand_instances(*args), expand_instances_plain(*args)
    sync()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("K1 differs from its plain version on the grown "
                             "bucket")
    culled = int((d.count_d == 0).sum())
    total = int(d.total)
    del d, args, got, want

    cfg, b, args = k4_case(scene, cam, capacity, True, 0.999, False, 4)
    g16 = rasterize_bwd(*args, packed16=True)
    tiles = sample_tiles(b, cfg, g16.device)
    g_p = rasterize_bwd_plain(*args, tiles=tiles, packed16=True)
    idx = torch.cat([torch.arange(int(b.starts[t]), int(b.ends[t]),
                                  device=g16.device) for t in tiles])
    k4_err = compare_k4(g16[idx], g_p[idx], True,
                        f"grown bucket, {n} rows, the {idx.numel()} "
                        f"instances of {tiles.numel()} sampled tiles",
                        tol=K4_TOL_FULL)
    del g_p, args

    k = g16.shape[0]
    eff = _effective_cum(b.cum, b.count, b.perm, b.cum_d, b.count_d,
                         b.overflow, k)
    order = _gid_order(b.gauss_id)
    run_len = torch.diff(eff.long(), prepend=eff.new_zeros(1).long())
    got = sr._segment_reduce_slots_packed_bf16(
        g16, tile_slot_positions(b.by_tile), b.cum_d, b.perm)
    want = sr.segment_reduce_packed_bf16_plain(g16.index_select(0, order),
                                               eff)
    abs_sum = sr.segment_reduce_rows_plain(
        sr.unpack_bf16_pairs(g16).abs().index_select(0, order), eff)
    k7_err = _check_runs(got, want, abs_sum, run_len,
                         "segreduce_bf16 (slots, grown bucket)")
    log(f"[densify] grown bucket: {n} rows ({culled} culled: dead, padding "
        f"or off screen), capacity {capacity}, {total} instances; K1 "
        f"integer-equal to plain, K4 max |err| {k4_err:.3g}, K7 slot entry "
        f"max |err| {k7_err:.3g} against the gid-sort plain path")
    return dict(expand=0.0, rasterize_bwd=k4_err, segreduce_bf16=k7_err)


def collective_share(fn, calls: int = 5) -> tuple[float, float, float]:
    """Device busy ms per call of ``fn`` from torch.profiler, and the ms of
    it in NCCL kernels and in device-to-device copies (NCCL copies instead
    of launching a kernel when a group has one rank). multicard_smoke.py's;
    this script times no path."""
    kern = traced_kernels(fn, calls)

    def ms(keep):
        return sum(e.self_device_time_total for e in kern
                   if keep(e.key)) / 1e3 / calls

    return (ms(lambda k: True), ms(lambda k: "nccl" in k.lower()),
            ms(lambda k: "Memcpy DtoD" in k))


def check_launches(launches, want, path):
    """Exact launch counts of the kernels ``want`` names."""
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{path} launches {launches}, want {want}")


def grad_gate(got, want, what):
    """The gradient gate (atol GRAD_TOL x max, rtol GRAD_TOL) over every
    leaf's gradient, leaves given as {name: tensor}; returns the max error
    and whether the two are bit-equal."""
    import torch

    g = torch.cat([got[k].ravel() for k in LEAVES])
    w = torch.cat([want[k].ravel() for k in LEAVES])
    scale = float(w.abs().max())
    err = (g - w).abs()
    if not (bool(g.isfinite().all()) and scale > 0 and bool(
            (err <= GRAD_TOL * scale + GRAD_TOL * w.abs()).all())):
        raise AssertionError(f"{what}: gradient gate failed, max err "
                             f"{float(err.max())} at scale {scale}")
    return float(err.max()), bool(torch.equal(g, w))


def dist_frames(scene, cam, capacity, smi):
    """Path h, frames: ``render_sharded`` of the serving scene under
    ``make_mesh(1)`` and ``make_mesh_2d((1, 1))``, both redistributions
    and both band layouts, against ``render()``; the defaults' frame once;
    the collectives' times. Returns the launches of the checked frames."""
    import torch
    from splatjax_torch import kernels
    from splatjax_torch.parallel import (
        make_mesh, make_mesh_2d, render_sharded,
    )
    from splatjax_torch.parallel.dist_render import (
        _default_pair_capacity, all_gather, all_to_all,
    )
    from splatjax_torch.parallel.mesh import mesh_group
    from splatjax_torch.render import default_capacity, render

    n = scene.num_gaussians
    mesh = make_mesh(1)
    meshes = (("make_mesh(1)", mesh, "dev"),
              ("make_mesh_2d((1, 1))", make_mesh_2d((1, 1)),
               ("host", "chip")))
    with torch.no_grad():
        ref = render(scene, cam, capacity=capacity)
        pc_d = _default_pair_capacity(n, 1)
        img, ov = render_sharded(scene, cam, mesh, return_overflow=True)
        log(f"[dist] defaults (pair_capacity {pc_d}, capacity "
            f"{max(default_capacity(pc_d), 2048)}): overflow {ov.tolist()}, "
            f"max |image - render()| {float((img - ref).abs().max()):.3g}; "
            f"{smi}")
        del img

        kw = dict(pair_capacity=n, capacity=capacity, return_overflow=True)
        sync()
        kernels.reset_launches()
        checked = []
        for label, m, axis in meshes:
            for red in ("all_to_all", "all_gather"):
                for bal in ("load", "equal"):
                    img, ov = render_sharded(scene, cam, m, axis=axis,
                                             redistribute=red, balance=bal,
                                             **kw)
                    checked.append((f"{label} {red} {bal}", img, ov))
        sync()
        launches = dict(kernels.LAUNCHES)
        for what, img, ov in checked:
            err = float((img - ref).abs().max())
            check_frame(img, f"render_sharded {what}")
            if int(ov.sum()) != 0 or not err <= 1e-4:
                raise AssertionError(f"render_sharded {what}: overflow "
                                     f"{ov.tolist()}, max err {err}")
            log(f"[dist] render_sharded {what}: max |image - render()| "
                f"{err:.3g}, bit-equal {torch.equal(img, ref)}, overflow "
                f"{ov.tolist()}; {smi}")
        del checked
        n_frames = 2 * 2 * 2
        check_launches(launches, dict(
            expand=n_frames, pack_rows=n_frames, rasterize_fwd=n_frames,
            rasterize_fwd16=0, rasterize_bwd=0), "render_sharded")
        group = mesh_group(mesh)
        send = torch.zeros((n, 13), device=scene.device)
        tiles = torch.zeros((-(-cam.width // 16) * -(-cam.height // 16), 8,
                             256), device=scene.device)
        a2a = cuda_ms(lambda: all_to_all(send, group), 20)
        ag = cuda_ms(lambda: all_gather(tiles, group), 20)
        log(f"[dist] collectives by CUDA events, one rank: all_to_all of "
            f"the ({n}, 13) f32 send buffer {a2a:.4f} ms "
            f"({n * 52 / a2a / 1e6:.1f} GB/s), all_gather of the "
            f"{tuple(tiles.shape)} f32 band tiles {ag:.4f} ms "
            f"({tiles.numel() * 4 / ag / 1e6:.1f} GB/s); {smi}")
    return launches


def dist_steps(scene, cam, start, target, capacity, smi):
    """Path h, steps: ``fit(mesh=make_mesh(1))`` for one step against
    ``make_train_step``'s from the same start and view; the (view, band)
    step twice from one start, against it and against itself;
    ``fit(mesh=make_mesh_2d((1, 1), ("view", "band")), ...)`` for
    TRAIN_STEPS steps. Returns the launches of the port's multi-card calls
    (the one-card reference step runs before the counted window)."""
    from splatjax_torch import kernels
    from splatjax_torch.parallel import (
        make_dp_band_train_step, make_mesh, make_mesh_2d,
    )
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train import FitConfig, fit, make_train_step
    from splatjax_torch.train.fit import _optimizer

    def fresh():
        return TrainableGaussians(**{
            k: None if getattr(start, k) is None
            else getattr(start, k).detach().clone()
            for k in TrainableGaussians.LEAVES})

    def grads(p):
        return {k: getattr(p, k).grad.detach().clone() for k in LEAVES}

    def leaves(p):
        return {k: getattr(p, k).detach().clone() for k in LEAVES}

    def spread(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in LEAVES)

    cfg = FitConfig(capacity=capacity)
    one = fresh()
    make_train_step([cam], cfg, capacity)(one, _optimizer(one, cfg),
                                          cam.modelview, cam.projection,
                                          target)
    ref_g, ref_p = grads(one), leaves(one)
    del one
    mv, pr, tg = cam.modelview[None], cam.projection[None], target[None]
    band_mesh = make_mesh_2d((1, 1), ("view", "band"))
    band_step = make_dp_band_train_step([cam], cfg, band_mesh,
                                        view_axis="view", band_axis="band",
                                        capacity=capacity)

    sync()
    kernels.reset_launches()
    dp, _ = fit(fresh(), [cam], [target],
                FitConfig(steps=1, log_every=1, capacity=capacity),
                mesh=make_mesh(1))
    band = []
    for _ in range(2):
        p = fresh()
        loss, _, _, drops = band_step(p, _optimizer(p, cfg), mv, pr, tg)
        band.append((grads(p), leaves(p), int(drops)))
    _, hist = fit(fresh(), [cam], [target],
                  FitConfig(steps=TRAIN_STEPS, log_every=1,
                            capacity=capacity),
                  mesh=band_mesh, dp_axis="view", band_axis="band")
    sync()
    launches = dict(kernels.LAUNCHES)

    dp_err, dp_exact = grad_gate(grads(dp), ref_g, "fit(mesh=make_mesh(1))")
    log(f"[dist] fit(mesh=make_mesh(1)), one step against make_train_step's: "
        f"gradients max err {dp_err:.3g} (bit-equal {dp_exact}), parameters "
        f"max |diff| {spread(leaves(dp), ref_p):.3g}; {smi}")
    band_err, band_exact = grad_gate(band[0][0], ref_g, "band step")
    twice = spread(band[0][0], band[1][0]) == 0.0 and \
        spread(band[0][1], band[1][1]) == 0.0
    if band[0][2] or band[1][2]:
        raise AssertionError(f"band step dropped {band[0][2]} instances")
    log(f"[dist] make_dp_band_train_step (1, 1), one step against "
        f"make_train_step's: gradients max err {band_err:.3g} (bit-equal "
        f"{band_exact}), parameters max |diff| "
        f"{spread(band[0][1], ref_p):.3g}; two runs from one start "
        f"bit-identical {twice} (gradients max |diff| "
        f"{spread(band[0][0], band[1][0]):.3g}); {smi}")
    losses = [h["loss"] for h in hist]
    drops = [h["drops"] for h in hist]
    if not (len(losses) == TRAIN_STEPS and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"band fit losses {losses}")
    if any(drops):
        raise AssertionError(f"band fit dropped instances: {drops}")
    log(f"[dist] fit on the (view, band) mesh (1, 1), {TRAIN_STEPS} steps: "
        f"loss {' -> '.join(f'{x:.5f}' for x in losses)}; drops {drops}; "
        f"{smi}")
    return launches


def dist_path(scene, cam, start, target, capacity, smi, workdir):
    """Path h: the multi-card slice on a one-rank NCCL group started by
    ``init_distributed`` (a FileStore under ``workdir``). Returns the
    frames' and the steps' launches."""
    import torch
    import torch.distributed as dist
    from splatjax_torch.parallel import init_distributed

    t0 = time.perf_counter()
    if not init_distributed("file://" + os.path.join(workdir, "store"), 1,
                            0, device="cuda"):
        raise AssertionError("init_distributed started no group")
    try:
        log(f"[dist] one-rank {dist.get_backend()} group in "
            f"{time.perf_counter() - t0:.2f} s (torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}); {smi}")
        frames = dist_frames(scene, cam, capacity, smi)
        steps = dist_steps(scene, cam, start, target, capacity, smi)
    finally:
        dist.destroy_process_group()
    return frames, steps


# -- path i: tooling and examples ---------------------------------------------

ORACLE_W, ORACLE_H = 48, 32
ORACLE_CASES = (   # tests/test_reference_rasterizer.py's scenes
    ("plain", 40, 12, (0.03, 0.12), None),
    ("cutout", 60, 13, (0.03, 0.1), (0.1, 0.0, 0.0)),
)
FIXTURE_CAM = ((1.4, 0.9, 1.4), 128, 96)   # tests/test_fixture.py's view
FIT_BAR_DB = 25.0     # fit_trained_fixture's held-out bar (min of 2 views)
SPLATJAX_FIT = "32.4 / 50.19 dB held-out min / train mean, 9235 live"


def png_pixels(path):
    """Decode an 8-bit PNG written with filter byte 0 (what
    ``splatjax_torch.utils.png`` writes) to (H, W, C) uint8, with zlib."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    i, chunks = 8, {}
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        chunks[data[i + 4:i + 8]] = data[i + 8:i + 8 + n]
        i += 12 + n
    w, h, depth, ct = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[ct]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    if depth != 8 or (rows[:, 0] != 0).any():
        raise AssertionError(f"{path}: not 8-bit rows with filter 0")
    return rows[:, 1:].reshape(h, w, c)


def check_png(path, frame, what):
    """The PNG at ``path`` decodes to ``to_u8(frame)``."""
    import numpy as np
    from splatjax_torch.utils.png import to_u8

    if not np.array_equal(png_pixels(path), to_u8(frame)):
        raise AssertionError(f"{what}: {path} does not decode to its frame")


def loss_falls(history, what):
    losses = [h["loss"] for h in history if "loss" in h]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    return losses[0], losses[-1]


def viewer_oracle_gate():
    """Path i.1: K1 and K2 against the scalar WebGL-viewer pipeline of
    ``splatjax_torch.reference.viewer_math`` (the worker's cull and
    counting sort, the vertex and fragment shaders, GL's back-to-front
    blending) on test_reference_rasterizer.py's scenes, written as .splat
    bytes and parsed back, at 48x32 from (0, 0, 2.5): ``render(...,
    viewer_exact=True, early_stop=0.0)`` within PARITY_TOL on RGBA, plain
    and with a cutout box the worker must cull alike. Returns the
    launches."""
    import numpy as np
    import torch
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.io import (
        parse_splat_bytes,
        scene_to_splat_bytes,
        synthetic_scene,
    )
    from splatjax_torch.reference import viewer_math as vm
    from splatjax_torch.render import render

    total = dict.fromkeys(kernels.LAUNCHES, 0)
    images = {}
    for name, n, seed, scale_range, shift in ORACLE_CASES:
        src = synthetic_scene(n, seed=seed, extent=0.6,
                              scale_range=scale_range, device="cpu")
        raw = np.frombuffer(scene_to_splat_bytes(src), np.uint8).reshape(
            n, 32)
        scene = parse_splat_bytes(raw.tobytes(), device="cuda")
        cam = make_camera((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), width=ORACLE_W,
                          height=ORACLE_H)
        mv = cam.modelview.cpu().numpy()
        pr = cam.projection.cpu().numpy()
        box = None
        if shift is not None:
            box_world = np.eye(4, dtype=np.float32)
            box_world[:3, 3] = shift
            box = np.linalg.inv(box_world).astype(np.float32)
        t0 = time.perf_counter()
        want = vm.viewer_render(raw, mv, pr, ORACLE_W, ORACLE_H, cutout=box)
        oracle_s = time.perf_counter() - t0
        sync()
        kernels.reset_launches()
        img = render(scene, cam, viewer_exact=True, early_stop=0.0,
                     cutout=None if box is None else torch.from_numpy(
                         box).to(scene.device))
        sync()
        launches = dict(kernels.LAUNCHES)
        require(launches, ("expand", "rasterize_fwd"), f"oracle {name}")
        err = float(np.abs(img.cpu().numpy() - want).max())
        if not err < PARITY_TOL:
            raise AssertionError(f"oracle {name}: max |err| {err} against "
                                 f"the viewer pipeline")
        extra = ""
        if box is None:
            if not want[..., 3].max() > 0.2:
                raise AssertionError("oracle scene covers no pixel")
        else:
            buf = vm.push_data_buffer_math(raw)
            kept = len(vm.worker_sort_cull(buf["centers"],
                                           buf["sort_metric"], mv, box))
            if not kept < n:
                raise AssertionError(f"the cutout culled nothing ({kept})")
            moved = float(np.abs(want - images["plain"]).max())
            if not moved > PARITY_TOL:
                raise AssertionError("the cutout image equals the full one")
            extra = (f"; the worker keeps {kept} of {n}, the cutout moves "
                     f"the oracle by {moved:.3g}")
        images[name] = want
        for k, v in launches.items():
            total[k] += v
        log(f"[oracle] {name}: {n} splats {ORACLE_W}x{ORACLE_H}, CUDA render "
            f"vs the scalar viewer pipeline max |err| {err:.3g} "
            f"(< {PARITY_TOL}), oracle alpha max "
            f"{float(want[..., 3].max()):.3f}{extra}; oracle {oracle_s:.2f} s "
            f"on the host; launches K1 {launches['expand']}, K2 "
            f"{launches['rasterize_fwd']}")
    return total


def fixture_path(workdir):
    """Path i.2: ``tools.make_fixture`` at its defaults (1200 steps, 96x96,
    10 views, 512 random gaussians, densify up to 6000) into ``workdir``,
    then tests/test_fixture.py's checks on the card. Returns the
    launches."""
    import torch
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.io import load_ply, load_splat, save_splat
    from splatjax_torch.render import render
    from splatjax_torch.tools import make_fixture

    out = os.path.join(workdir, "fixture")
    sync()
    kernels.reset_launches()
    res = make_fixture.main(["--out", out])
    sync()
    launches = dict(kernels.LAUNCHES)
    require(launches, ("expand", "rasterize_fwd16", "rasterize_bwd",
                       "segreduce_bf16"), "make_fixture")
    first, last = loss_falls(res["history"], "make_fixture")

    eye, w, h = FIXTURE_CAM
    cam = make_camera(eye, (0, 0, 0), width=w, height=h)
    spl = load_splat(res["splat"])
    ply = load_ply(res["ply"])
    if not (spl.num_gaussians > 500 and ply.num_gaussians
            == spl.num_gaussians == res["rows"]):
        raise AssertionError(f"fixture rows: .splat {spl.num_gaussians}, "
                             f".ply {ply.num_gaussians}, {res['rows']}")
    with torch.no_grad():
        img = render(spl, cam, early_stop=0.0)
        img_ply = render(ply, cam, early_stop=0.0)
        alpha = img[..., 3]
        if not (bool(img.isfinite().all()) and float(alpha.mean()) > 0.08
                and float(alpha.max()) > 0.9):
            raise AssertionError(f"fixture render: mean alpha "
                                 f"{float(alpha.mean())}, max "
                                 f"{float(alpha.max())}")
        gap = (img_ply - img).abs()
        if not (float(gap.max()) < 0.05 and float(gap.mean()) < 0.005):
            raise AssertionError(f".ply vs .splat: max {float(gap.max())}, "
                                 f"mean {float(gap.mean())}")
        p1 = os.path.join(out, "rt1.splat")
        p2 = os.path.join(out, "rt2.splat")
        save_splat(p1, spl)
        save_splat(p2, load_splat(p1))
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("the .splat is no fixed point after "
                                     "its second load/save pass")
        rt = (render(load_splat(p1), cam, early_stop=0.0) - img).abs()
        if not (float(rt.max()) <= 2e-2 and float(rt.mean()) < 1e-4):
            raise AssertionError(f"one load/save pass moved the render: max "
                                 f"{float(rt.max())}, mean "
                                 f"{float(rt.mean())}")
    log(f"[fixture] make_fixture defaults: {res['rows']} rows frozen, final "
        f"PSNR {res['psnr']:.3f} dB (view 0), loss {first:.4f} -> "
        f"{last:.4f}")
    log(f"[fixture] test_fixture.py's checks on the card: {res['rows']} > "
        f"500 rows; alpha mean {float(alpha.mean()):.4f} > 0.08, max "
        f"{float(alpha.max()):.4f} > 0.9 at {w}x{h}; .ply vs .splat max "
        f"{float(gap.max()):.4g} < 0.05, mean {float(gap.mean()):.3g} < "
        f"0.005; .splat fixed point after the second pass, first pass "
        f"moved the render by {float(rt.max()):.3g}; launches {launches}")
    return launches


def fit_fixture_path(workdir, smi):
    """Path i.3: ``examples.fit_trained_fixture`` at its defaults (3000
    steps, 256x256, 12 views, 4096 random gaussians, its DensifyConfig);
    the held-out bar (min of 2 views >= FIT_BAR_DB) and a falling loss.
    Returns the launches."""
    from splatjax_torch import kernels
    from splatjax_torch.examples import fit_trained_fixture

    out = os.path.join(workdir, "artifacts")
    sync()
    kernels.reset_launches()
    res = fit_trained_fixture.main(["--out-dir", out])
    sync()
    launches = dict(kernels.LAUNCHES)
    require(launches, ("expand", "rasterize_fwd16", "rasterize_bwd",
                       "segreduce_bf16"), "fit_trained_fixture")
    first, last = loss_falls(res["history"], "fit_trained_fixture")
    held = min(res["held_psnrs"])
    if not held >= FIT_BAR_DB:
        raise AssertionError(f"fit_trained_fixture: held-out PSNR "
                             f"{res['held_psnrs']} under {FIT_BAR_DB} dB")
    for (tp, rp), tgt, img in zip(res["png_paths"], res["held_targets"],
                                  res["held_images"]):
        check_png(tp, tgt[..., :3], "fit_trained_fixture target")
        check_png(rp, img[..., :3], "fit_trained_fixture recon")
    log(f"[fit-fixture] {res['steps']} steps {res['resolution']}, "
        f"{res['views']} views, {res['init_gaussians']} random gaussians: "
        f"held-out PSNR {', '.join(f'{p:.3f}' for p in res['held_psnrs'])} "
        f"dB (min {held:.3f} >= {FIT_BAR_DB}), train-view mean "
        f"{sum(res['train_psnrs']) / len(res['train_psnrs']):.3f} dB (min "
        f"{min(res['train_psnrs']):.3f}), {res['final_live_gaussians']} live "
        f"of {res['params'].num_gaussians} rows; loss {first:.4f} -> "
        f"{last:.4f}; splatjax's run: {SPLATJAX_FIT}; record device "
        f"{res['device']!r}")
    log(f"[fit-fixture] launches {launches}; {smi}")
    return launches


def demos_path(splat, workdir, smi):
    """Path i.4: the demos at their defaults, demo_render / orbit / stereo
    / cutout on path f's 1M-splat .splat, demo_depth_interaction and
    demo_train on their own scenes; every PNG decodes to its frame.
    Returns the launches of each demo."""
    import numpy as np
    import torch
    from splatjax_torch import kernels
    from splatjax_torch.examples import (
        demo_cutout,
        demo_depth_interaction,
        demo_orbit,
        demo_render,
        demo_stereo,
        demo_train,
    )
    from splatjax_torch.io import load_splat
    from splatjax_torch.render import render

    def run(mod, argv):
        sync()
        kernels.reset_launches()
        res = mod.main(argv)
        sync()
        return res, dict(kernels.LAUNCHES)

    launches = {}
    res, launches["demo_render"] = run(
        demo_render, [splat, "--out", os.path.join(workdir, "render")])
    require(launches["demo_render"], ("expand", "rasterize_fwd"),
            "demo_render")
    scene = load_splat(splat)
    with torch.no_grad():
        for i, (frame, cam, path) in enumerate(zip(
                res["frames"], res["cameras"], res["paths"])):
            check_png(path, frame, "demo_render")
            if not np.array_equal(frame, render(scene, cam).cpu().numpy()):
                raise AssertionError(f"demo_render frame {i} differs from "
                                     "render() at its camera")
    del scene
    log(f"[demo] demo_render: {len(res['frames'])} frames "
        f"{res['frames'][0].shape[1]}x{res['frames'][0].shape[0]} of "
        f"{res['gaussians']} splats, bit-equal to render()")

    res, launches["demo_orbit"] = run(
        demo_orbit, [splat, "--out", os.path.join(workdir, "orbit.png")])
    check_launches(launches["demo_orbit"], dict(
        rasterize_cached=24, expand=3, rasterize_fwd=0, rasterize_fwd16=0,
        pack_rows=0, pack_rows16=0), "demo_orbit")
    check_png(res["path"], res["strip"], "demo_orbit")
    h, w = res["frames"][0].shape[:2]
    log(f"[demo] demo_orbit: 24 frames {w}x{h}, resort_interval 8: "
        "launches K3 24, K1 3, K2 0")

    res, launches["demo_stereo"] = run(
        demo_stereo, [splat, "--out", os.path.join(workdir, "stereo.png")])
    require(launches["demo_stereo"], ("expand", "rasterize_fwd"),
            "demo_stereo")
    check_png(res["path"], res["pair"], "demo_stereo")
    log(f"[demo] demo_stereo: eye pair {res['left'].shape[1]}x"
        f"{res['left'].shape[0]}")

    res, launches["demo_cutout"] = run(demo_cutout, [splat])
    require(launches["demo_cutout"], ("expand", "rasterize_fwd"),
            "demo_cutout")
    check_png(res["path"], res["side"], "demo_cutout")
    if not float(np.abs(res["full"] - res["clipped"]).max()) > 0:
        raise AssertionError("demo_cutout: clipped frame equals the full one")
    log(f"[demo] demo_cutout: kept {res['kept']:.4f} of the covered pixels")

    res, launches["demo_depth_interaction"] = run(
        demo_depth_interaction, ["--out", os.path.join(workdir, "depth")])
    require(launches["demo_depth_interaction"], ("expand", "rasterize_fwd"),
            "demo_depth_interaction")
    for frame, path in zip(res["frames"], res["paths"]):
        check_png(path, frame, "demo_depth_interaction")
    log(f"[demo] demo_depth_interaction: {len(res['frames'])} frames")

    res, launches["demo_train"] = run(
        demo_train, ["--out", os.path.join(workdir, "fit.splat")])
    require(launches["demo_train"], ("expand", "rasterize_fwd16",
                                     "rasterize_bwd", "segreduce_bf16"),
            "demo_train")
    first, last = loss_falls(res["history"], "demo_train")
    if not res["held_psnr"] > res["held_psnr_start"]:
        raise AssertionError(f"demo_train: held-out PSNR "
                             f"{res['held_psnr']} <= {res['held_psnr_start']}")
    log(f"[demo] demo_train: 600 steps, held-out PSNR "
        f"{res['held_psnr_start']:.3f} -> {res['held_psnr']:.3f} dB, loss "
        f"{first:.4f} -> {last:.4f}")
    log(f"[demo] launches {launches}; {smi}")
    return launches


def tooling_path(workdir, smi):
    """Path i: the viewer-oracle gate, make_fixture, fit_trained_fixture
    and the demos, through the port's entry points. Returns every phase's
    launches."""
    t0 = time.perf_counter()
    phases = [viewer_oracle_gate(), fixture_path(workdir),
              fit_fixture_path(workdir, smi)]
    phases += demos_path(os.path.join(workdir, "scene.splat"), workdir,
                         smi).values()
    log(f"[tooling] path i in {time.perf_counter() - t0:.1f} s")
    return phases


# -- path j: tile edges -------------------------------------------------------

NEW_EDGES = (8, 32, 64)   # the tile edges path j adds to the default 16
RASTERIZERS = ("rasterize_fwd", "rasterize_fwd16", "rasterize_cached",
               "rasterize_bwd")


def edge_capacity(scene, start, cam, tile):
    """The serving and training frames' demand at tile edge ``tile`` (the
    fixture scene at 32-byte rows, the noisy start at 16-byte rows) and
    its capacity, + 3%."""
    need = max(demand(scene, cam, 32, tile), demand(start.to_scene(), cam,
                                                    16, tile))
    return need, -(-int(need * 1.03) // 1024) * 1024


def tile_kernel_checks(gate_scene, gate_cam, scene, cam, start, tile):
    """Path j's kernel checks at one added edge: K2 (32- and 16-byte rows),
    K3 and K4 on every tile of the gate scene and on the full frame
    against their plain versions, the parity and gradient gates. Returns
    the four kernel rows' numbers and the gates' errors."""
    need, capacity = edge_capacity(scene, start, cam, tile)
    log(f"[tiles] {tile} px: demand {need} instances, capacity {capacity}")
    rows = {}
    for packed16, name in ((False, "rasterize_fwd"),
                           (True, "rasterize_fwd16")):
        err = check_k2_small(gate_scene, gate_cam, packed16, tile)
        rows[name] = check_k2_full(scene, cam, capacity, packed16, tile)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    err = check_k3_small(gate_scene, gate_cam, tile)
    _, capacity_e = redraw_capacity(scene, tile)
    rows["rasterize_cached"] = check_k3_full(scene, cam, capacity_e, tile)
    rows["rasterize_cached"]["max_abs_err"] = max(
        rows["rasterize_cached"]["max_abs_err"], err)
    err = check_k4_small(gate_scene, gate_cam, tile)
    k4_32, _, _ = check_k4_full(scene, cam, capacity, False, tile)
    rows["rasterize_bwd"], _, _ = check_k4_full(scene, cam, capacity, True,
                                                tile)
    rows["rasterize_bwd"]["max_abs_err"] = max(
        rows["rasterize_bwd"]["max_abs_err"], k4_32["max_abs_err"], err)
    if tile == 8:
        for name, e in check_shifted_chunks(gate_scene, gate_cam,
                                            tile).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    gates = dict(parity=parity_gate(gate_scene, gate_cam, tile, 1 << 16),
                 grad=gradient_gate(gate_scene, gate_cam, tile, 1 << 16))
    tail_diagnostics(scene, cam, capacity, tile)
    return rows, gates


def rasterizer_registers():
    """cudaFuncGetAttributes of K2 (both row widths), K3 and K4 (both row
    widths) at every tile edge, one ``[tiles]`` line each; the 8 px
    kernels and the cluster instantiations (32 and 64 px) must not spill
    (no local memory)."""
    from splatjax_torch import kernels

    kinds = [(n, False) for n in RASTERIZERS[:3]] + [
        ("rasterize_bwd", False), ("rasterize_bwd", True)]
    for tile in kernels.TILE_EDGES:
        for name, packed16 in kinds:
            a = kernels.rasterizer_attributes(name, tile, packed16)
            what = name + (" 16-byte" if packed16 else
                           " 32-byte" if name == "rasterize_bwd" else "")
            log(f"[tiles] {what} at {tile} px: {a['num_regs']} registers, "
                f"{a['local_bytes']} B of local memory a thread, blocks of "
                f"up to {a['max_threads']} threads, {a['blocks_per_sm']} "
                f"blocks an SM, {a['clusters']} clusters at once")
            if tile != 16 and a["local_bytes"] > 0:
                raise AssertionError(f"{what} at {tile} px spills: {a}")


def sharded_tile_frames(scene, cam, capacity, tile, workdir):
    """``render_sharded(tile_size=tile)`` on a one-rank NCCL group, both
    band layouts, against ``render(tile_size=tile)``: within 1e-4, no
    instance dropped."""
    import torch
    import torch.distributed as dist
    from splatjax_torch.parallel import (
        init_distributed, make_mesh, render_sharded,
    )
    from splatjax_torch.render import render

    if not init_distributed("file://" + os.path.join(workdir, "store_tiles"),
                            1, 0, device="cuda"):
        raise AssertionError("init_distributed started no group")
    try:
        mesh = make_mesh(1)
        with torch.no_grad():
            ref = render(scene, cam, tile_size=tile, capacity=capacity)
            for bal in ("load", "equal"):
                img, ov = render_sharded(
                    scene, cam, mesh, tile_size=tile, balance=bal,
                    pair_capacity=scene.num_gaussians, capacity=capacity,
                    return_overflow=True)
                err = float((img - ref).abs().max())
                check_frame(img, f"render_sharded at {tile} px")
                if int(ov.sum()) != 0 or not err <= 1e-4:
                    raise AssertionError(
                        f"render_sharded {bal} at {tile} px: overflow "
                        f"{ov.tolist()}, max err {err}")
                log(f"[tiles] render_sharded one rank, {bal} bands, {tile} px "
                    f"tiles: max |image - render(tile_size={tile})| "
                    f"{err:.3g}, overflow {ov.tolist()}")
    finally:
        dist.destroy_process_group()


def traced_busy(fn, calls, want):
    """Device busy ms per call of ``fn`` and its top kernels (name, ms and
    launches per call) from torch.profiler, or (None, []) when no trace
    held one ``want`` kernel a call (the profiler dropped records): a busy
    time without them would be wrong. cluster_variants.py's; this script
    times no path."""
    try:
        kern = traced_kernels(fn, calls, want=want, count=calls, tries=5)
    except AssertionError as e:
        log(f"[tiles] device busy not measured: {e}")
        return None, []
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return (sum(e.self_device_time_total for e in kern) / 1e3 / calls,
            [(e.key, e.self_device_time_total / 1e3 / calls,
              e.count // calls) for e in kern[:14]])


def ms_or_not(x):
    return "not measured" if x is None else f"{x:.3f}"


def tile_edge_drive(scene, cam, start, tile):
    """One edge of path j's main path at full size: a serving frame through
    ``SplatRenderer(tile_size=tile)``, 3 gradient steps of
    ``render(feature_bytes=16, tile_size=tile)`` with an L1 loss and Adam
    (the loss must fall), and the 16-byte stale-order redraw over the
    orbit; no overflow. Returns the table row."""
    import torch
    from splatjax_torch import SplatRenderer, make_camera
    from splatjax_torch.ops.binning import TileConfig
    from splatjax_torch.render import render
    from splatjax_torch.train import FitConfig
    from splatjax_torch.train.fit import _optimizer

    need, capacity = edge_capacity(scene, start, cam, tile)
    cfg = TileConfig(WIDTH, HEIGHT, tile, tile)
    renderer = SplatRenderer(scene=scene, capacity=capacity, tile_size=tile)
    img, overflow = renderer.render(cam, return_overflow=True)
    if int(overflow) != 0:
        raise AssertionError(f"overflow {int(overflow)} at {tile} px")
    check_frame(img, f"serving frame at {tile} px")
    del renderer, img

    params = noisy_start(scene)
    opt = _optimizer(params, FitConfig())
    with torch.no_grad():
        target = render(scene, cam, capacity=capacity, tile_size=tile)

    def step():
        opt.zero_grad(set_to_none=True)
        out = render(params.to_scene(), cam, tile_size=tile,
                     capacity=capacity, feature_bytes=16)
        loss = (out - target).abs().mean()
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(step()) for _ in range(3)]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"L1 steps at {tile} px: losses {losses}")
    with torch.no_grad():
        _, overflow = render(params.to_scene(), cam, tile_size=tile,
                             capacity=capacity, feature_bytes=16,
                             return_overflow=True)
    if int(overflow) != 0:
        raise AssertionError(f"step overflow {int(overflow)} at {tile} px")
    del params, opt, target

    _, capacity_e = redraw_capacity(scene, tile)
    eyes = [make_camera(e, (0, 0, 0), width=WIDTH, height=HEIGHT)
            for e in ORBIT * REDRAW_LAPS]
    redraw = SplatRenderer(scene=scene, capacity=capacity_e,
                           feature_bytes=16, tile_size=tile,
                           resort_interval=RESORT_INTERVAL,
                           alpha_clip=0.999, early_stop=1e-4)
    for i, c in enumerate(eyes):
        img = redraw.render(c)
        if i % RESORT_INTERVAL == 0 and \
                int(redraw._bins.bins.overflow) != 0:
            raise AssertionError(f"redraw overflow at {tile} px")
    check_frame(img, f"redraw at {tile} px")
    row = dict(tile=tile, tiles=cfg.num_tiles, instances=need,
               fragments=need * cfg.pixels_per_tile)
    log(f"[tiles] {tile} px drive: serving frame, L1 + Adam steps (16-byte "
        f"rows) loss {' -> '.join(f'{x:.5f}' for x in losses)}, "
        f"{len(eyes)} redraw frames")
    return row


def tile_path(gate_scene, gate_cam, scene, cam, start, base_rows, smi,
              workdir):
    """Path j: K2, K3 and K4 at tile edges 8, 32 and 64 against their
    plain versions, the gates at each, then the main path at 8, 16, 32
    and 64 px with the launch counts reset just before and read just
    after: a one-rank ``render_sharded`` at 32 px, and at each edge the
    serving frames, the gradient steps and the redraw. ``base_rows``: the
    16 px kernels' numbers from the earlier phases. Returns the launches
    and the added edges' kernel rows."""
    from splatjax_torch import kernels

    t0 = time.perf_counter()
    rasterizer_registers()
    rows, gates = {}, {}
    for tile in NEW_EDGES:
        rows[tile], gates[tile] = tile_kernel_checks(
            gate_scene, gate_cam, scene, cam, start, tile)
    sync()
    kernels.reset_launches()
    sharded_tile_frames(scene, cam, edge_capacity(scene, start, cam, 32)[1],
                        32, workdir)
    table = [tile_edge_drive(scene, cam, start, tile)
             for tile in (8, 16, 32, 64)]
    sync()
    launches = dict(kernels.LAUNCHES)
    for tile in NEW_EDGES:
        require(launches, [kernels.tiled_counter(n, tile)
                           for n in RASTERIZERS], f"path j at {tile} px")
    require(launches, RASTERIZERS, "path j at 16 px")
    log(f"[launches] tile edges: {launches}")
    rows[16] = {n: base_rows[n] for n in RASTERIZERS}
    log(f"[tile-table] {smi}; kernels by CUDA events: K2 32-byte and "
        "16-byte, K3 at an orbit eye, K4 16-byte, each with its bound")
    for r in table:
        k = rows[r["tile"]]
        kern = ", ".join(
            f"{n} {k[n]['ms']:.4f} (bound {k[n]['bound_ms']:.4f})"
            for n in RASTERIZERS)
        gate = "" if r["tile"] == 16 else (
            f"; parity {gates[r['tile']]['parity']:.3g}, gradient "
            f"{gates[r['tile']]['grad']:.3g} of max")
        log(f"[tile-table] {r['tile']:2d} px: {r['tiles']} tiles, "
            f"{r['instances']} instances, {r['fragments']} fragments; "
            f"{kern} ms{gate}")
    log(f"[tiles] path j in {time.perf_counter() - t0:.1f} s")
    return launches, {t: rows[t] for t in NEW_EDGES}


def require(launches, names, path):
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"{path} skipped {missing}: {launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from splatjax_torch import kernels, make_camera
    from splatjax_torch.io import load_splat, synthetic_scene, tile_scene
    from splatjax_torch.render import render

    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    paths = kernels.build()
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_suffix(".log")
        for line in report.read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    gate_scene = synthetic_scene(2000, seed=5, extent=0.7,
                                 scale_range=(0.01, 0.05))
    gate_cam = make_camera((0.1, -0.2, 2.4), (0, 0, 0), width=192,
                           height=128)
    t0 = time.perf_counter()
    scene = tile_scene(load_splat(FIXTURE), N_SPLATS)
    cam = make_camera(EYE, (0, 0, 0), width=WIDTH, height=HEIGHT)
    start = noisy_start(scene)
    need = max(demand(scene, cam), demand(start.to_scene(), cam, 16))
    capacity = -(-int(need * 1.03) // 1024) * 1024
    log(f"[scene] {scene.num_gaussians} splats, demand {need} instances "
        f"(max of the fixture scene and the noisy start), capacity "
        f"{capacity} ({time.perf_counter() - t0:.1f} s)")

    proj_rows = check_projection()
    pack_rows = check_pack_rows()
    k1 = check_k1(scene, cam, capacity)
    check_k1_edges(scene.device)
    k2_err = check_k2_small(gate_scene, gate_cam, False)
    k2 = check_k2_full(scene, cam, capacity, False)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_err)
    k2_16_err = check_k2_small(gate_scene, gate_cam, True)
    k2_16 = check_k2_full(scene, cam, capacity, True)
    k2_16["max_abs_err"] = max(k2_16["max_abs_err"], k2_16_err)
    k4_err = check_k4_small(gate_scene, gate_cam)
    k4_32, b_full, g32 = check_k4_full(scene, cam, capacity, False)
    k4, _, g16 = check_k4_full(scene, cam, capacity, True)
    k4["max_abs_err"] = max(k4["max_abs_err"], k4_32["max_abs_err"],
                            k4_err)
    seg_direct = check_segreduce(b_full, g32, g16)
    seg = check_segreduce_slots(b_full, g32, g16)
    seg_long = check_long_runs(g32.device)
    for name, row in seg.items():
        row["max_abs_err"] = max(row["max_abs_err"],
                                 seg_direct[name]["max_abs_err"],
                                 seg_long[name])
    del g32, g16, b_full
    tail_diagnostics(scene, cam, capacity)
    parity_gate(gate_scene, gate_cam)
    gradient_gate(gate_scene, gate_cam)
    k3_err = check_k3_small(gate_scene, gate_cam)
    need_e, capacity_e = redraw_capacity(scene)
    log(f"[scene] redraw demand {need_e} instances over the base eye and "
        f"the orbit, capacity {capacity_e}")
    k3 = check_k3_full(scene, cam, capacity_e)
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    fused_quality_gate(scene, cam, capacity_e)

    # -- the main paths, counts reset just before each ----------------------
    launches_a = serving_path(scene, cam, capacity)
    require(launches_a, ("project_fwd", "expand", "pack_rows",
                         "rasterize_fwd"), "serving")
    check_launches(launches_a, dict(
        project_fwd=FRAMES, pack_rows=launches_a["rasterize_fwd"],
        pack_rows16=0), "serving")
    log(f"[launches] serving: {launches_a} over {FRAMES} frames")

    with torch.no_grad():
        target = render(scene, cam, capacity=capacity)
    launches_b, params = training_path(start, cam, target, capacity)
    require(launches_b, ("project_fwd", "project_bwd", "expand",
                         "pack_rows16", "rasterize_fwd16", "rasterize_bwd",
                         "segreduce_bf16"), "training")
    check_launches(launches_b, dict(
        project_bwd=TRAIN_STEPS, pack_rows16=launches_b["rasterize_fwd16"],
        pack_rows=0), "training")
    log(f"[launches] training: {launches_b} over {TRAIN_STEPS} steps")
    launches_c = gradient_step_path(params, cam, target, capacity, "i16")
    require(launches_c, ("expand", "rasterize_fwd", "rasterize_bwd",
                         "segreduce_u16"), "32-byte step")
    check_launches(launches_c, dict(pack_rows=1, pack_rows16=0),
                   "32-byte step")
    launches_d = gradient_step_path(params, cam, target, capacity, "f32")
    require(launches_d, ("rasterize_bwd", "segreduce_rows"),
            "32-byte f32-gather step")
    check_launches(launches_d, dict(pack_rows=1, pack_rows16=0),
                   "32-byte f32-gather step")

    launches_e = redraw_path(scene, capacity_e)
    require(launches_e, ("expand", "rasterize_cached"), "redraw")
    want = dict(rasterize_cached=len(ORBIT) * REDRAW_LAPS,
                expand=REDRAW_LAPS, project_fwd=REDRAW_LAPS,
                rasterize_fwd16=0, rasterize_fwd=0, pack_rows=0,
                pack_rows16=0)
    if any(launches_e[k] != v for k, v in want.items()):
        raise AssertionError(f"redraw launches {launches_e}, want {want}")
    log(f"[launches] redraw: {launches_e} over "
        f"{len(ORBIT) * REDRAW_LAPS} frames")
    log(f"[k3] kernel {k3['ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms "
        f"({k3['bound_by']}), plain {k3['plain_ms']:.4f} ms; "
        f"{launches_e['rasterize_cached']} launches in the redraw path")
    launches_f = redraw32_path(scene, cam, capacity_e)
    require(launches_f, ("expand", "rasterize_fwd"), "32-byte redraw")
    if launches_f["rasterize_cached"] != 0:
        raise AssertionError(f"32-byte redraw launched K3: {launches_f}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"),
                                     prefix="chip_smoke_") as workdir:
        launches_g = asset_path(scene, cam, smi, workdir)
        require(launches_g, ("expand", "pack_rows", "rasterize_fwd"),
                "asset")
        launches_h, grown = densify_path(noisy_start(scene), cam, target,
                                         workdir)
        launches_i, launches_j = dist_path(scene, cam, noisy_start(scene),
                                           target, capacity, smi, workdir)
        launches_tooling = tooling_path(workdir, smi)
        base_rows = dict(rasterize_fwd=k2, rasterize_fwd16=k2_16,
                         rasterize_cached=k3, rasterize_bwd=k4)
        launches_tiles, tile_rows = tile_path(
            gate_scene, gate_cam, scene, cam, noisy_start(scene), base_rows,
            smi, workdir)
    require(launches_h, ("expand", "pack_rows16", "rasterize_fwd16",
                         "rasterize_bwd", "segreduce_bf16"),
            "densify + checkpoint")
    require(launches_j, ("expand", "pack_rows16", "rasterize_fwd16",
                         "rasterize_bwd", "segreduce_bf16"),
            "multi-card steps")
    log(f"[launches] asset: {launches_g}; densify + checkpoint: "
        f"{launches_h}; sharded frames: {launches_i}; multi-card steps: "
        f"{launches_j}")
    k1["max_abs_err"] = max(k1["max_abs_err"], grown["expand"])
    k4["max_abs_err"] = max(k4["max_abs_err"], grown["rasterize_bwd"])
    seg["segreduce_bf16"]["max_abs_err"] = max(
        seg["segreduce_bf16"]["max_abs_err"], grown["segreduce_bf16"])

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    total = {n: sum(launches[n] for launches in (
        launches_a, launches_b, launches_c, launches_d, launches_e,
        launches_f, launches_g, launches_h, launches_i, launches_j,
        *launches_tooling, launches_tiles))
        for n in launches_a}
    csrc = "splatjax_torch/csrc/"
    table = [
        dict(name="expand_instances", route="cuda",
             source=csrc + "expand.cu",
             replaces="splatjax/ops/expand.py:95",
             launches=total["expand"], **k1),
        dict(name="rasterize_fwd", route="cuda",
             source=csrc + "rasterize_fwd.cu",
             replaces="splatjax/ops/rasterize.py:678",
             launches=total["rasterize_fwd"], library_ms=None, **k2),
        dict(name="rasterize_fwd16", route="cuda",
             source=csrc + "rasterize_fwd.cu",
             replaces="splatjax/ops/rasterize.py:678",
             launches=total["rasterize_fwd16"], library_ms=None, **k2_16),
        dict(name="rasterize_cached_fwd", route="cuda",
             source=csrc + "rasterize_cached.cu",
             replaces="splatjax/ops/rasterize.py:1123",
             launches=total["rasterize_cached"], library_ms=None, **k3),
        dict(name="rasterize_bwd", route="cuda",
             source=csrc + "rasterize_bwd.cu",
             replaces="splatjax/ops/rasterize_vjp.py:97",
             launches=total["rasterize_bwd"], library_ms=None, **k4),
        dict(name="segment_reduce_rows", route="cuda",
             source=csrc + "segreduce.cu",
             replaces="splatjax/ops/segreduce.py:44",
             launches=total["segreduce_rows"], **seg["segreduce_rows"]),
        dict(name="segment_reduce_packed_u16", route="cuda",
             source=csrc + "segreduce.cu",
             replaces="splatjax/ops/segreduce.py:143",
             launches=total["segreduce_u16"], **seg["segreduce_u16"]),
        dict(name="segment_reduce_packed_bf16", route="cuda",
             source=csrc + "segreduce.cu",
             replaces="splatjax/ops/segreduce.py:388",
             launches=total["segreduce_bf16"], **seg["segreduce_bf16"]),
        dict(name="project_fwd", route="cuda", source=csrc + "project.cu",
             replaces=None, launches=total["project_fwd"], library_ms=None,
             **proj_rows["project_fwd"]),
        dict(name="project_bwd", route="cuda", source=csrc + "project.cu",
             replaces=None, launches=total["project_bwd"], library_ms=None,
             **proj_rows["project_bwd"]),
        dict(name="pack_gather_rows", route="cuda",
             source=csrc + "pack_rows.cu", replaces=None,
             launches=total["pack_rows"], **pack_rows["pack_rows"]),
        dict(name="pack_gather_rows16", route="cuda",
             source=csrc + "pack_rows.cu", replaces=None,
             launches=total["pack_rows16"], **pack_rows["pack_rows16"]),
    ]
    sources = {"rasterize_fwd": ("rasterize_fwd", "rasterize_fwd.cu",
                                 "rasterize.py:678"),
               "rasterize_fwd16": ("rasterize_fwd16", "rasterize_fwd.cu",
                                   "rasterize.py:678"),
               "rasterize_cached": ("rasterize_cached_fwd",
                                    "rasterize_cached.cu",
                                    "rasterize.py:1123"),
               "rasterize_bwd": ("rasterize_bwd", "rasterize_bwd.cu",
                                 "rasterize_vjp.py:97")}
    for tile in NEW_EDGES:
        for counter, (name, src, where) in sources.items():
            table.append(dict(
                name=f"{name}@{tile}", route="cuda", source=csrc + src,
                replaces="splatjax/ops/" + where,
                launches=total[kernels.tiled_counter(counter, tile)],
                library_ms=None, **tile_rows[tile][counter]))
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
