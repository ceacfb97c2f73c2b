"""Multi-card rendering: gaussian-sharded projection -> band-sharded
rasterization (PyTorch port of ``splatjax/parallel/dist_render.py``).

splatjax's single program becomes one process per rank (SPMD):

  * every rank passes the full scene and camera; rank ``d`` of the band
    axis takes its dealt shard, rows ``d, d + D, d + 2D, ...``;
  * the image is split into horizontal bands of tile rows, one per rank;
    each rank bins and rasterizes its own band with the single-card
    kernels (K1, K2; K4 and K5-K7 in the backward), mean2d.y shifted into
    band-local coordinates;
  * between the two splits, an all_to_all ships each projected gaussian
    to the bands its bbox intersects, in fixed-capacity (source, dest)
    blocks; rows past a block's capacity or past the ``max_bands`` window
    are counted per band, never dropped silently
    (``redistribute="all_gather"`` keeps the O(N) path);
  * the bands' tiles are all-gathered, so every rank returns the full
    image and the per-band overflow vector, bit-identical on every rank.

The collectives are small ``torch.autograd.Function``s over the public
``torch.distributed`` calls, transposed as splatjax's ``shard_map``
transposes them: all_to_all into the reverse all_to_all, all_gather into
a reduce_scatter (sum), all_reduce (sum) into an all_reduce.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from splatjax_torch import trace
from splatjax_torch.camera import Camera
from splatjax_torch.ops.binning import (
    TileConfig,
    bin_gaussians,
    check_tile_edge,
    features_from_projection,
)
from splatjax_torch.ops.projection import ProjectedGaussians, project_params
from splatjax_torch.ops.rasterize import tiles_to_image
from splatjax_torch.ops.rasterize_vjp import rasterize_gathered
from splatjax_torch.parallel.mesh import AxisGroup, AxisName, axis_group
from splatjax_torch.render import default_capacity, resolve_alpha_clip
from splatjax_torch.scene import GaussianScene

# Most bands one gaussian is sent to, doubled for load-balanced bands,
# whose heights range from one tile row (``_balanced_boundaries``) to 4x
# the equal share (``max_band_rows``), so a splat may span more of them
# than the doubled window holds. Spans past the window are not dropped
# silently: each is counted, per losing band, in the overflow vector.
MAX_BANDS = 4


# -- collectives with gradients ---------------------------------------------

def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The all_to_all itself, with no gradient: block d of ``x`` to rank d.
    :class:`_AllToAll` and :class:`_Redistribute` both run it, each way."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, bwd_span):
        ctx.group, ctx.bwd_span = group, bwd_span
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        span = ctx.bwd_span
        with trace.span(span) if span else contextlib.nullcontext():
            n = dist.get_world_size(ctx.group)
            out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g.contiguous(),
                                       op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block d of ``x``'s rows (D equal blocks) goes to rank d; block s of
    the result came from rank s. Backward: the reverse all_to_all."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order. Backward: the
    cotangent's block d summed over ranks (reduce_scatter) to rank d."""
    return _AllGather.apply(x, group, None)


def _gather_band_tiles(out_tiles: torch.Tensor, group) -> torch.Tensor:
    """Every band's tiles on every rank: :func:`all_gather` as the span
    ``sj.band_gather``, its reduce_scatter as ``sj.band_gather_bwd``."""
    with trace.span("sj.band_gather"):
        return _AllGather.apply(out_tiles, group, "sj.band_gather_bwd")


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, identical on every rank. Backward: the
    cotangents summed the same way."""
    return _AllReduce.apply(x, group)


class _Redistribute(torch.autograd.Function):
    """The send buffer's row gather ``packed[src]`` (zero where not
    ``valid``) and its all_to_all, with a backward that takes the reverse
    all_to_all and sums each gaussian's copies in a fixed order: gaussian
    g's copy j sits at buffer row ``pos[j, g]`` (-1 where it was not
    sent), added j = 0, 1, ... . A gather with no atomics, so the
    gradient's bits repeat run to run. The backward is the
    ``sj.redistribute_bwd`` span."""

    @staticmethod
    def forward(ctx, packed, src, valid, pos, group):
        ctx.save_for_backward(pos)
        ctx.group = group
        send = packed.index_select(0, src).masked_fill_(~valid[:, None], 0.0)
        return _exchange(send, group)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        out = None
        with trace.span("sj.redistribute_bwd"):
            g_send = _exchange(g, ctx.group)
            for j in range(pos.shape[0]):
                rows = g_send.index_select(
                    0, pos[j].clamp_min(0)).masked_fill_(
                        (pos[j] < 0)[:, None], 0.0)
                out = rows if out is None else out + rows
        return out, None, None, None, None


# -- layout -------------------------------------------------------------------

def _pack_projected(proj: ProjectedGaussians) -> torch.Tensor:
    """(N, 13) float32: mean2d, conic, color, opacity, depth, bbox, mask."""
    return torch.cat([
        proj.mean2d,
        proj.conic,
        proj.color,
        proj.opacity[:, None],
        proj.depth[:, None],
        proj.bbox_half,
        proj.mask.to(torch.float32)[:, None],
    ], dim=-1)


def _unpack_projected(packed: torch.Tensor) -> ProjectedGaussians:
    return ProjectedGaussians(
        mean2d=packed[:, 0:2],
        conic=packed[:, 2:5],
        depth=packed[:, 9],
        mask=packed[:, 12] > 0.5,
        bbox_half=packed[:, 10:12],
        color=packed[:, 5:8],
        opacity=packed[:, 8],
    )


def padded_band_height(height: int, n_devices: int, tile: int) -> int:
    """Image height padded so each rank owns an equal band of tile rows
    (the ``balance="equal"`` layout)."""
    rows = -(-height // tile)
    rows_per_dev = -(-rows // n_devices)
    return rows_per_dev * tile


def max_band_rows(height: int, n_devices: int, tile: int) -> int:
    """Static per-band tile-row capacity of load-balanced bands: 4x the
    equal share, at most all rows. Each rank rasterizes a band this tall
    and the assembly drops the unused tail rows, so cold bands can
    stretch over sparse regions (sky, borders)."""
    rows = -(-height // tile)
    return min(rows, 4 * (-(-rows // n_devices)))


def _band_layout(height: int, n_dev: int, tile: int, balance: str
                 ) -> tuple[int, int]:
    """(tile rows per band, tile rows the bands partition)."""
    check_tile_edge(tile)
    if balance == "load":
        return max_band_rows(height, n_dev, tile), -(-height // tile)
    if balance == "equal":
        rows = padded_band_height(height, n_dev, tile) // tile
        return rows, rows * n_dev
    raise ValueError(f"balance must be 'load' or 'equal', got {balance!r}")


def _default_pair_capacity(n_loc: int, n_dev: int) -> int:
    """6 N / D^2 rows per (source, dest) block, 128-aligned: real scenes
    load equal bands about 2x unevenly."""
    return max(-(-6 * n_loc // n_dev // 128) * 128, 128)


def _balanced_boundaries(r0, r1, weight, on, n_rows: int, n_dev: int,
                         max_rows: int, group) -> torch.Tensor:
    """(D+1,) int32 tile-row band boundaries equalizing instance load.

    Row r's load is the weight (covered x-tile count) of every local
    gaussian whose rendered bbox rows [r0, r1] cover it, summed over the
    band group. The weights are integers, summed exactly in int64 (one
    difference array and a cumsum per rank, then one all_reduce), so
    every rank reads the same histogram, equal to splatjax's float32 one
    wherever its prefix sums stay below 2^24. Boundary d sits where the
    float32 cumulative load crosses d/D of the total (``searchsorted``,
    as splatjax); a monotone clamp then keeps 1 <= b_{d+1} - b_d <=
    max_rows (0 when rows < D) and covers [0, n_rows)."""
    dev = r0.device
    lo = r0.clamp(0, n_rows - 1).long()
    hi = r1.clamp(0, n_rows - 1).long()
    w = weight.long().masked_fill(~on, 0)
    diff = torch.zeros((n_rows + 1,), dtype=torch.int64, device=dev)
    diff.index_add_(0, lo, w).index_add_(0, hi + 1, -w)
    cover = all_reduce(torch.cumsum(diff, 0)[:n_rows], group)
    cum = torch.cumsum(cover, 0).to(torch.float32)
    targets = cum[-1] * torch.arange(1, n_dev, dtype=torch.float32,
                                     device=dev) / n_dev
    raw = torch.searchsorted(cum, targets, side="left").to(torch.int32)

    min_rows = 1 if n_rows >= n_dev else 0
    bounds = [torch.zeros((), dtype=torch.int32, device=dev)]
    for d in range(1, n_dev):
        prev = bounds[-1]
        lo_b = torch.clamp(prev + min_rows,
                           min=n_rows - (n_dev - d) * max_rows)
        hi_b = torch.clamp(prev + max_rows,
                           max=n_rows - (n_dev - d) * min_rows)
        bounds.append(torch.minimum(torch.maximum(raw[d - 1], lo_b), hi_b))
    bounds.append(torch.full((), n_rows, dtype=torch.int32, device=dev))
    return torch.stack(bounds)


def _band_of(bounds: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Band owning each (clipped, in-range) tile row; empty bands (equal
    consecutive boundaries) are skipped by the right-side search."""
    return torch.searchsorted(bounds, rows.to(bounds.dtype), right=True,
                              out_int32=True) - 1


def _assemble_band_tiles(tiles_all: torch.Tensor, bounds: torch.Tensor,
                         cfg_band: TileConfig, n_rows: int, height: int
                         ) -> torch.Tensor:
    """Gather all-gathered band tiles into global row order and assemble.

    tiles_all: (D * T_band, 8, P); rank d's block holds its band's rows
    [bounds[d], bounds[d+1]) in its first tile rows (the rest of the
    block is padding)."""
    tiles_x = cfg_band.tiles_x
    dev = tiles_all.device
    r = torch.arange(n_rows, dtype=torch.int32, device=dev)
    o = _band_of(bounds, r)
    lr = r - bounds[o.long()]
    row_block = o * (cfg_band.tiles_y * tiles_x) + lr * tiles_x
    idx = (row_block[:, None] + torch.arange(
        tiles_x, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
    cfg_full = TileConfig(cfg_band.width, n_rows * cfg_band.tile_h,
                          cfg_band.tile_w, cfg_band.tile_h)
    img = tiles_to_image(tiles_all.index_select(0, idx.long()), cfg_full)
    # crop the row padding (at the top after the assembly's flip)
    return img[n_rows * cfg_band.tile_h - height:]


# -- the band body ------------------------------------------------------------

def _redistribute(packed, r0, r1, on, my, bounds, *, group, n_dev: int,
                  n_rows: int, tile_h: int, pair_capacity: int,
                  max_bands: int):
    """Ship each projected gaussian to the bands its rows reach: the
    (D * pair_capacity, 13) all_to_all send buffer, exchanged. Returns the
    rows received (block s from rank s) and the (D,) rows each destination
    band loses here: past its block's capacity, and (exactly) every band
    of a gaussian's span outside its ``max_bands`` window centred on the
    band of its mean."""
    dev = packed.device
    n_loc = packed.shape[0]
    i32 = torch.int32
    rmax = n_rows - 1
    b0 = _band_of(bounds, r0.clamp(0, rmax))
    b1 = _band_of(bounds, r1.clamp(0, rmax))
    rc = torch.minimum(
        torch.maximum(torch.floor(my / tile_h).to(i32), r0.clamp(0, rmax)),
        r1.clamp(0, rmax))
    bc = _band_of(bounds, rc)
    w0 = torch.minimum(torch.maximum(bc - (max_bands - 1) // 2, b0),
                       torch.maximum(b1 - max_bands + 1, b0))
    dests = w0[None, :] + torch.arange(max_bands, dtype=i32,
                                       device=dev)[:, None]  # (MAXB, n_loc)
    ok = on[None, :] & (dests <= b1[None, :])
    dest = torch.where(ok, dests, n_dev).reshape(-1)       # sentinel last
    n_e = dest.shape[0]
    order_key, e_sorted = torch.sort(dest, stable=True)
    seg = torch.searchsorted(
        order_key, torch.arange(n_dev + 1, dtype=i32, device=dev),
        side="left")                                      # (D+1,) int64
    idx = seg[:-1, None] + torch.arange(pair_capacity, device=dev)[None, :]
    src = e_sorted[idx.clamp(max=n_e - 1)] % n_loc
    valid = idx < seg[1:, None]
    if trace.recording():
        trace.count(pair_rows=valid.sum(), pair_capacity_rows=valid.numel())
    # buffer row of every (window slot, gaussian) pair, for the backward
    rank_e = torch.empty_like(e_sorted).scatter_(
        0, e_sorted, torch.arange(n_e, device=dev))
    slot = rank_e - seg[dest.long()]
    sent = (dest < n_dev) & (slot < pair_capacity)
    pos = torch.where(sent, dest.long() * pair_capacity + slot,
                      -1).reshape(max_bands, n_loc)
    received = _Redistribute.apply(packed, src.reshape(-1),
                                   valid.reshape(-1), pos, group)

    pair_drop = (seg[1:] - seg[:-1] - pair_capacity).clamp_min(0)
    band_ids = torch.arange(n_dev, dtype=i32, device=dev)[:, None]
    lost = (on[None, :]
            & (band_ids >= b0[None, :]) & (band_ids <= b1[None, :])
            & ((band_ids < w0[None, :])
               | (band_ids >= (w0 + max_bands)[None, :])))
    return received, pair_drop + lost.sum(dim=1)


def _band_render_body(
    means, scales, quats, colors, opacities, sh, modelview, projection, *,
    ag: AxisGroup, width: int, height: int, n_rows: int,
    cfg_band: TileConfig, pair_capacity: int, capacity: int, alpha_clip,
    early_stop: float, redistribute: str, packed16: bool = False,
    balance: str = "load",
):
    """One rank's band: local projection (with optional SH) -> this
    frame's band boundaries -> redistribution -> band-local binning and
    rasterization. Inputs are the rank's dealt shard; ``n_rows`` is the
    tile-row count the bands partition, ``cfg_band.tiles_y`` the static
    rows per band.

    Returns (out_tiles planar (T_band, 8, P), my_drop 0-d int64: binning
    overflow plus the transfer and span drops destined here, bounds
    (D+1,) int32). Differentiable w.r.t. the shard's tensors."""
    n_dev, d, group = ag.size, ag.index, ag.group
    proj_local = project_params(
        means, colors, opacities, modelview, projection, width, height,
        quats=quats, scales=scales, sh=sh,
        # the opacity-aware support bound of render(); 0 keeps it exact
        support_eps=early_stop if early_stop > 0.0 else None,
    )
    packed = _pack_projected(proj_local)              # (n_loc, 13)

    tile_h = cfg_band.tile_h
    with torch.no_grad():
        my = proj_local.mean2d[:, 1]
        by = proj_local.bbox_half[:, 1]
        r0 = torch.floor((my - by) / tile_h).to(torch.int32)
        r1 = torch.floor((my + by) / tile_h).to(torch.int32)
        on = proj_local.mask & (r1 >= 0) & (r0 <= n_rows - 1)
        if n_dev == 1:
            bounds = torch.tensor([0, n_rows], dtype=torch.int32,
                                  device=means.device)
        elif balance == "load":
            mx = proj_local.mean2d[:, 0]
            bx = proj_local.bbox_half[:, 0]
            tx0 = torch.floor((mx - bx) / cfg_band.tile_w).clamp(
                0, cfg_band.tiles_x - 1)
            tx1 = torch.floor((mx + bx) / cfg_band.tile_w).clamp(
                0, cfg_band.tiles_x - 1)
            bounds = _balanced_boundaries(
                r0, r1, (tx1 - tx0).to(torch.int64) + 1, on, n_rows, n_dev,
                cfg_band.tiles_y, group)
        else:
            bounds = torch.arange(n_dev + 1, dtype=torch.int32,
                                  device=means.device) * cfg_band.tiles_y

    if redistribute == "all_gather":
        packed_all = all_gather(packed, group)        # (N, 13)
        pair_drop = None
    elif redistribute == "all_to_all":
        max_bands = min(n_dev, MAX_BANDS if balance != "load"
                        else 2 * MAX_BANDS)
        with trace.span("sj.redistribute"):
            packed_all, pair_drop = _redistribute(    # (D * cap, 13)
                packed, r0, r1, on, my, bounds, group=group, n_dev=n_dev,
                n_rows=n_rows, tile_h=tile_h, pair_capacity=pair_capacity,
                max_bands=max_bands)
    else:
        raise ValueError("redistribute must be 'all_to_all' or "
                         f"'all_gather', got {redistribute!r}")

    proj = _unpack_projected(packed_all)
    # shift into band-local pixel coordinates (y-up, bands bottom-up)
    shift = (bounds[d] * tile_h).to(torch.float32)
    proj = dataclasses.replace(
        proj, mean2d=proj.mean2d - torch.stack(
            [torch.zeros_like(shift), shift])[None, :])
    with torch.no_grad():
        binned = bin_gaussians(proj, cfg_band, capacity)
    out_tiles, _ = rasterize_gathered(
        features_from_projection(proj), binned, None, cfg_band, alpha_clip,
        early_stop, packed16)
    my_drop = binned.overflow
    if pair_drop is not None:
        my_drop = my_drop + all_reduce(pair_drop, group)[d]
    return out_tiles, my_drop, bounds


def render_sharded(
    scene: GaussianScene,
    camera: Camera,
    mesh,
    *,
    axis: AxisName = "dev",
    tile_size: int = 16,
    capacity: Optional[int] = None,
    pair_capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    redistribute: str = "all_to_all",
    return_overflow: bool = False,
    balance: str = "load",
):
    """Render across the ranks of ``mesh`` along ``axis`` (a name, or a
    tuple of names flattened with the last minor). Every rank of the axis
    calls it with the same full scene and camera, and every rank returns
    the same (H, W, 4) image, or ``(image, overflow)`` with
    ``return_overflow=True``: the (D,) int64 per-band count of instances
    dropped at any capacity (per-pair transfer blocks, the ``max_bands``
    span window, binning).

    The gaussian count must divide by the axis size D. ``capacity`` is the
    per-rank binning cap (default ``max(default_capacity(D *
    pair_capacity), 2048)``, or of N with all_gather); ``pair_capacity``
    caps each (source, dest) block (default 6 N / D^2, 128-aligned; up to
    3 N / D for fully concentrated views). ``balance="load"`` picks band
    boundaries per frame from the summed per-tile-row instance
    histogram; ``"equal"`` keeps equal-height bands.
    ``redistribute="all_gather"`` ships every gaussian to every band.

    Differentiable w.r.t. the scene's tensors. Backward runs per rank, and
    the collectives transpose as splatjax's ``shard_map`` does (the tile
    all_gather into a reduce_scatter sum), so rank d's gradient is that of
    the sum of every rank's loss, on its dealt rows only: with the same
    loss on every rank, sum the gradients over ranks and divide by D for
    splatjax's (``make_dp_band_train_step`` does so).
    """
    alpha_clip = resolve_alpha_clip(alpha_clip, False)
    ag = axis_group(mesh, axis)
    n_dev = ag.size
    n = scene.num_gaussians
    if n % n_dev:
        raise ValueError(
            f"gaussian count {n} not divisible by mesh size {n_dev}")
    if pair_capacity is None:
        pair_capacity = _default_pair_capacity(n // n_dev, n_dev)
    recv_rows = n_dev * pair_capacity if redistribute == "all_to_all" \
        else n
    if capacity is None:
        capacity = max(default_capacity(recv_rows), 2048)
    band_rows, n_rows = _band_layout(camera.height, n_dev, tile_size,
                                     balance)
    cfg_band = TileConfig(camera.width, band_rows * tile_size, tile_size,
                          tile_size)
    dev = scene.device

    def deal(x):
        return None if x is None else x[ag.index::n_dev]

    out_tiles, my_drop, bounds = _band_render_body(
        deal(scene.means), deal(scene.scales), deal(scene.quats),
        deal(scene.colors), deal(scene.opacities), deal(scene.sh),
        camera.modelview.to(dev, torch.float32),
        camera.projection.to(dev, torch.float32),
        ag=ag, width=camera.width, height=camera.height, n_rows=n_rows,
        cfg_band=cfg_band, pair_capacity=pair_capacity, capacity=capacity,
        alpha_clip=alpha_clip, early_stop=early_stop,
        redistribute=redistribute, balance=balance,
    )
    img = _assemble_band_tiles(_gather_band_tiles(out_tiles, ag.group),
                               bounds, cfg_band, n_rows, camera.height)
    if return_overflow:
        return img, all_gather(my_drop.reshape(1), ag.group)
    return img
