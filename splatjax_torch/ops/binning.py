"""Tile binning and its transpose (PyTorch port of
``splatjax/ops/binning.py``).

1. per-gaussian tile span from the projected bbox;
2. a stable depth sort of the N gaussians, zero-instance ones keyed +inf to
   the tail, visible ones front to back;
3. the expansion kernel (:mod:`splatjax_torch.ops.expand`) emitting
   per-instance (tile, gaussian) in depth-major order;
4. one stable sort of the instances by tile id, so depth order within a
   tile comes for free;
5. per-tile [start, end) by a search over the sorted tile ids, and the
   rasterizers' block order over the tiles, longest list first
   (:func:`tile_order`).

Capacity truncation drops the depth-farthest instances. The whole path
stays on the device: ``num_instances`` and ``overflow`` are 0-d int64
tensors. The instance counts are summed in int64; the int32 cumsums the
kernels take saturate at 2^31 - 1, which is above any capacity, so a
scene whose instances pass 2^31 drops its excess instead of wrapping.

The transpose of the per-instance row gather (the backward's path back to
gaussians) is :func:`segment_sum_by_gid`: per-gaussian sums of the rows
(K5/K6/K7, :mod:`.segreduce`). On CUDA tensors the kernel reads each
gaussian's rows through the inverse of the tile sort
(``BinnedInstances.by_tile``, :func:`tile_slot_positions`); on CPU tensors
it stays splatjax's path: a stable sort by gid, a row gather and run sums.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from splatjax_torch import trace
from splatjax_torch.kernels import DEFAULT_TILE, TILE_EDGES
from splatjax_torch.ops.expand import expand_instances
from splatjax_torch.ops.projection import ProjectedGaussians
from splatjax_torch.ops.segreduce import (
    _segment_reduce_slots_packed_bf16,
    _segment_reduce_slots_packed_u16,
    _segment_reduce_slots_rows,
    segment_reduce_packed_bf16,
    segment_reduce_packed_u16,
    segment_reduce_rows,
)


def _grad_gather_mode() -> str:
    """Packing of the backward's gradient-row gather, read at call time
    from ``SPLATJAX_GRAD_GATHER`` (the variable splatjax reads):

      "i16"  (default) per-channel-scaled int16 pairs in int32 lanes, summed
             exactly by K6; per-term error channel_max / 65534;
      "bf16" bf16-rounded rows, summed by K5; per-term error 2^-9 relative;
      "f32"  unpacked f32 rows, summed by K5: the exact transpose.
    """
    return os.environ.get("SPLATJAX_GRAD_GATHER", "i16")

# Unpacked per-gaussian feature row layout (f32):
# 0: mean2d.x  1: mean2d.y  2: conic.a  3: conic.b  4: conic.c
# 5: color.r   6: color.g   7: color.b  8: opacity  9: depth  10-15: pad
FEAT_DIM = 16
# Where the int32 instance cumsums saturate. Kernel indices are int32, so a
# capacity is always below it.
CUM_MAX = 2 ** 31 - 1


def check_tile_edge(tile_w: int, tile_h: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless the tile is square with an edge the CUDA
    rasterizers are instantiated for (``TILE_EDGES``). splatjax takes any
    edge; the port takes these."""
    tile_h = tile_w if tile_h is None else tile_h
    if tile_w != tile_h or tile_w not in TILE_EDGES:
        raise ValueError(
            "splatjax_torch renders square tiles with an edge in "
            f"{TILE_EDGES} px, got {tile_w}x{tile_h}")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    width: int
    height: int
    tile_w: int = DEFAULT_TILE
    tile_h: int = DEFAULT_TILE

    def __post_init__(self):
        check_tile_edge(self.tile_w, self.tile_h)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_w * self.tile_h


class BinnedInstances(NamedTuple):
    """Fixed-capacity, tile-sorted duplicated instances. The trailing run
    residuals (cum/count/perm/cum_d/count_d, int32; the cumsums saturated
    at ``CUM_MAX``) are what the backward's segment sum will consume.
    ``order`` is the rasterizer kernels' block order over the tiles
    (:func:`tile_order` of ``ends - starts``), built here once per binning
    and used by K2, K3 and K4 on these bounds.
    ``by_tile`` is the tile sort's permutation (tile-order position i holds
    expansion slot ``by_tile[i]``), a port-only field: the gather
    transpose on CUDA reads rows through its inverse."""

    gauss_id: torch.Tensor       # (K_cap,) int32 source gaussian
    tile_id: torch.Tensor        # (K_cap,) int32; num_tiles = sentinel
    starts: torch.Tensor         # (num_tiles,) int32
    ends: torch.Tensor           # (num_tiles,) int32
    order: torch.Tensor          # (num_tiles,) int32 tiles, heaviest first
    num_instances: torch.Tensor  # () int64, total before the capacity cut
    overflow: torch.Tensor       # () int64, instances dropped
    cum: Optional[torch.Tensor] = None      # (N,) inclusive instance cumsum
    count: Optional[torch.Tensor] = None    # (N,) per-gaussian count
    perm: Optional[torch.Tensor] = None     # (N,) depth-compact order
    cum_d: Optional[torch.Tensor] = None    # (N,) cumsum in depth order
    count_d: Optional[torch.Tensor] = None  # (N,) counts in depth order
    by_tile: Optional[torch.Tensor] = None  # (K_cap,) int64 tile sort perm


def features_from_projection(proj: ProjectedGaussians) -> torch.Tensor:
    """Per-gaussian screen features in the (N, 16) unpacked layout;
    culled gaussians get opacity 0."""
    n = proj.mean2d.shape[0]
    opacity = torch.where(proj.mask, proj.opacity,
                          torch.zeros_like(proj.opacity))
    return torch.cat(
        [
            proj.mean2d,
            proj.conic,
            proj.color,
            opacity[:, None],
            proj.depth[:, None],
            proj.mean2d.new_zeros((n, FEAT_DIM - 10)),
        ],
        dim=-1,
    ).to(torch.float32)


def _effective_cum(cum, count, perm, cum_d, count_d, overflow, k: int
                   ) -> torch.Tensor:
    """Per-gaussian run ends (N,) int32 in gid-sorted instance order,
    corrected for capacity truncation (the depth-farthest instances are
    the ones dropped). Both forms are computed and one is selected on the
    device, so the host never waits on ``overflow``. Depth rank r keeps
    the slots ``[min(cum_d[r-1], k), min(cum_d[r], k))``, which holds for
    exact and for saturated ``cum_d``."""
    del count, count_d
    kept = cum_d.long().clamp(max=k)
    inc_d = torch.diff(kept, prepend=kept.new_zeros(1)).to(torch.int32)
    eff_count = torch.zeros_like(inc_d).scatter_(0, perm.long(), inc_d)
    truncated = torch.cumsum(eff_count, dim=0, dtype=torch.int32)
    return torch.where(overflow > 0, truncated, cum.to(torch.int32))


def _gid_order(gid: torch.Tensor) -> torch.Tensor:
    """Instances grouped by gaussian: a stable sort by gid, which equals
    splatjax's (gid, iota) two-key sort."""
    return torch.sort(gid, stable=True).indices


def tile_slot_positions(by_tile: torch.Tensor) -> torch.Tensor:
    """The inverse of the tile sort's permutation, (K,) int32: expansion
    slot s sits at tile-order row ``slot_pos[s]``. One scatter."""
    k = by_tile.shape[0]
    return torch.empty((k,), dtype=torch.int32,
                       device=by_tile.device).scatter_(
        0, by_tile, torch.arange(k, dtype=torch.int32,
                                 device=by_tile.device))


def quantize_grad_u16(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, 16) f32 rows -> ((K, 8) int32 biased-u16 pairs, (16,) scale):
    q = round(g / scale) with scale = channel max / 32767, lane c holding
    ``((q[c+8] + 32768) << 16) | (q[c] + 32768)`` (K6's input)."""
    cmax = g.abs().amax(dim=0)
    scale = torch.where(cmax > 0, cmax, torch.ones_like(cmax)) \
        * (1.0 / 32767.0)
    q = torch.round(g / scale).clamp(-32767.0, 32767.0)
    u = (q + 32768.0).to(torch.int32)
    return (u[:, 8:] << 16) | u[:, :8], scale


def _gather_rows_mode(g: torch.Tensor, mode: str) -> torch.Tensor:
    """The f32 rows K5 sums under ``mode``: rounded to bf16 for "i16" (at
    C != 16) and "bf16", as they are for splatjax's packed gather."""
    if mode in ("i16", "bf16") and g.shape[1] % 2 == 0:
        return g.to(torch.bfloat16).float()
    return g


def _slot_pos(by_tile: Optional[torch.Tensor], k: int) -> torch.Tensor:
    if by_tile is None:
        raise ValueError("on CUDA tensors the gather transpose reads rows "
                         "through the tile sort's inverse: pass by_tile "
                         "(BinnedInstances.by_tile)")
    if tuple(by_tile.shape) != (k,):
        raise ValueError(f"by_tile must be ({k},), got "
                         f"{tuple(by_tile.shape)}")
    return tile_slot_positions(by_tile)


def _segment_sum_slots(g: torch.Tensor, slot_pos: torch.Tensor, cum_d,
                       perm) -> torch.Tensor:
    """:func:`segment_sum_by_gid` through the tile sort's inverse: the
    mode's quantization or rounding in tile order, then K6 or K5 on the
    slots (their plain versions on CPU tensors)."""
    mode = _grad_gather_mode()
    if mode == "i16" and g.shape[1] == 16:
        packed, scale = quantize_grad_u16(g)
        return _segment_reduce_slots_packed_u16(packed, slot_pos, cum_d,
                                                perm) * scale
    return _segment_reduce_slots_rows(
        _gather_rows_mode(g, mode).contiguous(), slot_pos, cum_d, perm)


def segment_sum_by_gid(g: torch.Tensor, gid: torch.Tensor, cum, count,
                       perm, cum_d, count_d, overflow,
                       by_tile: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Transpose of the per-instance row gather: (K, C) f32 tile-order
    gradient rows -> (N, C) per-gaussian sums (K6 for the default "i16"
    mode at C == 16, else K5).

    CUDA tensors: the kernel reads gaussian g's rows through the inverse of
    the tile sort (``by_tile``, required) in slot order, the order a stable
    sort by gid gives them, so no sort and no row copy. CPU tensors:
    splatjax's path, a stable sort by gid, the row gather and run sums
    (instances past the capacity cut carry gid N-1 and zero rows; they sort
    after gaussian N-1's run and enter no sum); ``by_tile`` is not used."""
    k, c = g.shape
    if g.device.type != "cpu":
        return _segment_sum_slots(g, _slot_pos(by_tile, k), cum_d, perm)
    mode = _grad_gather_mode()
    eff_cum = _effective_cum(cum, count, perm, cum_d, count_d, overflow, k)
    order = _gid_order(gid)
    if mode == "i16" and c == 16:
        packed, scale = quantize_grad_u16(g)
        sums = segment_reduce_packed_u16(packed.index_select(0, order),
                                         eff_cum)
        return sums * scale
    return segment_reduce_rows(
        _gather_rows_mode(g, mode).index_select(0, order), eff_cum)


def segment_sum_by_gid_packed_bf16(gp: torch.Tensor, gid: torch.Tensor, cum,
                                   count, perm, cum_d, count_d, overflow,
                                   by_tile: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Transpose of the gather for the 16-byte backward's rows: (K, 8)
    int32 bf16 pairs as K4 writes them (channel c low, c + 8 high) ->
    (N, 16) f32 per-gaussian sums (K7). CUDA tensors read through
    ``by_tile``'s inverse, CPU tensors sort by gid, as
    :func:`segment_sum_by_gid`."""
    k = gp.shape[0]
    if gp.device.type != "cpu":
        return _segment_reduce_slots_packed_bf16(
            gp, _slot_pos(by_tile, k), cum_d, perm)
    eff_cum = _effective_cum(cum, count, perm, cum_d, count_d, overflow, k)
    return segment_reduce_packed_bf16(gp.index_select(0, _gid_order(gid)),
                                      eff_cum)


def gaussian_tile_span(proj: ProjectedGaussians, cfg: TileConfig):
    """Per-gaussian inclusive tile bbox [x0, x1] x [y0, y1] and instance
    count (int32); culled and off-screen gaussians get count 0."""
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    bx, by = proj.bbox_half[:, 0], proj.bbox_half[:, 1]
    i32 = torch.int32
    x0 = torch.floor((mx - bx) / cfg.tile_w).to(i32)
    x1 = torch.floor((mx + bx) / cfg.tile_w).to(i32)
    y0 = torch.floor((my - by) / cfg.tile_h).to(i32)
    y1 = torch.floor((my + by) / cfg.tile_h).to(i32)

    offscreen = (
        (x1 < 0) | (x0 >= cfg.tiles_x) | (y1 < 0) | (y0 >= cfg.tiles_y)
    )
    x0 = x0.clamp(0, cfg.tiles_x - 1)
    x1 = x1.clamp(0, cfg.tiles_x - 1)
    y0 = y0.clamp(0, cfg.tiles_y - 1)
    y1 = y1.clamp(0, cfg.tiles_y - 1)

    keep = proj.mask & ~offscreen
    count = torch.where(keep, (x1 - x0 + 1) * (y1 - y0 + 1),
                        torch.zeros_like(x0))
    return x0, x1, y0, y1, count.to(i32)


def _saturate_i32(cum: torch.Tensor) -> torch.Tensor:
    """An int64 cumsum as int32, saturated at ``CUM_MAX``: exact below it,
    and never wrapped past it."""
    return cum.clamp(max=CUM_MAX).to(torch.int32)


class DepthOrder(NamedTuple):
    """Gaussians in depth-compact order: the expansion kernel's inputs
    (all (N,) int32) and the original-order run residuals."""

    x0_d: torch.Tensor     # tile-rect origin x
    y0_d: torch.Tensor     # tile-rect origin y
    spanw_d: torch.Tensor  # tile-rect width
    cum_d: torch.Tensor    # inclusive instance cumsum in depth order
    perm: torch.Tensor     # original gaussian id
    count_d: torch.Tensor  # instance count in depth order
    cum: torch.Tensor      # inclusive instance cumsum, original order
    count: torch.Tensor    # instance count, original order
    total: torch.Tensor    # () int64, all instances


def depth_order(proj: ProjectedGaussians, cfg: TileConfig) -> DepthOrder:
    """Tile spans and the depth-compact gaussian sort: gaussians with
    instances first, front to back (ascending -depth); empty ones keyed
    +inf to the tail. The sort is stable, so ties keep index order exactly
    like splatjax's (key, iota) sort. The cumsums are summed in int64 and
    saturated at ``CUM_MAX`` (:func:`_saturate_i32`); ``total`` is exact."""
    i32 = torch.int32
    x0, x1, y0, y1, count = gaussian_tile_span(proj, cfg)
    span_w = (x1 - x0 + 1).to(i32)
    dkey = torch.where(count > 0, -proj.depth.to(torch.float32),
                       torch.full_like(proj.depth, float("inf")))
    _, perm64 = torch.sort(dkey, stable=True)
    count_d = count[perm64]
    cum64 = torch.cumsum(count, dim=0, dtype=torch.int64)
    return DepthOrder(
        x0_d=x0[perm64].contiguous(),
        y0_d=y0[perm64].contiguous(),
        spanw_d=span_w[perm64].contiguous(),
        cum_d=_saturate_i32(torch.cumsum(count_d, dim=0, dtype=torch.int64)),
        perm=perm64.to(i32),
        count_d=count_d,
        cum=_saturate_i32(cum64),
        count=count,
        total=cum64[-1],
    )


def tile_order(work: torch.Tensor) -> torch.Tensor:
    """The order in which the rasterizer kernels' blocks take their tiles:
    a permutation of all tiles by descending ``work`` (the tile's list
    length), ties in index order, as (T,) int32. Block b draws tile
    ``order[b]``, so the deepest tiles start first instead of finishing
    last; results do not depend on it. On the device, no host sync."""
    return torch.argsort(work, descending=True, stable=True).to(torch.int32)


def bin_gaussians(proj: ProjectedGaussians, cfg: TileConfig,
                  capacity: int) -> BinnedInstances:
    """Build the tile-sorted instance lists with static capacity K_cap.

    Within a tile, instances are in exact f32 front-to-back depth order."""
    if not 0 < capacity <= CUM_MAX:
        raise ValueError(f"capacity must be in [1, {CUM_MAX}], got "
                         f"{capacity}")
    with trace.span("sj.bin"):
        n = proj.mean2d.shape[0]
        dev = proj.mean2d.device
        i32 = torch.int32
        if n == 0:  # empty scene: all-sentinel instances
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            return BinnedInstances(
                gauss_id=torch.zeros((capacity,), dtype=i32, device=dev),
                tile_id=torch.full((capacity,), cfg.num_tiles, dtype=i32,
                                   device=dev),
                starts=torch.zeros((cfg.num_tiles,), dtype=i32, device=dev),
                ends=torch.zeros((cfg.num_tiles,), dtype=i32, device=dev),
                order=torch.arange(cfg.num_tiles, dtype=i32, device=dev),
                num_instances=zero,
                overflow=zero,
                by_tile=torch.arange(capacity, device=dev),
            )

        d = depth_order(proj, cfg)
        tile, gid = expand_instances(
            d.x0_d, d.y0_d, d.spanw_d, d.cum_d, d.perm,
            capacity, cfg.tiles_x, cfg.num_tiles,
        )

        # one stable sort by tile id: depth-major expansion order keeps exact
        # front-to-back order within each tile; sentinels sort last
        tile_sorted, by_tile = torch.sort(tile, stable=True)
        gid_sorted = gid[by_tile]

        # tile t's instances start at the first sorted id >= t; a search (not
        # a bincount) needs no host sync to size its output
        bounds = torch.searchsorted(
            tile_sorted,
            torch.arange(cfg.num_tiles + 1, dtype=i32, device=dev),
            out_int32=True,
        )

        starts, ends = bounds[:-1], bounds[1:]
        trace.count(instances=d.total)
        return BinnedInstances(
            gauss_id=gid_sorted,
            tile_id=tile_sorted,
            starts=starts,
            ends=ends,
            order=tile_order(ends - starts),
            num_instances=d.total,
            overflow=torch.clamp_min(d.total - capacity, 0),
            cum=d.cum,
            count=d.count,
            perm=d.perm,
            cum_d=d.cum_d,
            count_d=d.count_d,
            by_tile=by_tile,
        )
