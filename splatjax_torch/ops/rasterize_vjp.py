"""Gradient of the tiled rasterizer: backward kernel (K4) wrapper, its plain
version, and the ``torch.autograd.Function``s around gather + K2 (PyTorch
port of ``splatjax/ops/rasterize_vjp.py``).

The backward re-walks each tile's instances in reverse, over exactly the
chunks the forward walked, and recovers per-instance transmittance from the
saved log T_final:

    log T_k = log T_final - sum_{j >= k} log(1 - alpha_j)

With C = sum_i c_i a_i T_i and A = 1 - T_final, per pixel:

    dC/dc_i       = a_i T_i
    dC/da_i       = T_i c_i - S_i / (1 - a_i),  S_i = sum_{j>i} a_j T_j c_j
    dT_final/da_i = -T_final / (1 - a_i)

chained to (mean2d, conic, color, opacity, depth) and summed over the
tile's pixels. Each instance belongs to one tile, so the per-instance rows
are disjoint. The transpose of the row gather (:func:`segment_sum_by_gid`
or, for 16-byte rows, :func:`segment_sum_by_gid_packed_bf16`) sums them
back onto gaussians, and torch autograd carries on through projection.

Gradient rows are instance-major: (K, 16) f32 in the unpacked feature
layout (0-4 mean2d x/y, conic a/b/c; 5-7 color; 8 opacity; 9 depth), or,
for 16-byte rows, (K, 8) int32 bf16 pairs (channel c low, c + 8 high).
splatjax's are feature-major (16, K_pad) / (8, K_pad).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from splatjax_torch import kernels, trace
from splatjax_torch.ops.binning import (
    FEAT_DIM,
    BinnedInstances,
    TileConfig,
    segment_sum_by_gid,
    segment_sum_by_gid_packed_bf16,
    tile_order,
)
from splatjax_torch.ops.rasterize import (
    CHUNK,
    _LOG_OM_MIN,
    _check_raster_inputs,
    _plain_tile_batch,
    _rasterize_fwd,
    clip_bounds_alpha,
    decode_rows,
    fragment_power,
    log_clip,
    pack_feature_rows,
    pack_gather_rows,
    pixel_coords,
    tiles_to_image,
)
from splatjax_torch.ops.segreduce import PACKED_PLANES

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p]
)


def _om_floor(alpha_clip) -> bool:
    """True unless the f32-rounded clip keeps 1 - alpha >= 1e-6, where
    splatjax floors 1 - alpha at 1e-6 before dividing by it."""
    return not (clip_bounds_alpha(alpha_clip)
                and 1.0 - float(np.float32(alpha_clip)) >= 1e-6)


def _pack_grad_bf16(rows16: torch.Tensor) -> torch.Tensor:
    """(K, 16) f32 gradient rows -> (K, 8) int32 bf16 pairs, channel c in
    the low half and c + 8 in the high half, rounded to nearest even with
    splatjax's integer carry arithmetic."""
    b = rows16.contiguous().view(torch.int32)
    rn = b + 0x7FFF + ((b >> 16) & 1)
    return (rn[:, 8:] & -65536) | ((rn[:, :8] >> 16) & 0xFFFF)


def _check_bwd_inputs(rows, starts, ends, out_saved, g_out, zbuf,
                      cfg: TileConfig) -> torch.device:
    dev = _check_raster_inputs(rows, starts, ends, zbuf, cfg)
    t_n, p = cfg.num_tiles, cfg.pixels_per_tile
    if tuple(out_saved.shape) != (t_n, 8, p):
        raise ValueError(f"out_saved must be ({t_n}, 8, {p}), got "
                         f"{tuple(out_saved.shape)}")
    kernels.check_tensor(out_saved, "out_saved", torch.float32, dev)
    if g_out.dim() != 3 or g_out.shape[0] != t_n or g_out.shape[2] != p \
            or g_out.shape[1] not in (4, 8):
        raise ValueError(f"g_out must be ({t_n}, 4 or 8, {p}), got "
                         f"{tuple(g_out.shape)}")
    kernels.check_tensor(g_out, "g_out", torch.float32, dev)
    return dev


def rasterize_bwd(rows: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor, out_saved: torch.Tensor,
                  g_out: torch.Tensor, cfg: TileConfig,
                  alpha_clip: Optional[float] = None,
                  zbuf: Optional[torch.Tensor] = None,
                  packed16: bool = False) -> torch.Tensor:
    """Per-instance gradient rows of the forward rasterizer.

    rows/starts/ends/zbuf: what the forward took; out_saved: its (T, 8, P)
    output (chunks_done in row 4, log T_final in row 6); g_out: planar
    cotangent (T, 4, P) [r, g, b, T_final] or (T, 8, P) (depth in row 5).
    Returns (K, 16) f32 rows, or (K, 8) int32 bf16 pairs when
    ``packed16``; rows of instances the forward did not walk are zero.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    whose blocks take the tiles longest list first (:func:`tile_order` of
    ``ends - starts``)."""
    return _rasterize_bwd(rows, starts, ends, None, out_saved, g_out, cfg,
                          alpha_clip, zbuf, packed16)


def _rasterize_bwd(rows, starts, ends, order: Optional[torch.Tensor],
                   out_saved, g_out, cfg: TileConfig, alpha_clip, zbuf,
                   packed16: bool) -> torch.Tensor:
    """:func:`rasterize_bwd` with the kernel's block order: the
    ``BinnedInstances.order`` that binning built with these bounds (the
    library's own, so not checked), or None to build it here."""
    with trace.span("sj.rasterize_bwd"):
        dev = _check_bwd_inputs(rows, starts, ends, out_saved, g_out, zbuf,
                                cfg)
        if dev.type == "cpu":
            return rasterize_bwd_plain(rows, starts, ends, out_saved, g_out,
                                       cfg, alpha_clip, zbuf,
                                       packed16=packed16)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        k = rows.shape[0]
        grad = (torch.zeros((k, PACKED_PLANES), dtype=torch.int32,
                            device=dev)
                if packed16 else
                torch.zeros((k, FEAT_DIM), dtype=torch.float32, device=dev))
        if order is None:
            order = tile_order(ends - starts)
        lc = log_clip(alpha_clip)
        fn = kernels.function("rasterize_bwd", "splat_rasterize_bwd",
                              _ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(
                rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                order.data_ptr(), out_saved.data_ptr(), g_out.data_ptr(),
                g_out.shape[1],
                None if zbuf is None else zbuf.data_ptr(), grad.data_ptr(),
                cfg.num_tiles, cfg.tiles_x, cfg.tile_w, int(lc is not None),
                0.0 if lc is None else lc,
                int(not clip_bounds_alpha(alpha_clip)),
                int(_om_floor(alpha_clip)), int(packed16),
                kernels.stream_of(dev),
            )
        kernels.check_launch(
            kernels.tiled_counter("rasterize_bwd", cfg.tile_w), err)
        return grad


def _suffix_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum along the last axis."""
    return x.flip(-1).cumsum(-1).flip(-1)


def rasterize_bwd_plain(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, out_saved: torch.Tensor,
                        g_out: torch.Tensor, cfg: TileConfig,
                        alpha_clip: Optional[float] = None,
                        zbuf: Optional[torch.Tensor] = None,
                        tiles: Optional[torch.Tensor] = None,
                        packed16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`rasterize_bwd`, vectorised over
    tiles, pixels and the instances of one chunk (chunks walked last to
    first). ``tiles`` (1-D indices) computes only those tiles' rows."""
    dev = rows.device
    f32 = torch.float32
    k_rows = rows.shape[0]
    grad = torch.zeros((k_rows, FEAT_DIM), dtype=f32, device=dev)
    if tiles is None:
        tiles = torch.arange(cfg.num_tiles, device=dev)
    tiles = tiles.to(dev).long()
    x, y = pixel_coords(cfg, dev)
    basis = (x, y, x * x, x * y, y * y)
    lc = log_clip(alpha_clip)
    clamp = not clip_bounds_alpha(alpha_clip)
    floor = _om_floor(alpha_clip)
    lane = torch.arange(CHUNK, device=dev)
    batch = _plain_tile_batch(cfg.pixels_per_tile)
    for b0 in range(0, tiles.shape[0], batch):
        tb = tiles[b0:b0 + batch]
        st = starts[tb].long()
        en = ends[tb].long()
        astart = st // CHUNK * CHUNK
        c_done = out_saved[tb, 4, 0].long()
        ox = ((tb % cfg.tiles_x) * cfg.tile_w).to(f32) + 0.5 * cfg.tile_w
        oy = ((tb // cfg.tiles_x) * cfg.tile_h).to(f32) + 0.5 * cfg.tile_h
        zb = None if zbuf is None else zbuf[tb, :, 0]
        go = g_out[tb]                                        # (B, gch, P)
        g_d = go[:, 5] if go.shape[1] > 4 else torch.zeros_like(go[:, 0])
        cot = torch.stack([go[:, 0], go[:, 1], go[:, 2], g_d], dim=-1)
        lt_after = out_saved[tb, 6, :]                        # (B, P)
        gtt = go[:, 3] * lt_after.exp()
        s_carry = torch.zeros_like(lt_after)
        for c in range(int(c_done.max()) - 1 if tb.numel() else -1, -1, -1):
            active = c < c_done                               # (B,)
            k = astart[:, None] + c * CHUNK + lane[None, :]   # (B, C)
            in_range = (k >= st[:, None]) & (k < en[:, None]) \
                & active[:, None]
            kc = k.clamp(0, max(k_rows - 1, 0))
            f = decode_rows(rows[kc], packed16)
            mxl = f[0] - ox[:, None]
            myl = f[1] - oy[:, None]
            col = torch.stack([f[5], f[6], f[7], f[9]], dim=-1)  # (B, C, 4)
            power, lnopa = fragment_power(mxl, myl, f[2], f[3], f[4], f[8],
                                          basis)
            valid = (power >= (lnopa - 4.0)[:, None, :]) \
                & in_range[:, None, :]
            if zb is not None:
                valid = valid & (col[:, None, :, 3] > zb[:, :, None])
            p_eff = power if lc is None else torch.clamp_max(power, lc)
            zero = torch.zeros_like(p_eff)
            alpha = torch.where(valid, p_eff.exp(), zero)
            s = torch.log1p(-alpha)
            if clamp:
                s = s.clamp_min(_LOG_OM_MIN)
            s_q = _suffix_cumsum(s)                           # (B, P, C)
            t_k = (lt_after[:, :, None] - s_q).exp()
            gdotc = (cot[:, :, None, :] * col[:, None, :, :]).sum(-1)
            tg = t_k * gdotc
            u = alpha * tg
            u_incl = _suffix_cumsum(u)
            s_excl = torch.cat([u_incl[..., 1:], zero[..., :1]], dim=-1) \
                + s_carry[:, :, None]
            om = 1.0 - alpha
            if floor:
                om = torch.where(om > 1e-6, om, torch.full_like(om, 1e-6))
            g_alpha = tg - (s_excl + gtt[:, :, None]) / om
            if lc is not None:
                g_alpha = torch.where(power < lc, g_alpha, zero)
            g_pow = torch.where(valid, g_alpha * alpha, zero)
            w = alpha * t_k
            dx = x[None, :, None] - mxl[:, None, :]
            dy = y[None, :, None] - myl[:, None, :]
            s1 = g_pow.sum(1)                                 # (B, C)
            sdx, sdy = (g_pow * dx).sum(1), (g_pow * dy).sum(1)
            sdxx = (g_pow * dx * dx).sum(1)
            sdxy = (g_pow * dx * dy).sum(1)
            sdyy = (g_pow * dy * dy).sum(1)
            cw = (w[..., None] * cot[:, :, None, :]).sum(1)   # (B, C, 4)
            ca, cb, cc, opa = f[2], f[3], f[4], f[8]
            g_opa = s1 / torch.where(opa.abs() > 1e-12, opa,
                                     torch.full_like(opa, 1e-12))
            rows16 = torch.stack(
                [ca * sdx + cb * sdy, cb * sdx + cc * sdy, -0.5 * sdxx,
                 -sdxy, -0.5 * sdyy, cw[..., 0], cw[..., 1], cw[..., 2],
                 g_opa, cw[..., 3]],
                dim=-1,
            )                                                 # (B, C, 10)
            grad[k[in_range], :10] = rows16[in_range]
            act = active[:, None]
            lt_after = torch.where(act, lt_after - s_q[:, :, 0], lt_after)
            s_carry = torch.where(act, s_carry + u_incl[:, :, 0], s_carry)
    return _pack_grad_bf16(grad) if packed16 else grad


def image_cotangent_to_tiles(gimg: torch.Tensor, cfg: TileConfig,
                             background: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(H, W, 4) image cotangent -> planar (T, 4, P) [g_r, g_g, g_b, g_T]
    tiles, the transpose of :func:`tiles_to_image` (image rgb = tile rgb +
    T * bg and alpha = 1 - T, so g_T = g_rgb . bg - g_alpha)."""
    ty_n, tx_n = cfg.tiles_y, cfg.tiles_x
    th, tw = cfg.tile_h, cfg.tile_w
    g = gimg.to(torch.float32).flip(0).permute(2, 0, 1)       # (4, H, W)
    if background is None:
        g_t = -g[3]
    else:
        bg = background.to(torch.float32)
        g_t = bg[0] * g[0] + bg[1] * g[1] + bg[2] * g[2] - g[3]
    g = torch.cat([g[:3], g_t[None]], dim=0)
    g = torch.nn.functional.pad(
        g, (0, tx_n * tw - cfg.width, 0, ty_n * th - cfg.height))
    g = g.reshape(4, ty_n, th, tx_n, tw).permute(1, 3, 0, 2, 4)
    return g.reshape(ty_n * tx_n, 4, th * tw).contiguous()


def _grad_rows_to_gaussians(g_rows, b: BinnedInstances):
    """Gather transpose on K4's output form: bf16 pairs (16-byte rows) go
    to K7, f32 rows to :func:`segment_sum_by_gid`; on CUDA both read the
    rows through the tile sort's inverse (``b.by_tile``). Returns
    (N, 16)."""
    res = (b.gauss_id, b.cum, b.count, b.perm, b.cum_d, b.count_d,
           b.overflow)
    with trace.span("sj.gather_bwd"):
        if g_rows.dtype == torch.int32:
            return segment_sum_by_gid_packed_bf16(g_rows, *res,
                                                  by_tile=b.by_tile)
        return segment_sum_by_gid(g_rows, *res, by_tile=b.by_tile)


def _gathered_rows(feat_n, gid, packed16):
    with trace.span("sj.gather"):
        trace.count(rows=gid.shape[0])
        return pack_gather_rows(feat_n.detach(), gid, packed16)


class _RasterizeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_fm, starts, ends, cfg, alpha_clip, early_stop):
        rows = pack_feature_rows(feat_fm.detach().float())
        order = tile_order(ends - starts)  # K2's and K4's block order
        out = _rasterize_fwd(rows, starts, ends, order, cfg, alpha_clip,
                             early_stop, None, False)
        ctx.save_for_backward(rows, starts, ends, order, out)
        ctx.cfg, ctx.alpha_clip, ctx.c = cfg, alpha_clip, feat_fm.shape[0]
        chunks = out[:, 4, 0].to(torch.int32)
        ctx.mark_non_differentiable(chunks)
        return out, chunks

    @staticmethod
    def backward(ctx, g_out, _g_chunks):
        rows, starts, ends, order, out = ctx.saved_tensors
        g = _rasterize_bwd(rows, starts, ends, order, out,
                           g_out.float().contiguous(), ctx.cfg,
                           ctx.alpha_clip, None, False)
        return g[:, :ctx.c].T, None, None, None, None, None


def rasterize_tiles(feat_fm: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, cfg: TileConfig,
                    alpha_clip: Optional[float] = None,
                    early_stop: float = 1e-4):
    """Differentiable tiled rasterization on per-instance features.

    feat_fm: (>=10, K) feature-major sorted instance features (f32, the
    unpacked layout, as splatjax takes them); they move as 32-byte rows,
    whose 1/65535 color and opacity quantization has a straight-through
    gradient. Returns (out_tiles planar (T, 8, P), chunks_done (T,))."""
    return _RasterizeTiles.apply(feat_fm, starts, ends, cfg, alpha_clip,
                                 early_stop)


class _RasterizeGathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_n, b, zbuf, cfg, alpha_clip, early_stop, packed16):
        rows = _gathered_rows(feat_n, b.gauss_id, packed16)
        out = _rasterize_fwd(rows, b.starts, b.ends, b.order, cfg,
                             alpha_clip, early_stop, zbuf, packed16)
        ctx.save_for_backward(rows, out)
        ctx.b, ctx.zbuf = b, zbuf
        ctx.cfg, ctx.alpha_clip, ctx.packed16 = cfg, alpha_clip, packed16
        chunks = out[:, 4, 0].to(torch.int32)
        ctx.mark_non_differentiable(chunks)
        return out, chunks

    @staticmethod
    def backward(ctx, g_out, _g_chunks):
        rows, out = ctx.saved_tensors
        b = ctx.b
        g_rows = _rasterize_bwd(rows, b.starts, b.ends, b.order, out,
                                g_out.float().contiguous(), ctx.cfg,
                                ctx.alpha_clip, ctx.zbuf, ctx.packed16)
        seg = _grad_rows_to_gaussians(g_rows, b)
        return (seg,) + (None,) * 6


def rasterize_gathered(feat_n, bins: BinnedInstances, zbuf, cfg: TileConfig,
                       alpha_clip: Optional[float] = None,
                       early_stop: float = 1e-4, packed16: bool = False):
    """Fused gather + rasterize with one backward (splatjax's, on the
    index as one argument).

    feat_n: (N, 16) f32 unpacked per-gaussian features; bins: the
    ``bin_gaussians`` index (gather ids, tile bounds and block order, run
    residuals); zbuf: optional (T, P, 1). ``packed16`` moves instances as
    16-byte training rows. The backward runs K4 and the gather transpose
    and returns the (N, 16) feature gradient. Returns (out_tiles planar
    (T, 8, P), chunks_done (T,))."""
    return _RasterizeGathered.apply(feat_n, bins, zbuf, cfg, alpha_clip,
                                    early_stop, packed16)


class _RenderImageGathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_n, background, b, zbuf, cfg, alpha_clip,
                early_stop, packed16):
        rows = _gathered_rows(feat_n, b.gauss_id, packed16)
        out = _rasterize_fwd(rows, b.starts, b.ends, b.order, cfg,
                             alpha_clip, early_stop, zbuf, packed16)
        bg = None if background is None else background.detach()
        ctx.save_for_backward(rows, out)
        ctx.b, ctx.zbuf, ctx.bg = b, zbuf, bg
        ctx.cfg, ctx.alpha_clip, ctx.packed16 = cfg, alpha_clip, packed16
        return tiles_to_image(out, cfg, bg)

    @staticmethod
    def backward(ctx, gimg):
        rows, out = ctx.saved_tensors
        b = ctx.b
        g4 = image_cotangent_to_tiles(gimg, ctx.cfg, ctx.bg)
        seg = None
        if ctx.needs_input_grad[0]:
            g_rows = _rasterize_bwd(rows, b.starts, b.ends, b.order, out, g4,
                                    ctx.cfg, ctx.alpha_clip, ctx.zbuf,
                                    ctx.packed16)
            seg = _grad_rows_to_gaussians(g_rows, b)
        g_bg = None
        if ctx.needs_input_grad[1]:
            # image rgb = tile rgb + T * bg: d/d bg_c = sum_pixels g_c T
            g_bg = torch.einsum("tcp,tp->c", g4[:, :3, :], out[:, 3, :])
        return (seg, g_bg) + (None,) * 6


def render_image_gathered(feat_n, bins: BinnedInstances, background, zbuf,
                          cfg: TileConfig,
                          alpha_clip: Optional[float] = None,
                          early_stop: float = 1e-4, packed16: bool = False):
    """Fused gather + rasterize + image assembly with one backward: returns
    the (H, W, 4) image over the optional (3,) ``background``; ``bins`` as
    :func:`rasterize_gathered`. The backward turns the image cotangent into
    K4's 4-channel tile cotangent directly, and also differentiates
    ``background``."""
    return _RenderImageGathered.apply(feat_n, background, bins, zbuf, cfg,
                                      alpha_clip, early_stop, packed16)
