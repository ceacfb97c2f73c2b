"""Forward tile rasterizers (K2 on packed rows, K3 on cached parameter rows
projected in the kernel), row packing and image assembly (PyTorch port of
the forward half of ``splatjax/ops/rasterize.py``).

Instances move as packed int32 rows, 8 lanes wide, in one of splatjax's two
layouts, so both packages quantize identically. The 32-byte viewer rows:

  lane 0-4: f32 bits of mean2d.x, mean2d.y, conic a, b, c
  lane 5:   (r_u16 << 16) | g_u16      color quantized to 1/65535
  lane 6:   (b_u16 << 16) | o_u16
  lane 7:   f32 bits of camera depth

and the 16-byte training rows (``packed16``; the training default):

  lane 0:   (mx_u16 << 16) | my_u16    mean at 1/8 px, biased by 2048 px
  lane 1:   (conic.a bf16 << 16) | conic.b bf16
  lane 2:   (conic.c bf16 << 16) | opacity u16
  lane 3:   (r_u8 << 24) | (g_u8 << 16) | (b_u8 << 8)
  lane 4:   f32 bits of camera depth;  lanes 5-7: zero

The rasterizer's output is planar ``(T, 8, P)`` per tile: rows r, g, b,
T_final, chunks_done, expected depth, log T_final, 0. Tiles are y-up with
pixel centers at +0.5; :func:`tiles_to_image` flips rows so row 0 is on top.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from splatjax_torch import kernels
from splatjax_torch.ops.binning import FEAT_DIM, TileConfig, tile_order
from splatjax_torch.ops.projection import (
    FRUSTUM_GUARD,
    SIZE_CULL_THRESHOLD,
)

CHUNK = 128          # instances per early-stop chunk (globally aligned)
PACKED_ROWS = 8
MEAN16_STEP = 0.125  # 16-byte rows: px per fixed-point mean unit
MEAN16_BIAS = 2048.0  # 16-byte rows: px added before quantizing the mean
# log1p(-alpha) floor standing in for an opaque fragment (alpha == 1)
_LOG_OM_MIN = -60.0
# pixels per step of the plain versions: a step of _plain_tile_batch(P)
# tiles of P pixels bounds their (tiles, P, CHUNK) f32 temporaries to 32 MB
# each at every tile edge
_PLAIN_BATCH_PIXELS = 65536


def _plain_tile_batch(pixels_per_tile: int) -> int:
    return max(1, _PLAIN_BATCH_PIXELS // pixels_per_tile)


_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_int, ctypes.c_void_p]
)
_CACHED_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_float)] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_void_p]
)


def _quant16(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> u16 as int32 (round to nearest)."""
    return torch.floor(x.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32)


def pack_feature_table(feat_n: torch.Tensor) -> torch.Tensor:
    """Unpacked (N, >=10) f32 per-gaussian features -> packed (N, 8) int32
    rows (the gather source)."""
    bits = feat_n[:, 0:5].contiguous().view(torch.int32)
    r, g, b, o = (_quant16(feat_n[:, i]) for i in (5, 6, 7, 8))
    dbits = feat_n[:, 9].contiguous().view(torch.int32)
    return torch.cat(
        [
            bits,
            ((r << 16) | g)[:, None],
            ((b << 16) | o)[:, None],
            dbits[:, None],
        ],
        dim=1,
    ).contiguous()


def _bf16_bits_hi(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 holding the value's bf16 bit pattern in the high half
    (round to nearest even, as splatjax's ``astype(bfloat16)``)."""
    u = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return u << 16


def _quant8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.int32)


def _quant_mean16(x: torch.Tensor) -> torch.Tensor:
    return torch.floor((x + MEAN16_BIAS) * (1.0 / MEAN16_STEP) + 0.5
                       ).clamp(0.0, 65535.0).to(torch.int32)


def pack_feature_table16(feat_n: torch.Tensor) -> torch.Tensor:
    """Unpacked (N, >=10) f32 per-gaussian features -> packed (N, 8) int32
    16-byte training rows (bit-equal to splatjax's
    ``pack_feature_table16``)."""
    mxq, myq = _quant_mean16(feat_n[:, 0]), _quant_mean16(feat_n[:, 1])
    ca, cb, cc = (_bf16_bits_hi(feat_n[:, i]) for i in (2, 3, 4))
    r8, g8, b8 = (_quant8(feat_n[:, i]) for i in (5, 6, 7))
    zero = torch.zeros_like(mxq)
    return torch.stack(
        [
            (mxq << 16) | myq,
            ca | ((cb >> 16) & 0xFFFF),
            cc | _quant16(feat_n[:, 8]),
            (r8 << 24) | (g8 << 16) | (b8 << 8),
            feat_n[:, 9].contiguous().view(torch.int32),
            zero, zero, zero,
        ],
        dim=1,
    )


def pack_table(feat_n: torch.Tensor, packed16: bool = False
               ) -> torch.Tensor:
    """(N, >=10) f32 features -> (N, 8) int32 rows of either layout."""
    return (pack_feature_table16 if packed16 else pack_feature_table)(feat_n)


def pack_feature_rows(feat_fm: torch.Tensor, packed16: bool = False
                      ) -> torch.Tensor:
    """Unpacked feature-major (>=10, K) f32 rows (splatjax's layout) ->
    packed instance-major (K, 8) int32 rows, the layout the port's kernels
    read."""
    return pack_table(feat_fm.T, packed16)


def decode_rows(rows: torch.Tensor, packed16: bool = False
                ) -> tuple[torch.Tensor, ...]:
    """Packed (..., 8) int32 rows -> f32 (mx, my, ca, cb, cc, r, g, b, opa,
    depth), each shaped like ``rows[..., 0]``: splatjax's ``unpack_chunk``
    or ``unpack_chunk16``, instance-major."""
    f32 = torch.float32
    rf = rows.view(f32)
    if not packed16:
        inv = 1.0 / 65535.0
        rg, bo = rows[..., 5], rows[..., 6]
        return (rf[..., 0], rf[..., 1], rf[..., 2], rf[..., 3], rf[..., 4],
                ((rg >> 16) & 0xFFFF).to(f32) * inv,
                (rg & 0xFFFF).to(f32) * inv,
                ((bo >> 16) & 0xFFFF).to(f32) * inv,
                (bo & 0xFFFF).to(f32) * inv,
                rf[..., 7])
    l0, l1, l2, l3 = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    hi = -65536                                        # 0xFFFF0000
    inv255 = 1.0 / 255.0
    return (((l0 >> 16) & 0xFFFF).to(f32) * MEAN16_STEP - MEAN16_BIAS,
            (l0 & 0xFFFF).to(f32) * MEAN16_STEP - MEAN16_BIAS,
            (l1 & hi).view(f32),
            (l1 << 16).view(f32),
            (l2 & hi).view(f32),
            ((l3 >> 24) & 255).to(f32) * inv255,
            ((l3 >> 16) & 255).to(f32) * inv255,
            ((l3 >> 8) & 255).to(f32) * inv255,
            (l2 & 0xFFFF).to(f32) * (1.0 / 65535.0),
            rf[..., 4])


def gather_rows(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Per-instance rows in tile order: (K, 8) int32, instance-major."""
    return table.index_select(0, gid.long())


_PACK_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p]


def pack_gather_rows(feat_n: torch.Tensor, gid: torch.Tensor,
                     packed16: bool = False) -> torch.Tensor:
    """Packed (K, 8) int32 rows of the instances ``gid`` ((K,) int32 in
    [0, N)) from the (N, 16) f32 features, in either layout: bit-equal to
    ``gather_rows(pack_table(feat_n, packed16), gid)``. CPU tensors take
    that composition (:func:`pack_gather_rows_plain`); CUDA tensors launch
    one kernel (``csrc/pack_rows.cu``) that reads each instance's feature
    row through its id, so neither the (N, 8) table nor an int64 copy of
    the ids is made."""
    dev = feat_n.device
    if feat_n.dim() != 2 or feat_n.shape[1] != FEAT_DIM:
        raise ValueError(f"feat_n must have shape (N, {FEAT_DIM}), got "
                         f"{tuple(feat_n.shape)}")
    if gid.dim() != 1:
        raise ValueError(f"gid must have shape (K,), got {tuple(gid.shape)}")
    kernels.check_tensor(feat_n, "feat_n", torch.float32, dev)
    kernels.check_tensor(gid, "gid", torch.int32, dev)
    n, k = feat_n.shape[0], gid.shape[0]
    if n == 0 and k:
        raise ValueError(f"{k} instances of no gaussian")
    if dev.type == "cpu":
        return pack_gather_rows_plain(feat_n, gid, packed16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if feat_n.data_ptr() % 16:
        raise ValueError("feat_n must be 16-byte aligned")
    rows = torch.empty((k, PACKED_ROWS), dtype=torch.int32, device=dev)
    if k:
        fn = kernels.function("pack_rows", "splat_pack_rows", _PACK_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(feat_n.data_ptr(), n, gid.data_ptr(), k, int(packed16),
                     rows.data_ptr(), kernels.stream_of(dev))
        kernels.check_launch("pack_rows16" if packed16 else "pack_rows", err)
    return rows


def pack_gather_rows_plain(feat_n: torch.Tensor, gid: torch.Tensor,
                           packed16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_gather_rows`: the table of all
    N rows, then the gather."""
    return gather_rows(pack_table(feat_n, packed16), gid)


def clip_bounds_alpha(alpha_clip) -> bool:
    """True iff ``alpha_clip`` bounds alpha strictly below 1 after f32
    rounding (the clip is applied to f32 log alpha; 1 - 1e-8 rounds to
    1.0f and does not bound it)."""
    return alpha_clip is not None and float(np.float32(alpha_clip)) < 1.0


def log_clip(alpha_clip) -> Optional[float]:
    """log of the f32-rounded clip; 0.0 when it does not bound alpha below
    1; None for no clamp at all."""
    if alpha_clip is None:
        return None
    if clip_bounds_alpha(alpha_clip):
        return float(np.log(np.float32(alpha_clip)))
    return 0.0


def _log_eps(early_stop: float) -> float:
    return float(math.log(early_stop)) if early_stop > 0.0 else -math.inf


def _check_rows(rows, name: str, width: int, dtype) -> torch.device:
    if rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"{name} must be (K, {width}), got "
                         f"{tuple(rows.shape)}")
    kernels.check_tensor(rows, name, dtype, rows.device)
    return rows.device


def _check_bounds(starts, ends, cfg: TileConfig, dev) -> None:
    for name, t in (("starts", starts), ("ends", ends)):
        if tuple(t.shape) != (cfg.num_tiles,):
            raise ValueError(f"{name} must be ({cfg.num_tiles},), got "
                             f"{tuple(t.shape)}")
        kernels.check_tensor(t, name, torch.int32, dev)


def _check_raster_inputs(rows, starts, ends, zbuf, cfg: TileConfig):
    dev = _check_rows(rows, "rows", PACKED_ROWS, torch.int32)
    num_tiles, p = cfg.num_tiles, cfg.pixels_per_tile
    _check_bounds(starts, ends, cfg, dev)
    if zbuf is not None:
        if tuple(zbuf.shape) != (num_tiles, p, 1):
            raise ValueError(f"zbuf must be ({num_tiles}, {p}, 1), got "
                             f"{tuple(zbuf.shape)}")
        kernels.check_tensor(zbuf, "zbuf", torch.float32, dev)
    return dev


def rasterize_fwd(rows: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor, cfg: TileConfig,
                  alpha_clip: Optional[float] = None,
                  early_stop: float = 1e-4,
                  zbuf: Optional[torch.Tensor] = None,
                  packed16: bool = False) -> torch.Tensor:
    """Composite every tile front to back over its instances
    ``rows[starts[t]:ends[t]]``; returns planar (T, 8, P) f32.

    rows: (K, 8) int32 packed instance rows in tile order (16-byte training
    rows when ``packed16``); starts/ends: (T,) int32; zbuf: optional
    (T, P, 1) camera-z buffer (fragments at or behind it are discarded).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    whose blocks take the tiles longest list first (:func:`tile_order` of
    ``ends - starts``)."""
    return _rasterize_fwd(rows, starts, ends, None, cfg, alpha_clip,
                          early_stop, zbuf, packed16)


def _rasterize_fwd(rows, starts, ends, order: Optional[torch.Tensor],
                   cfg: TileConfig, alpha_clip, early_stop, zbuf,
                   packed16: bool) -> torch.Tensor:
    """:func:`rasterize_fwd` with the kernel's block order: the
    ``BinnedInstances.order`` that binning built with these bounds (the
    library's own, so not checked), or None to build it here."""
    dev = _check_raster_inputs(rows, starts, ends, zbuf, cfg)
    if dev.type == "cpu":
        return rasterize_fwd_plain(rows, starts, ends, cfg, alpha_clip,
                                   early_stop, zbuf, packed16=packed16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((cfg.num_tiles, 8, cfg.pixels_per_tile),
                      dtype=torch.float32, device=dev)
    if order is None:
        order = tile_order(ends - starts)
    lc = log_clip(alpha_clip)
    fn = kernels.function("rasterize_fwd", "splat_rasterize_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            order.data_ptr(), None if zbuf is None else zbuf.data_ptr(),
            out.data_ptr(),
            cfg.num_tiles, cfg.tiles_x, cfg.tile_w, int(lc is not None),
            0.0 if lc is None else lc,
            int(not clip_bounds_alpha(alpha_clip)), _log_eps(early_stop),
            int(packed16), kernels.stream_of(dev),
        )
    kernels.check_launch(kernels.tiled_counter(
        "rasterize_fwd16" if packed16 else "rasterize_fwd", cfg.tile_w), err)
    return out


def rasterize_fwd_plain(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, cfg: TileConfig,
                        alpha_clip: Optional[float] = None,
                        early_stop: float = 1e-4,
                        zbuf: Optional[torch.Tensor] = None,
                        tiles: Optional[torch.Tensor] = None,
                        packed16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`rasterize_fwd`, vectorised over
    tiles, pixels and the instances of one chunk. ``tiles`` (1-D indices)
    renders only those tiles, returning (len(tiles), 8, P)."""
    return _composite_plain(lambda k: decode_rows(rows[k], packed16),
                           rows.shape[0], starts, ends, cfg, alpha_clip,
                           early_stop, zbuf, tiles)


def _composite_plain(decode, k_rows: int, starts: torch.Tensor,
                    ends: torch.Tensor, cfg: TileConfig,
                    alpha_clip: Optional[float] = None,
                    early_stop: float = 1e-4,
                    zbuf: Optional[torch.Tensor] = None,
                    tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward composite shared by the plain versions of K2 and K3:
    ``decode(k)`` maps a (B, C) tensor of instance indices (clamped to
    [0, k_rows)) to the f32 features (mx, my, ca, cb, cc, r, g, b, opa,
    depth), each (B, C); K2 decodes packed rows, K3 projects cached
    parameter rows. Returns planar (len(tiles), 8, P)."""
    dev = starts.device
    f32 = torch.float32
    if tiles is None:
        tiles = torch.arange(cfg.num_tiles, device=dev)
    tiles = tiles.to(dev).long()
    p_n = cfg.pixels_per_tile
    x, y = pixel_coords(cfg, dev)
    basis = (x, y, x * x, x * y, y * y)
    lc = log_clip(alpha_clip)
    clamp = not clip_bounds_alpha(alpha_clip)
    log_eps = _log_eps(early_stop)
    lane = torch.arange(CHUNK, device=dev)
    outs = []
    batch = _plain_tile_batch(p_n)
    for b0 in range(0, tiles.shape[0], batch):
        tb = tiles[b0:b0 + batch]
        nb = tb.shape[0]
        st = starts[tb].long()
        en = ends[tb].long()
        astart = st // CHUNK * CHUNK
        n_chunks = (en - astart + CHUNK - 1) // CHUNK
        ox = ((tb % cfg.tiles_x) * cfg.tile_w).to(f32) + 0.5 * cfg.tile_w
        oy = ((tb // cfg.tiles_x) * cfg.tile_h).to(f32) + 0.5 * cfg.tile_h
        zb = None if zbuf is None else zbuf[tb, :, 0]
        lt = torch.zeros((nb, p_n), dtype=f32, device=dev)
        acc = torch.zeros((nb, p_n, 4), dtype=f32, device=dev)
        done = torch.zeros((nb,), dtype=torch.long, device=dev)
        for c in range(int(n_chunks.max()) if nb else 0):
            active = (c < n_chunks) & (lt.amax(dim=1) > log_eps)
            if not bool(active.any()):
                break
            k = astart[:, None] + c * CHUNK + lane[None, :]      # (B, C)
            in_range = (k >= st[:, None]) & (k < en[:, None])
            f = decode(k.clamp(0, max(k_rows - 1, 0)))          # (B, C)
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
            alpha = torch.where(valid, p_eff.exp(), torch.zeros_like(p_eff))
            s = torch.log1p(-alpha)
            if clamp:
                s = s.clamp_min(_LOG_OM_MIN)
            s_incl = torch.cumsum(s, dim=2)
            s_excl = torch.cat(
                [torch.zeros_like(s[..., :1]), s_incl[..., :-1]], dim=2
            )
            w = torch.where(valid, (s_excl + p_eff).exp(),
                            torch.zeros_like(p_eff))
            contrib = (w[..., None] * col[:, None, :, :]).sum(dim=2)
            act = active[:, None]
            acc = torch.where(act[..., None], acc + lt.exp()[..., None]
                              * contrib, acc)
            lt = torch.where(act, lt + s_incl[..., -1], lt)
            done = done + active.long()
        done_row = done.to(f32)[:, None].expand(nb, p_n)
        outs.append(torch.stack(
            [acc[..., 0], acc[..., 1], acc[..., 2], lt.exp(), done_row,
             acc[..., 3], lt, torch.zeros_like(lt)],
            dim=1,
        ))
    if not outs:
        return torch.zeros((0, 8, p_n), dtype=f32, device=dev)
    return torch.cat(outs, dim=0)


# -- K3: the fused cached-viewer forward ------------------------------------
# A redraw against stale bins (render.render_binned with CachedBins)
# projects the camera-independent per-instance parameters, gathered once
# per resort, inside the rasterizer: one kernel per frame, no per-frame
# gather or pack. The rows stay instance-major, 64 B per instance.

CACHED_ROWS = 16   # mean xyz, cov6 (xx xy xz yy yz zz), rgb, opa, max_scale


class CachedCamera(NamedTuple):
    """What K3 takes of the camera, on the host: the row-major 4x4
    modelview and projection as 16 floats each, and the viewport (the
    kernel gets them as a by-value argument)."""

    modelview: tuple
    projection: tuple
    width: int
    height: int


def cached_camera(modelview, projection, width: int, height: int
                  ) -> CachedCamera:
    """Host copy of a camera for K3 (a camera on the card costs one 128-byte
    read, which waits for its stream)."""
    def host(m):
        return tuple(torch.as_tensor(m).detach().to("cpu", torch.float32)
                     .reshape(16).tolist())

    return CachedCamera(host(modelview), host(projection), int(width),
                        int(height))


def pack_cached_rows(means, cov6, colors, opacities, max_scales
                     ) -> torch.Tensor:
    """Per-instance camera-independent parameters -> (K, 16) f32 rows
    [mean xyz, cov6, rgb, opacity, max_scale, 0, 0] (bit-equal to
    splatjax's ``pack_cached_rows``)."""
    f32 = torch.float32
    k = means.shape[0]
    return torch.cat(
        [means.to(f32), cov6.to(f32), colors.to(f32),
         opacities.to(f32)[:, None], max_scales.to(f32)[:, None],
         torch.zeros((k, CACHED_ROWS - 14), dtype=f32, device=means.device)],
        dim=1,
    ).contiguous()


def unpack_cached_rows(prm: torch.Tensor) -> tuple:
    """Column views of :func:`pack_cached_rows`' rows: (means (K, 3), cov6
    (K, 6), colors (K, 3), opacities (K,), max_scales (K,))."""
    return prm[:, 0:3], prm[:, 3:9], prm[:, 9:12], prm[:, 12], prm[:, 13]


def gather_cached_rows(gid, means, cov6, colors, opacities, max_scales
                       ) -> torch.Tensor:
    """:func:`pack_cached_rows` of per-gaussian parameters at instances
    ``gid``, each parameter gathered straight into its columns: on the
    H100, torch's gather of whole 64-byte rows from a packed (N, 16) table
    takes ~8x as long as these five narrow gathers at a 1080p frame's
    ~2.9M instances."""
    f32 = torch.float32
    prm = torch.zeros((gid.shape[0], CACHED_ROWS), dtype=f32,
                      device=means.device)
    for col, t in zip(unpack_cached_rows(prm),
                      (means, cov6, colors, opacities, max_scales)):
        torch.index_select(t.to(f32), 0, gid, out=col)
    return prm


def project_cached_rows(prm: torch.Tensor, modelview: torch.Tensor,
                        projection: torch.Tensor, width: int, height: int
                        ) -> tuple[torch.Tensor, ...]:
    """Plain version of K3's in-kernel projection: (..., 16) cached rows ->
    the f32 features (mx, my, ca, cb, cc, r, g, b, opa, depth), each shaped
    like ``prm[..., 0]``.

    splatjax's ``_project_rows`` op for op, each op rounded on its own (the
    kernel matches this order without FMA contraction): frustum guard,
    cz < 0 and size culls, the +0.3 dilation, the eigen clamps, and every
    cull folded into opacity = 0."""
    f32 = torch.float32
    mv = modelview.to(prm.device, f32)
    pr = projection.to(prm.device, f32)
    mex, mey, mez = prm[..., 0], prm[..., 1], prm[..., 2]
    sxx, sxy, sxz, syy, syz, szz = (prm[..., i] for i in range(3, 9))
    opa, max_scale = prm[..., 12], prm[..., 13]

    def xform(m, i, vx, vy, vz):
        return m[i, 0] * vx + m[i, 1] * vy + m[i, 2] * vz + m[i, 3]

    def dot3(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    cx, cy, cz = (xform(mv, i, mex, mey, mez) for i in range(3))
    px_c, py_c, pz_c, w_clip = (xform(pr, i, cx, cy, cz) for i in range(4))
    bounds = FRUSTUM_GUARD * w_clip
    in_frustum = (
        (pz_c >= -w_clip)
        & (px_c >= -bounds) & (px_c <= bounds)
        & (py_c >= -bounds) & (py_c <= bounds)
    )
    keep = in_frustum & (cz < 0.0) & (
        max_scale * opa > SIZE_CULL_THRESHOLD * (-cz))

    focal = (height / 2.0) * pr[1, 1].abs()
    safe_z = torch.where(cz.abs() < 1e-8, torch.full_like(cz, 1e-8), cz)
    fz = focal / safe_z
    fz2 = focal / (safe_z * safe_z)
    cxf, cyf = cx * fz2, cy * fz2
    t0 = [fz * mv[0, j] - cxf * mv[2, j] for j in range(3)]
    t1 = [-fz * mv[1, j] + cyf * mv[2, j] for j in range(3)]
    rows = ((sxx, sxy, sxz), (sxy, syy, syz), (sxz, syz, szz))
    u0 = [dot3(r, t0) for r in rows]
    u1 = [dot3(r, t1) for r in rows]
    a = dot3(t0, u0) + 0.3
    b = dot3(t1, u0)
    c = dot3(t1, u1) + 0.3

    mid = 0.5 * (a + c)
    h = 0.5 * (a - c)
    radius = (h * h + b * b).clamp_min(0.0).sqrt()
    lam1 = mid + radius
    lam2 = (mid - radius).clamp_min(0.1)
    vx, vy = b, lam1 - a
    v2 = vx * vx + vy * vy
    ok = v2 > 1e-24
    vnorm = torch.where(ok, v2, torch.ones_like(v2)).sqrt()
    dvx = torch.where(ok, vx / vnorm, torch.ones_like(vx))
    dvy = torch.where(ok, vy / vnorm, torch.zeros_like(vy))
    len1 = (2.0 * lam1).sqrt().clamp_max(1024.0)
    len2 = (2.0 * lam2.clamp_min(0.0)).sqrt().clamp_max(1024.0)
    inv1 = 1.0 / (0.5 * len1 * len1).clamp_min(1e-8)
    inv2 = 1.0 / (0.5 * len2 * len2).clamp_min(1e-8)

    safe_w = torch.where(w_clip.abs() < 1e-8, torch.full_like(w_clip, 1e-8),
                         w_clip)
    return (
        (px_c / safe_w + 1.0) * (width / 2.0),
        (py_c / safe_w + 1.0) * (height / 2.0),
        inv1 * dvx * dvx + inv2 * dvy * dvy,
        (inv1 - inv2) * dvx * dvy,
        inv1 * dvy * dvy + inv2 * dvx * dvx,
        prm[..., 9], prm[..., 10], prm[..., 11],
        torch.where(keep, opa, torch.zeros_like(opa)),
        cz,
    )


def rasterize_cached_fwd(prm: torch.Tensor, camera: CachedCamera,
                         starts: torch.Tensor, ends: torch.Tensor,
                         cfg: TileConfig,
                         alpha_clip: Optional[float] = None,
                         early_stop: float = 1e-4) -> torch.Tensor:
    """Fused cached-viewer forward (K3): project every instance of
    ``prm[starts[t]:ends[t]]`` under ``camera`` and composite the tile;
    returns planar (T, 8, P) f32 with :func:`rasterize_fwd`'s rows.

    prm: (K, 16) f32 cached rows in tile order (:func:`pack_cached_rows`);
    camera: :func:`cached_camera` of the frame. CPU tensors take the plain
    version; CUDA tensors launch the kernel, whose blocks take the tiles
    longest list first (:func:`tile_order` of ``ends - starts``)."""
    return _rasterize_cached_fwd(prm, camera, starts, ends, None, cfg,
                                 alpha_clip, early_stop)


def _rasterize_cached_fwd(prm, camera: CachedCamera, starts, ends,
                          order: Optional[torch.Tensor], cfg: TileConfig,
                          alpha_clip, early_stop) -> torch.Tensor:
    """:func:`rasterize_cached_fwd` with the kernel's block order: the
    ``BinnedInstances.order`` that binning built with these bounds (the
    library's own, so not checked), or None to build it here."""
    dev = _check_rows(prm, "prm", CACHED_ROWS, torch.float32)
    _check_bounds(starts, ends, cfg, dev)
    if (camera.width, camera.height) != (cfg.width, cfg.height):
        raise ValueError(f"camera is {camera.width}x{camera.height}, tiles "
                         f"are for {cfg.width}x{cfg.height}")
    if dev.type == "cpu":
        return rasterize_cached_fwd_plain(prm, camera, starts, ends, cfg,
                                          alpha_clip, early_stop)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if prm.data_ptr() % 16 != 0:
        raise ValueError("prm must be 16-byte aligned")
    out = torch.empty((cfg.num_tiles, 8, cfg.pixels_per_tile),
                      dtype=torch.float32, device=dev)
    if order is None:
        order = tile_order(ends - starts)
    lc = log_clip(alpha_clip)
    mat = ctypes.c_float * 16
    fn = kernels.function("rasterize_cached", "splat_rasterize_cached_fwd",
                          _CACHED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            prm.data_ptr(), mat(*camera.modelview), mat(*camera.projection),
            camera.width, camera.height, starts.data_ptr(), ends.data_ptr(),
            order.data_ptr(), out.data_ptr(), cfg.num_tiles, cfg.tiles_x,
            cfg.tile_w, int(lc is not None),
            0.0 if lc is None else lc,
            int(not clip_bounds_alpha(alpha_clip)), _log_eps(early_stop),
            kernels.stream_of(dev),
        )
    kernels.check_launch(kernels.tiled_counter("rasterize_cached",
                                               cfg.tile_w), err)
    return out


def rasterize_cached_fwd_plain(prm: torch.Tensor, camera: CachedCamera,
                               starts: torch.Tensor, ends: torch.Tensor,
                               cfg: TileConfig,
                               alpha_clip: Optional[float] = None,
                               early_stop: float = 1e-4,
                               tiles: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`rasterize_cached_fwd`:
    :func:`project_cached_rows` as the decode of K2's plain chunk loop.
    ``tiles`` (1-D indices) renders only those tiles."""
    mv, pr = (torch.tensor(m, dtype=torch.float32, device=prm.device
                           ).reshape(4, 4)
              for m in (camera.modelview, camera.projection))
    return _composite_plain(
        lambda k: project_cached_rows(prm[k], mv, pr, camera.width,
                                      camera.height),
        prm.shape[0], starts, ends, cfg, alpha_clip, early_stop, None, tiles)


def pixel_coords(cfg: TileConfig, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) tile-centred pixel coordinates: half-integers in
    [-(edge - 1) / 2, (edge - 1) / 2], exact in f32 (the kernels' basis
    origin)."""
    pix = torch.arange(cfg.pixels_per_tile, device=dev)
    x = (pix % cfg.tile_w).to(torch.float32) + 0.5 - 0.5 * cfg.tile_w
    y = (pix // cfg.tile_w).to(torch.float32) + 0.5 - 0.5 * cfg.tile_h
    return x, y


def fragment_power(mxl, myl, ca, cb, cc, opa, basis):
    """Log alpha before the clip, (B, P, C), from splatjax's per-instance
    polynomial coefficients in tile-centred coordinates; returns it with
    log opacity (B, C). ``basis`` is (x, y, x^2, xy, y^2) over pixels."""
    lnopa = opa.clamp_min(1e-30).log()
    coef = (
        -0.5 * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + lnopa,
        ca * mxl + cb * myl,
        cc * myl + cb * mxl,
        -0.5 * ca,
        -cb,
        -0.5 * cc,
    )
    power = coef[0][:, None, :]
    for cf, bs in zip(coef[1:], basis):
        power = power + cf[:, None, :] * bs[None, :, None]
    return power, lnopa


def support_rect(mxl, myl, ca, cb, cc, lnopa, tile: int
                 ) -> tuple[torch.Tensor, ...]:
    """(x0, x1, y0, y1), f32 like the inputs: a rectangle in tile-centred
    coordinates outside of which no pixel of a ``tile`` x ``tile`` tile
    passes the cutoff, ``fragment_power >= lnopa - 4``, for the instance
    whose mean minus the tile centre is (mxl, myl), with conic (ca, cb, cc)
    and log opacity ``lnopa``. ±inf where the conic is not positive
    definite.

    The plain twin of ``support_mask`` in ``csrc/rows.cuh`` (the 32 and 64
    px kernels skip an instance for a 16x16 sub-block the rectangle
    misses), op for op in f32: the op-by-op power is within 10 ulps x T of
    the exact polynomial (T: the sum of |each term| at |x|, |y| <= tile /
    2), so a hit has ca dx^2 + 2 cb dx dy + cc dy^2 below 8 + 2^-16 (T + 4);
    the ellipse's half-widths use a lower bound of ca cc - cb^2 and are
    raised by 2^-20 of themselves and one pixel."""
    h = 0.5 * tile
    aa, ab, ac = ca.abs(), cb.abs(), cc.abs()
    amx, amy = mxl.abs(), myl.abs()
    t = lnopa.abs() + (0.5 * aa) * (amx * amx)
    t = t + (0.5 * ac) * (amy * amy)
    t = t + ab * (amx * amy)
    t = t + h * ((aa * amx + ab * amy) + (ac * amy + ab * amx))
    t = t + (h * h) * ((0.5 * aa + ab) + 0.5 * ac)
    q = 8.0 + 2.0 ** -16 * (t + 4.0)
    p1, p2 = ca * cc, cb * cb
    det = (p1 - p2) - 2.0 ** -20 * (p1 + p2)
    grow = 1.0 + 2.0 ** -20
    ok = (ca > 0.0) & (det > 0.0)
    inf = torch.full_like(mxl, math.inf)
    hx = torch.where(ok, (q * cc / det).sqrt() * grow + 1.0, inf)
    hy = torch.where(ok, (q * ca / det).sqrt() * grow + 1.0, inf)
    return mxl - hx, mxl + hx, myl - hy, myl + hy


def tiles_to_image(out_tiles: torch.Tensor, cfg: TileConfig,
                   background: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Assemble planar (T, 8, P) tiles into an (H, W, 4) image, row 0 on
    top; alpha = 1 - T_final; optional RGB background under the splats."""
    ty_n, tx_n = cfg.tiles_y, cfg.tiles_x
    th, tw = cfg.tile_h, cfg.tile_w
    x = out_tiles[:, :4, :].reshape(ty_n, tx_n, 4, th, tw)
    x = x.permute(2, 0, 3, 1, 4).reshape(4, ty_n * th, tx_n * tw)
    x = x[:, : cfg.height, : cfg.width]
    rgb = x[:3]
    alpha = 1.0 - x[3]
    if background is not None:
        rgb = rgb + (1.0 - alpha)[None] * background[:, None, None]
    img = torch.cat([rgb, alpha[None]], dim=0)
    return img.permute(1, 2, 0).flip(0).contiguous()


def tiles_to_depth(out_tiles: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """The expected-depth channel as an (H, W) map, row 0 on top (alpha-
    weighted camera z; divide by alpha for the normalized depth)."""
    ty_n, tx_n = cfg.tiles_y, cfg.tiles_x
    th, tw = cfg.tile_h, cfg.tile_w
    x = out_tiles[:, 5, :].reshape(ty_n, tx_n, th, tw)
    x = x.permute(0, 2, 1, 3).reshape(ty_n * th, tx_n * tw)
    return x[: cfg.height, : cfg.width].flip(0).contiguous()


def zbuffer_to_tiles(zbuf_img: torch.Tensor, cfg: TileConfig
                     ) -> torch.Tensor:
    """(H, W) camera-z buffer (row 0 top; -inf = empty) -> (T, P, 1)."""
    ty_n, tx_n = cfg.tiles_y, cfg.tiles_x
    th, tw = cfg.tile_h, cfg.tile_w
    x = zbuf_img.to(torch.float32).flip(0)
    x = torch.nn.functional.pad(
        x, (0, tx_n * tw - cfg.width, 0, ty_n * th - cfg.height),
        value=-math.inf,
    )
    x = x.reshape(ty_n, th, tx_n, tw).permute(0, 2, 1, 3)
    return x.reshape(ty_n * tx_n, th * tw, 1).contiguous()
