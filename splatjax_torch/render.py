"""End-to-end rendering: scene + camera -> (H, W, 4) image (PyTorch port of
``splatjax/render.py``).

covariances, EWA projection and culls (one projection kernel) -> tile
binning (expansion kernel) -> packed-row gather -> forward rasterize
kernel -> image. Every step runs on the scene's device; on a CUDA device
the kernels of :mod:`splatjax_torch.kernels` carry the projection, the
expansion and the rasterization.

:func:`render` is differentiable w.r.t. every scene tensor that requires
grad (and the background): the gather + rasterize step is a
``torch.autograd.Function`` whose backward runs the backward rasterize
kernel and the per-gaussian segment sum (:mod:`.ops.rasterize_vjp`);
the projection's backward is a kernel too (``project_params``). So are
:func:`render_instances` and :func:`render_binned` with plain bins.

The stale-order redraw (:func:`bin_scene` + :func:`render_binned`) reuses a
tile index across frames, as the reference viewer reuses the worker's
previous sort order; with :class:`CachedBins` a 16-byte redraw is one
kernel (K3) that projects the cached per-instance parameters itself.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from splatjax_torch import trace
from splatjax_torch.camera import Camera
from splatjax_torch.device import matmul_f32
from splatjax_torch.ops.binning import (
    BinnedInstances,
    TileConfig,
    bin_gaussians,
    features_from_projection,
)
from splatjax_torch.ops.projection import (
    ProjectedGaussians,
    _cov6,
    project_params,
)
from splatjax_torch.ops.rasterize import (
    _rasterize_cached_fwd,
    _rasterize_fwd,
    cached_camera,
    gather_cached_rows,
    pack_table,
    tiles_to_depth,
    tiles_to_image,
    unpack_cached_rows,
    zbuffer_to_tiles,
)
from splatjax_torch.ops.rasterize_vjp import (
    rasterize_gathered,
    render_image_gathered,
)
from splatjax_torch.scene import GaussianScene, build_covariances

# Clamp that keeps 1/(1 - alpha) bounded for the backward; "auto" resolves
# to it except in viewer_exact mode, which keeps the WebGL blend exact.
DEFAULT_ALPHA_CLIP = 0.999


def default_capacity(num_gaussians: int, dup_factor: int = 4) -> int:
    """Static instance-buffer capacity: ~dup_factor x N, 1024-aligned."""
    cap = max(dup_factor * max(num_gaussians, 1), 1024)
    return -(-cap // 1024) * 1024


def resolve_alpha_clip(alpha_clip, viewer_exact: bool) -> Optional[float]:
    if isinstance(alpha_clip, str):
        if alpha_clip != "auto":
            raise ValueError(
                f"alpha_clip must be float, None or 'auto', got {alpha_clip!r}"
            )
        return None if viewer_exact else DEFAULT_ALPHA_CLIP
    return alpha_clip


def resolve_feature_bytes(feature_bytes, viewer_exact: bool) -> int:
    """Resolve the packed instance-row width. "auto" = 32 (full-precision
    rows, inside the 1e-3 viewer-parity budget). 16 selects the
    fixed-point / bf16 / RGBA8 training rows: the training default, and a
    speed knob for redraw, not a parity mode."""
    if isinstance(feature_bytes, str):
        if feature_bytes != "auto":
            raise ValueError("feature_bytes must be 16, 32 or 'auto', got "
                             f"{feature_bytes!r}")
        return 32
    fb = int(feature_bytes)
    if fb not in (16, 32):
        raise ValueError(f"feature_bytes must be 16, 32 or 'auto', got {fb}")
    if fb == 16 and viewer_exact:
        raise ValueError(
            "feature_bytes=16 is not a parity mode; use 32 with viewer_exact"
        )
    return fb


def _project_scene(scene: GaussianScene, modelview, projection, width,
                   height, *, viewer_exact, cutout, support_eps
                   ) -> ProjectedGaussians:
    with trace.span("sj.project"):
        return project_params(
            scene.means, scene.colors, scene.opacities, modelview,
            projection, width, height, quats=scene.quats,
            scales=scene.scales, cutout=cutout, sh=scene.sh,
            support_eps=support_eps, viewer_exact=viewer_exact,
        )


def _draw_binned(proj: ProjectedGaussians, b: BinnedInstances,
                 cfg: TileConfig, *, alpha_clip, early_stop, background,
                 zbuf, return_depth, packed16):
    """Gather, rasterize and assemble projected gaussians over the tile
    index ``b``; returns (image, depth or None), differentiable w.r.t. the
    projection and the background. background/zbuf: f32 tensors on the
    projection's device, or None."""
    feat_n = features_from_projection(proj)
    zbuf_tiles = None if zbuf is None else zbuffer_to_tiles(zbuf, cfg)
    if not return_depth:
        # image-level backward: K4 takes the image cotangent directly
        return render_image_gathered(feat_n, b, background, zbuf_tiles,
                                     cfg, alpha_clip, early_stop,
                                     packed16), None
    out_tiles, _ = rasterize_gathered(feat_n, b, zbuf_tiles, cfg,
                                      alpha_clip, early_stop, packed16)
    return (tiles_to_image(out_tiles, cfg, background),
            tiles_to_depth(out_tiles, cfg))


def _render_projected(proj: ProjectedGaussians, cfg: TileConfig, *,
                      capacity, **draw):
    """Bin projected gaussians, then :func:`_draw_binned`; returns
    (image, depth or None, overflow)."""
    with torch.no_grad():
        b = bin_gaussians(proj, cfg, capacity)
    return (*_draw_binned(proj, b, cfg, **draw), b.overflow)


def _outputs(img, depth, overflow, return_depth: bool,
             return_overflow: bool):
    out = (img,)
    if return_depth:
        out += (depth,)
    if return_overflow:
        out += (overflow,)
    return out[0] if len(out) == 1 else out


def _as_tensor(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def render(
    scene: GaussianScene,
    camera: Camera,
    *,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    viewer_exact: bool = False,
    cutout=None,
    background=None,
    zbuf=None,
    model=None,
    return_overflow: bool = False,
    return_depth: bool = False,
    feature_bytes="auto",
):
    """Render a scene with the tiled pipeline on the scene's device.

    Args (as ``splatjax.render.render``):
      tile_size: square tile edge in pixels, 8, 16, 32 or 64 (splatjax
        takes any edge; the port's kernels are instantiated for these).
      capacity: static instance-buffer size (None -> 4x N). Instances past
        it are dropped, depth-farthest first; ``return_overflow=True``
        returns their count as a 0-d int64 tensor.
      alpha_clip: "auto" (0.999, or None under viewer_exact), a float, or
        None for no clamp.
      early_stop: stop a tile once every transmittance is below it
        (0.0 = exact blend).
      viewer_exact: the viewer's int16 covariance quantization.
      cutout: optional (4, 4) world -> unit-box cull matrix.
      background: optional (3,) RGB composited under the splats.
      zbuf: optional (H, W) camera-z buffer (row 0 top, -inf = empty).
      model: optional (4, 4) object -> world transform.
      return_depth: also return the (H, W) alpha-weighted camera z.
      feature_bytes: "auto" (32), 32, or 16 for the training rows.
    Returns the image, then depth and overflow when asked for. The image
    (and depth) are differentiable w.r.t. the scene's tensors and the
    background.
    """
    fb = resolve_feature_bytes(feature_bytes, viewer_exact)
    dev = scene.device
    w, h = camera.width, camera.height
    if capacity is None:
        capacity = default_capacity(scene.num_gaussians)
    if scene.num_gaussians == 0:
        return _outputs(
            torch.zeros((h, w, 4), dtype=torch.float32, device=dev),
            torch.zeros((h, w), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            return_depth, return_overflow)
    modelview = camera.modelview.to(dev, torch.float32)
    if model is not None:
        modelview = matmul_f32(modelview, _as_tensor(model, dev))
    proj = _project_scene(
        scene, modelview, camera.projection.to(dev, torch.float32), w, h,
        viewer_exact=viewer_exact, cutout=_as_tensor(cutout, dev),
        support_eps=None if viewer_exact else early_stop,
    )
    return _outputs(*_render_projected(
        proj, TileConfig(w, h, tile_size, tile_size),
        capacity=capacity,
        alpha_clip=resolve_alpha_clip(alpha_clip, viewer_exact),
        early_stop=early_stop,
        background=_as_tensor(background, dev),
        zbuf=_as_tensor(zbuf, dev),
        return_depth=return_depth,
        packed16=fb == 16,
    ), return_depth, return_overflow)


def _scale_camera(camera: Camera, ratio: float) -> Camera:
    """``camera`` at ``ratio`` times its resolution (at least 1 px)."""
    if ratio == 1.0:
        return camera
    return Camera(
        modelview=camera.modelview,
        projection=camera.projection,
        width=max(int(camera.width * ratio), 1),
        height=max(int(camera.height * ratio), 1),
    )


def render_instances(
    instances,
    camera: Camera,
    *,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    background=None,
    zbuf=None,
    return_depth: bool = False,
    return_overflow: bool = False,
    feature_bytes="auto",
):
    """Render several scene instances depth-correctly in one pass.

    instances: sequence of ``(scene, model)`` or ``(scene, model, cutout)``;
    model is an object -> world (4, 4) matrix or None, cutout a
    world -> unit-box matrix or None. Every instance is projected with
    ``modelview @ model`` and the projected sets are concatenated before
    binning, so the one front-to-back sort interleaves the instances
    (splatjax's ``render_instances``). Differentiable like :func:`render`.
    """
    norm = [(inst[0], inst[1], inst[2] if len(inst) > 2 else None)
            for inst in instances]
    dev = norm[0][0].device
    total = sum(s.num_gaussians for s, _, _ in norm)
    if capacity is None:
        capacity = default_capacity(total)
    fb = resolve_feature_bytes(feature_bytes, False)
    if total == 0:
        return render(norm[0][0], camera, tile_size=tile_size,
                      return_depth=return_depth,
                      return_overflow=return_overflow)
    w, h = camera.width, camera.height
    mv0 = camera.modelview.to(dev, torch.float32)
    pr = camera.projection.to(dev, torch.float32)
    projs = []
    for scene, model, cutout in norm:
        mv = mv0 if model is None else matmul_f32(mv0, _as_tensor(model, dev))
        projs.append(_project_scene(scene, mv, pr, w, h, viewer_exact=False,
                                    cutout=_as_tensor(cutout, dev),
                                    support_eps=early_stop))
    proj = ProjectedGaussians(**{
        f.name: torch.cat([getattr(p, f.name) for p in projs])
        for f in dataclasses.fields(ProjectedGaussians)
    })
    return _outputs(*_render_projected(
        proj, TileConfig(w, h, tile_size, tile_size),
        capacity=capacity,
        alpha_clip=resolve_alpha_clip(alpha_clip, False),
        early_stop=early_stop,
        background=_as_tensor(background, dev),
        zbuf=_as_tensor(zbuf, dev),
        return_depth=return_depth,
        packed16=fb == 16,
    ), return_depth, return_overflow)


def composite_over(splat_img: torch.Tensor, under_rgb, under_mask=None
                   ) -> torch.Tensor:
    """Lay opaque content under a rendered splat image:
    rgb + (1 - alpha) * under_rgb. under_rgb: (H, W, 3); under_mask:
    optional (H, W) bool where opaque content exists (alpha is 1 there)."""
    dev = splat_img.device
    under = _as_tensor(under_rgb, dev)
    alpha = splat_img[..., 3:4]
    rgb = splat_img[..., :3] + (1.0 - alpha) * under
    if under_mask is not None:
        mask = torch.as_tensor(under_mask, device=dev)
        alpha = torch.maximum(alpha, mask[..., None].to(alpha.dtype))
    return torch.cat([rgb, alpha], dim=-1)


class CachedBins(NamedTuple):
    """A tile index plus the camera-independent parameters of every
    instance in its order, gathered once per resort
    (``bin_scene(cache_params=True)``). A redraw projects these directly,
    with no per-frame gather; a 16-byte redraw is one kernel (K3) on
    ``prm``, its tiles taken in ``bins.order``. The five parameter fields
    are column views of ``prm`` (``unpack_cached_rows``)."""

    bins: BinnedInstances
    means: torch.Tensor                # (K, 3)
    cov6: torch.Tensor                 # (K, 6) covariance upper triangles
    colors: torch.Tensor               # (K, 3)
    opacities: torch.Tensor            # (K,)
    max_scales: torch.Tensor           # (K,)
    sh: Optional[torch.Tensor]         # (K, B, 3) or None
    prm: torch.Tensor                  # (K, 16) f32 rows K3 reads


def _gather_param_cache(scene: GaussianScene, bins: BinnedInstances,
                        viewer_exact: bool) -> CachedBins:
    with trace.span("sj.gather"):
        gid = bins.gauss_id.long()
        trace.count(rows=gid.shape[0])
        prm = gather_cached_rows(
            gid, scene.means,
            _cov6(build_covariances(scene.quats, scene.scales), viewer_exact),
            scene.colors, scene.opacities, scene.scales.amax(dim=-1))
        sh = None if scene.sh is None else scene.sh.index_select(0, gid)
        return CachedBins(bins, *unpack_cached_rows(prm), sh, prm)


def bin_scene(
    scene: GaussianScene,
    camera: Camera,
    *,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    viewer_exact: bool = False,
    cutout=None,
    early_stop: float = 1e-4,
    cache_params: bool = False,
):
    """Build the tile index of a (scene, view) pair for
    :func:`render_binned`: the port's ``BinnedInstances``, or with
    ``cache_params=True`` a :class:`CachedBins` that also holds every
    instance's camera-independent parameters (64 B per instance, plus 12 B
    per SH band). ``tile_size`` as :func:`render`; draw the bins with the
    same edge. Not differentiable (an index)."""
    cfg = TileConfig(camera.width, camera.height, tile_size, tile_size)
    dev = scene.device
    if capacity is None:
        capacity = default_capacity(scene.num_gaussians)
    with torch.no_grad():
        proj = _project_scene(
            scene, camera.modelview.to(dev, torch.float32),
            camera.projection.to(dev, torch.float32),
            camera.width, camera.height, viewer_exact=viewer_exact,
            cutout=_as_tensor(cutout, dev),
            support_eps=None if viewer_exact else early_stop,
        )
        bins = bin_gaussians(proj, cfg, capacity)
        if not cache_params:
            return bins
        return _gather_param_cache(scene, bins, viewer_exact)


def render_binned(
    scene: GaussianScene,
    camera: Camera,
    bins,
    *,
    tile_size: int = 16,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    viewer_exact: bool = False,
    cutout=None,
    background=None,
    zbuf=None,
    return_depth: bool = False,
    feature_bytes="auto",
):
    """Redraw with a tile index from :func:`bin_scene`: fresh projection
    and shading under ``camera``, stale tile lists and blend order (exact
    when ``camera`` is the one the bins were built with).

    Plain bins project ``scene`` and gather its rows; the image is
    differentiable like :func:`render`. :class:`CachedBins` ignore
    ``scene`` and project the cached per-instance parameters, not
    differentiably: with 16-byte rows and no sh, cutout, zbuf,
    viewer_exact or depth that is one kernel (K3), else a projection, a
    row pack without gather and K2 (splatjax's condition).

    ``tile_size`` must be the edge the bins were built with, at
    ``camera``'s viewport: bins of another tile grid raise ``ValueError``
    (splatjax draws them without a check)."""
    fb = resolve_feature_bytes(feature_bytes, viewer_exact)
    clip = resolve_alpha_clip(alpha_clip, viewer_exact)
    cached = isinstance(bins, CachedBins)
    b = bins.bins if cached else bins
    dev = b.starts.device
    w, h = camera.width, camera.height
    cfg = TileConfig(w, h, tile_size, tile_size)
    if b.starts.numel() != cfg.num_tiles:
        raise ValueError(
            f"bins hold {b.starts.numel()} tiles, but {w}x{h} at tile_size "
            f"{tile_size} has {cfg.num_tiles}: draw bins with the viewport "
            "and tile_size they were built for")
    bg = _as_tensor(background, dev)
    if cached and fb == 16 and bins.sh is None and cutout is None \
            and zbuf is None and not viewer_exact and not return_depth:
        out = _rasterize_cached_fwd(
            bins.prm, cached_camera(camera.modelview, camera.projection, w, h),
            b.starts, b.ends, b.order, cfg, clip, early_stop)
        return tiles_to_image(out, cfg, bg)
    mv = camera.modelview.to(dev, torch.float32)
    pr = camera.projection.to(dev, torch.float32)
    zb = _as_tensor(zbuf, dev)
    if not cached:
        proj = _project_scene(scene, mv, pr, w, h, viewer_exact=viewer_exact,
                              cutout=_as_tensor(cutout, dev),
                              support_eps=None)
        img, depth = _draw_binned(
            proj, b, cfg, alpha_clip=clip, early_stop=early_stop,
            background=bg, zbuf=zb, return_depth=return_depth,
            packed16=fb == 16)
        return (img, depth) if return_depth else img
    with torch.no_grad():
        with trace.span("sj.project"):
            proj = project_params(
                bins.means, bins.colors, bins.opacities, mv, pr, w, h,
                cov6=bins.cov6, max_scales=bins.max_scales,
                cutout=_as_tensor(cutout, dev), sh=bins.sh,
            )
        # rows are already in tile order: pack, no gather
        rows = pack_table(features_from_projection(proj), fb == 16)
        out = _rasterize_fwd(rows, b.starts, b.ends, b.order, cfg, clip,
                             early_stop,
                             None if zb is None else zbuffer_to_tiles(zb, cfg),
                             fb == 16)
    img = tiles_to_image(out, cfg, bg)
    return (img, tiles_to_depth(out, cfg)) if return_depth else img


def render_stereo(
    scene: GaussianScene,
    camera_left: Camera,
    camera_right: Camera,
    *,
    xr_pixel_ratio: float = 0.5,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    viewer_exact: bool = False,
    feature_bytes="auto",
    cutout=None,
    background=None,
    shared_bins: bool = False,
):
    """Render a stereo eye pair at ``xr_pixel_ratio`` of each camera's
    resolution (the reference's XR framebuffer scale). ``shared_bins=True``
    reuses the left eye's tile index for the right eye, as the reference
    shares one sort order between the eyes: exact order per tile, but the
    right eye's tile coverage lags by the baseline's disparity (an
    approximation, not a parity mode). Returns (img_left, img_right)."""
    cl = _scale_camera(camera_left, xr_pixel_ratio)
    cr = _scale_camera(camera_right, xr_pixel_ratio)
    kw = dict(tile_size=tile_size, alpha_clip=alpha_clip,
              early_stop=early_stop, viewer_exact=viewer_exact,
              feature_bytes=feature_bytes, cutout=cutout,
              background=background)
    if shared_bins:
        bins = bin_scene(scene, cl, tile_size=tile_size, capacity=capacity,
                         viewer_exact=viewer_exact, cutout=cutout,
                         early_stop=early_stop)
        return (render_binned(scene, cl, bins, **kw),
                render_binned(scene, cr, bins, **kw))
    return (render(scene, cl, capacity=capacity, **kw),
            render(scene, cr, capacity=capacity, **kw))
