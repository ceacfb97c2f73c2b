"""Gaussian projection: 3D covariance -> screen-space conic, culls, depths
(PyTorch port of ``splatjax/ops/projection.py``).

Conventions, as in splatjax:
* screen frame x right, y **up**, pixel centers at half-integers;
  ``mean2d = ((ndc_x+1) W/2, (ndc_y+1) H/2)``;
* ``depth`` is camera-space z (negative in front); front-to-back order is
  descending depth;
* the conic inverts the *clamped* 2D covariance rebuilt from the shader's
  eigen-axes (lambda2 >= 0.1, axis length <= 1024 px).

All transforms are written elementwise in f32, so no matmul (and no TF32)
enters the projection.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from splatjax_torch.device import matmul_f32

# Fragment shader discards where -(u^2+v^2) < -4.
POWER_CUTOFF = -4.0
# Worker cull: keep if max_scale * opacity > 1e-4 * |depth|.
SIZE_CULL_THRESHOLD = 1e-4
# Vertex-shader frustum guard band: cull beyond 1.2 * w.
FRUSTUM_GUARD = 1.2


@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Per-Gaussian screen-space quantities (all shapes (N, ...))."""

    mean2d: torch.Tensor     # (N, 2) pixel center, y-up frame
    conic: torch.Tensor      # (N, 3) (A, B, C)
    depth: torch.Tensor      # (N,) camera-space z (negative in front)
    mask: torch.Tensor       # (N,) bool: survives all culls
    bbox_half: torch.Tensor  # (N, 2) half-extent of the support, pixels
    color: torch.Tensor      # (N, 3)
    opacity: torch.Tensor    # (N,)


def eval_sh(sh: Optional[torch.Tensor], dc_color: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Real SH (degree <= 3) view-dependent color. sh: (N, K, 3) bands >= 1;
    dc_color: (N, 3) activated DC color; dirs: (N, 3) unit directions."""
    result = dc_color - 0.5
    if sh is not None and sh.shape[1] > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        k = sh.shape[1]
        basis = [
            -0.4886025119029199 * y,
            0.4886025119029199 * z,
            -0.4886025119029199 * x,
        ]
        if k > 3:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            basis += [
                1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.31539156525252005 * (2.0 * zz - xx - yy),
                -1.0925484305920792 * xz,
                0.5462742152960396 * (xx - yy),
            ]
        if k > 8:
            basis += [
                -0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * xy * z,
                -0.4570457994644658 * y * (4 * zz - xx - yy),
                0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
                -0.4570457994644658 * x * (4 * zz - xx - yy),
                1.445305721320277 * z * (xx - yy),
                -0.5900435899266435 * x * (xx - 3 * yy),
            ]
        b = torch.cat(basis[:k], dim=-1)                    # (N, K)
        result = result + (b[:, :, None] * sh).sum(dim=1)
    return result.add(0.5).clamp_min(0.0)


def project_gaussians(
    means: torch.Tensor,
    cov3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    modelview: torch.Tensor,
    projection: torch.Tensor,
    width: int,
    height: int,
    *,
    max_scales: Optional[torch.Tensor] = None,
    cutout: Optional[torch.Tensor] = None,
    sh: Optional[torch.Tensor] = None,
    camera_pos: Optional[torch.Tensor] = None,
    support_eps: Optional[float] = None,
) -> ProjectedGaussians:
    """Project N Gaussians to screen space with all the viewer's culls.

    ``support_eps`` (the renderer passes its early stop) shrinks the binned
    bbox to the opacity-aware support ``t_eff = min(4, ln(opacity/eps))``;
    None or 0 keeps the exact cutoff-4 support that viewer parity needs.
    See ``splatjax.ops.projection.project_gaussians`` for every argument.
    """
    return _project_f32(
        means, cov3d, colors, opacities, modelview, projection,
        width, height, max_scales, cutout, sh, camera_pos, support_eps,
    )


def _project_f32(
    means, cov3d, colors, opacities, modelview, projection,
    width, height, max_scales, cutout, sh, camera_pos,
    support_eps=None,
) -> ProjectedGaussians:
    f32 = torch.float32
    dev = means.device
    means = means.to(f32)
    cov3d = cov3d.to(f32)
    colors = colors.to(f32)
    opacities = opacities.to(f32)
    mv = modelview.to(dev, f32)
    proj = projection.to(dev, f32)
    focal = (height / 2.0) * proj[1, 1].abs()

    cam = (
        means[:, 0:1] * mv[None, :3, 0]
        + means[:, 1:2] * mv[None, :3, 1]
        + means[:, 2:3] * mv[None, :3, 2]
        + mv[None, :3, 3]
    )                                                 # (N, 3) camera space
    pos2d = (
        cam[:, 0:1] * proj[None, :3, 0]
        + cam[:, 1:2] * proj[None, :3, 1]
        + cam[:, 2:3] * proj[None, :3, 2]
        + proj[None, :3, 3]
    )                                                 # clip xyz
    w_clip = (
        cam[:, 0] * proj[3, 0] + cam[:, 1] * proj[3, 1]
        + cam[:, 2] * proj[3, 2] + proj[3, 3]
    )                                                 # clip w

    bounds = FRUSTUM_GUARD * w_clip
    in_frustum = (
        (pos2d[:, 2] >= -w_clip)
        & (pos2d[:, 0] >= -bounds) & (pos2d[:, 0] <= bounds)
        & (pos2d[:, 1] >= -bounds) & (pos2d[:, 1] <= bounds)
    )

    x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    fz = focal / safe_z
    fz2 = focal / (safe_z * safe_z)
    # T = W J collapses to two column vectors built from rows of MV
    t0 = fz[:, None] * mv[None, 0, :3] - (x * fz2)[:, None] * mv[None, 2, :3]
    t1 = -fz[:, None] * mv[None, 1, :3] + (y * fz2)[:, None] * mv[None, 2, :3]
    u0 = (cov3d * t0[:, None, :]).sum(dim=-1)
    u1 = (cov3d * t1[:, None, :]).sum(dim=-1)
    a = (t0 * u0).sum(dim=-1) + 0.3
    b = (t1 * u0).sum(dim=-1)
    c = (t1 * u1).sum(dim=-1) + 0.3

    mid = 0.5 * (a + c)
    # the sqrt argument is guarded too, as in splatjax: at r2 == 0
    # (isotropic or degenerate covariances) sqrt's backward is 0/0 = NaN
    # even under the outer where, and it would poison every gradient
    r2 = ((a - c) / 2.0).square() + b.square()
    r2_pos = r2 > 0.0
    radius = torch.where(
        r2_pos, torch.where(r2_pos, r2, torch.ones_like(r2)).sqrt(),
        torch.zeros_like(r2))
    lam1 = mid + radius
    lam2 = torch.clamp_min(mid - radius, 0.1)

    # eigenvector of lam1, (1, 0) where (b, lam1 - a) ~ 0
    vx, vy = b, lam1 - a
    v2 = vx * vx + vy * vy
    ok = v2 > 1e-24
    vnorm = torch.where(ok, v2, torch.ones_like(v2)).sqrt()
    dvx = torch.where(ok, vx / vnorm, torch.ones_like(vx))
    dvy = torch.where(ok, vy / vnorm, torch.zeros_like(vy))

    len1 = torch.clamp_max((2.0 * lam1).sqrt(), 1024.0)
    len2 = torch.clamp_max((2.0 * lam2.clamp_min(0.0)).sqrt(), 1024.0)
    lam1_eff = 0.5 * len1 * len1
    lam2_eff = torch.clamp_min(0.5 * len2 * len2, 1e-8)

    inv1 = 1.0 / torch.clamp_min(lam1_eff, 1e-8)
    inv2 = 1.0 / lam2_eff
    conic = torch.stack(
        [
            inv1 * dvx * dvx + inv2 * dvy * dvy,
            (inv1 - inv2) * dvx * dvy,
            inv1 * dvy * dvy + inv2 * dvx * dvx,
        ],
        dim=-1,
    )

    safe_w = torch.where(w_clip.abs() < 1e-8, torch.full_like(w_clip, 1e-8),
                         w_clip)
    ndc = pos2d[:, :2] / safe_w[:, None]
    mean2d = torch.stack(
        [(ndc[:, 0] + 1.0) * (width / 2.0),
         (ndc[:, 1] + 1.0) * (height / 2.0)],
        dim=-1,
    )

    # axis-aligned extent of the rendered ellipse {0.5 d^T conic d <= 4};
    # index-only (it feeds the tile spans), so it carries no gradient and
    # its sqrt's need no guard for the backward
    with torch.no_grad():
        cov_xx = lam1_eff * dvx * dvx + lam2_eff * dvy * dvy
        cov_yy = lam1_eff * dvy * dvy + lam2_eff * dvx * dvx
        bbox_half = torch.stack(
            [(8.0 * cov_xx.clamp_min(0.0)).sqrt(),
             (8.0 * cov_yy.clamp_min(0.0)).sqrt()],
            dim=-1,
        )
        if support_eps is not None and support_eps > 0.0:
            t_eff = torch.clamp(
                opacities.clamp_min(1e-30).log()
                - float(math.log(support_eps)),
                0.0, 4.0,
            )
            shrink = torch.where(t_eff > 0.0, (t_eff * 0.25).sqrt(),
                                 torch.zeros_like(t_eff))
            bbox_half = bbox_half * shrink[:, None]

    depth = z
    if max_scales is None:
        diag = torch.stack(
            [cov3d[:, 0, 0], cov3d[:, 1, 1], cov3d[:, 2, 2]], -1
        )
        max_scales = diag.amax(dim=-1).clamp_min(0.0).sqrt()
    size_keep = (depth < 0.0) & (
        max_scales * opacities > SIZE_CULL_THRESHOLD * (-depth)
    )
    mask = in_frustum & size_keep

    if cutout is not None:
        cutout = cutout.to(dev, f32)
        p = means * torch.tensor([1.0, -1.0, 1.0], dtype=f32, device=dev)
        h = (
            p[:, 0:1] * cutout[None, :3, 0]
            + p[:, 1:2] * cutout[None, :3, 1]
            + p[:, 2:3] * cutout[None, :3, 2]
            + cutout[None, :3, 3]
        )
        hw = (
            p[:, 0] * cutout[3, 0] + p[:, 1] * cutout[3, 1]
            + p[:, 2] * cutout[3, 2] + cutout[3, 3]
        )
        hw = torch.where(hw.abs() < 1e-12, torch.full_like(hw, 1e-12), hw)
        q = h / hw[:, None]
        mask = mask & ((q >= -0.5) & (q <= 0.5)).all(dim=-1)

    out_color = colors
    if sh is not None:
        if camera_pos is None:
            # camera world position = -R^T t of the modelview
            camera_pos = -matmul_f32(mv[:3, :3].T, mv[:3, 3])
        dirs = means - camera_pos.to(dev, f32)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True
                                        ).clamp_min(1e-12)
        out_color = eval_sh(sh.to(f32), colors, dirs)

    return ProjectedGaussians(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        mask=mask,
        bbox_half=bbox_half,
        color=out_color,
        opacity=opacities,
    )
