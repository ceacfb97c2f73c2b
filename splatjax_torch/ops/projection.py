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

:func:`project_params` is the renderer's entry: it projects from the
parameters (quaternions and scales, or cached covariance triangles), and
on a CUDA device runs the whole projection, its culls, support boxes and
SH as one kernel (``csrc/project.cu``) with a closed-form backward kernel.
Its plain version is :func:`project_gaussians` on the covariances, with
:func:`project_backward_plain`, the kernel's derivative written in torch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from splatjax_torch import kernels
from splatjax_torch.device import matmul_f32
from splatjax_torch.scene import (
    build_covariances,
    cov6_to_mat,
    covariance_upper,
    dequantize_covariances_int16,
    quantize_covariances_int16,
    quat_to_rotmat,
)

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


def _sh_basis(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
              k: int) -> list:
    """The first ``k`` real SH basis functions (bands >= 1) at unit
    directions (x, y, z)."""
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
    return basis[:k]


def eval_sh(sh: Optional[torch.Tensor], dc_color: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Real SH (degree <= 3) view-dependent color. sh: (N, K, 3) bands >= 1;
    dc_color: (N, 3) activated DC color; dirs: (N, 3) unit directions."""
    result = dc_color - 0.5
    if sh is not None and sh.shape[1] > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        b = torch.cat(_sh_basis(x, y, z, sh.shape[1]), dim=-1)   # (N, K)
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


# --- the renderer's entry: projection from parameters, one kernel pair ----

# SH bands >= 1 a kernel is instantiated for (degrees 0-3)
SH_BANDS = (0, 3, 8, 15)
# eval_sh's basis constants, in its order
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, 0.31539156525252005, 0.5462742152960396)
_SH_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
          0.3731763325901154, 1.445305721320277)


@dataclasses.dataclass(frozen=True)
class _Setup:
    width: int
    height: int
    viewer_exact: bool
    support_eps: Optional[float]  # None: the exact cutoff-4 support
    bands: int                 # SH bands >= 1 (sh.shape[1]), 0 without sh
    sh_eval: bool              # sh given: the color is eval_sh's


def _cov6(cov3d: torch.Tensor, viewer_exact: bool) -> torch.Tensor:
    """(N, 6) upper triangles of the covariances ``cov3d``, through the
    viewer's int16 round trip under ``viewer_exact``."""
    cov6 = covariance_upper(cov3d)
    if viewer_exact:
        cov6 = dequantize_covariances_int16(*quantize_covariances_int16(cov6))
    return cov6


def _viewer_cov(cov3d: torch.Tensor) -> torch.Tensor:
    """The viewer's int16 round trip of the covariances ``cov3d``."""
    return cov6_to_mat(_cov6(cov3d, True))


def project_params(
    means: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    modelview: torch.Tensor,
    projection: torch.Tensor,
    width: int,
    height: int,
    *,
    quats: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    cov6: Optional[torch.Tensor] = None,
    max_scales: Optional[torch.Tensor] = None,
    cutout: Optional[torch.Tensor] = None,
    sh: Optional[torch.Tensor] = None,
    support_eps: Optional[float] = None,
    viewer_exact: bool = False,
) -> ProjectedGaussians:
    """:func:`project_gaussians` from the parameters, in one pass.

    The covariances are built from ``quats`` and ``scales`` (with the
    viewer's int16 round trip under ``viewer_exact``; the size cull reads
    ``scales.amax(-1)``), or read from ``cov6`` (N, 6) upper triangles as
    given, with ``max_scales`` required; the arguments given choose which.
    CPU tensors take :func:`project_gaussians` and the hand backward
    :func:`project_backward_plain`; CUDA tensors launch the forward kernel,
    and the backward kernel when a gradient is asked for. Differentiable
    w.r.t. means, quats, scales, sh and (with sh) colors; the opacity, and
    without sh the color, are the inputs themselves, so their gradients
    flow outside. The ``cov6`` form and the camera take no gradient."""
    f32 = torch.float32
    from_cov6 = cov6 is not None
    if from_cov6 == (quats is not None or scales is not None):
        raise ValueError("give quats and scales, or cov6")
    if from_cov6 and max_scales is None:
        raise ValueError("cov6 needs max_scales")
    if not from_cov6 and (quats is None or scales is None):
        raise ValueError("quats and scales go together")
    dev = means.device
    grad = torch.is_grad_enabled()
    if grad and any(t is not None and t.requires_grad
                    for t in (modelview, projection, cutout)):
        raise ValueError("project_params takes no gradient to the camera")
    if sh is not None and sh.shape[1] > 15:
        raise ValueError(f"sh holds {sh.shape[1]} bands, at most 15")
    setup = _Setup(
        width, height, bool(viewer_exact) and not from_cov6,
        float(support_eps) if support_eps is not None and support_eps > 0
        else None,
        0 if sh is None else sh.shape[1], sh is not None)

    def prep(t):
        return None if t is None else t.to(dev, f32).contiguous()

    mv, pr, cut = prep(modelview), prep(projection), prep(cutout)
    colors, opacities, sh = prep(colors), prep(opacities), prep(sh)
    means = prep(means)
    if from_cov6:
        if grad and any(t is not None and t.requires_grad
                        for t in (means, cov6, colors, sh)):
            raise ValueError("the cov6 form of project_params is not "
                             "differentiable")
        out = _forward(means, None, None, prep(cov6), prep(max_scales),
                       colors, opacities, sh, mv, pr, cut, setup)
    else:
        out = _Project.apply(means, prep(quats), prep(scales), colors,
                             opacities, sh, mv, pr, cut, setup)
    return ProjectedGaussians(
        mean2d=out[0], conic=out[1], depth=out[2], mask=out[3],
        bbox_half=out[4], color=out[5] if setup.sh_eval else colors,
        opacity=opacities)


class _Project(torch.autograd.Function):
    """The quats/scales form of :func:`project_params`: saves its inputs
    only; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, means, quats, scales, colors, opacities, sh, mv, pr,
                cutout, setup):
        ctx.set_materialize_grads(False)
        ctx.setup = setup
        ctx.save_for_backward(means, quats, scales, colors, sh, mv, pr)
        out = _forward(means, quats, scales, None, None, colors, opacities,
                       sh, mv, pr, cutout, setup)
        ctx.mark_non_differentiable(out[3], out[4])
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, _g_mask, _g_bbox,
                 g_color=None):
        means, quats, scales, colors, sh, mv, pr = ctx.saved_tensors
        bwd = (project_backward_plain if means.device.type == "cpu"
               else _backward_kernel)
        g_means, g_quats, g_scales, g_colors, g_sh = bwd(
            means, quats, scales, colors, sh, mv, pr, ctx.setup, g_mean2d,
            g_conic, g_depth, g_color)
        return (g_means, g_quats, g_scales, g_colors, None, g_sh, None, None,
                None, None)


def _forward(means, quats, scales, cov6, max_scales, colors, opacities, sh,
             mv, pr, cutout, s: _Setup) -> tuple:
    """(mean2d, conic, depth, mask, bbox_half) and, with sh, the color."""
    dev = means.device
    if dev.type == "cpu":
        if cov6 is None:
            cov3d = build_covariances(quats, scales)
            if s.viewer_exact:
                cov3d = _viewer_cov(cov3d)
            max_scales = scales.amax(dim=-1)
        else:
            cov3d = cov6_to_mat(cov6)
        p = project_gaussians(
            means, cov3d, colors, opacities, mv, pr, s.width, s.height,
            max_scales=max_scales, cutout=cutout, sh=sh,
            support_eps=s.support_eps)
        return (p.mean2d, p.conic, p.depth, p.mask, p.bbox_half,
                *((p.color,) if s.sh_eval else ()))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _forward_kernel(means, quats, scales, cov6, max_scales, colors,
                           opacities, sh, mv, pr, cutout, s)


def _sh_basis_grad(x, y, z, g_b: list) -> tuple:
    """(dL/dx, dL/dy, dL/dz) from dL/d(basis k) for the first len(g_b)
    functions of :func:`_sh_basis`."""
    k = len(g_b)
    g_b = list(g_b) + [torch.zeros_like(x)] * (15 - k)
    c1 = _SH_C1
    gx, gy, gz = -c1 * g_b[2], -c1 * g_b[0], c1 * g_b[1]
    if k > 3:
        a, b5, c7 = _SH_C2
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        g3, g4, g5, g6, g7 = g_b[3:8]
        gx = gx + a * y * g3 - 2 * b5 * x * g5 - a * z * g6 + 2 * c7 * x * g7
        gy = gy + a * x * g3 - a * z * g4 - 2 * b5 * y * g5 - 2 * c7 * y * g7
        gz = gz - a * y * g4 + 4 * b5 * z * g5 - a * x * g6
    if k > 8:
        a, b, c, d, e = _SH_C3
        g8, g9, g10, g11, g12, g13, g14 = g_b[8:15]
        gx = (gx - 6 * a * xy * g8 + b * yz * g9 + 2 * c * xy * g10
              - 6 * d * xz * g11 - c * (4 * zz - 3 * xx - yy) * g12
              + 2 * e * xz * g13 - 3 * a * (xx - yy) * g14)
        gy = (gy - 3 * a * (xx - yy) * g8 + b * xz * g9
              - c * (4 * zz - xx - 3 * yy) * g10 - 6 * d * yz * g11
              + 2 * c * xy * g12 - 2 * e * yz * g13 + 6 * a * xy * g14)
        gz = (gz + b * xy * g9 - 8 * c * yz * g10
              + d * (6 * zz - 3 * xx - 3 * yy) * g11 - 8 * c * xz * g12
              + e * (xx - yy) * g13)
    return gx, gy, gz


def project_backward_plain(means, quats, scales, colors, sh, mv, pr,
                           s: _Setup, g_mean2d, g_conic, g_depth, g_color):
    """Plain version of the backward kernel of :func:`project_params`
    (quats/scales form): the gradients of (means, quats, scales, colors,
    sh) from the cotangents of mean2d, conic, depth and color (None: zero),
    the last two only with sh (else None). The forward is recomputed from
    the inputs; the derivative is the one torch autograd takes through
    :func:`build_covariances` and :func:`project_gaussians`: zero where a
    clamp clamps, the ``r2 > 0`` and ``v2 > 1e-24`` branches as their
    ``torch.where`` takes them, zero below the SH color's ``clamp_min(0)``,
    the view direction's norm clamped at 1e-12, ties of the viewer round
    trip's ``amax`` sharing its gradient, and none through the cull mask or
    the support box. The kernel follows it line for line."""
    z0 = means.new_zeros(means.shape[0])

    def cols(g, k):
        return [z0] * k if g is None else list(g.unbind(-1))

    gmx, gmy = cols(g_mean2d, 2)
    g_ca, g_cb, g_cc = cols(g_conic, 3)

    # -- the forward, recomputed -------------------------------------------
    def xform(mat, i, v):
        return mat[i, 0] * v[0] + mat[i, 1] * v[1] + mat[i, 2] * v[2] \
            + mat[i, 3]

    cam = [xform(mv, i, means.unbind(-1)) for i in range(3)]
    cx, cy, cz = cam
    px, py, w = (xform(pr, i, cam) for i in (0, 1, 3))
    focal = (s.height / 2.0) * pr[1, 1].abs()
    z_clamped = cz.abs() < 1e-8
    sz = torch.where(z_clamped, torch.full_like(cz, 1e-8), cz)
    fz = focal / sz
    fz2 = focal / (sz * sz)
    cxf, cyf = cx * fz2, cy * fz2
    t0 = [fz * mv[0, j] - cxf * mv[2, j] for j in range(3)]
    t1 = [-fz * mv[1, j] + cyf * mv[2, j] for j in range(3)]

    rot = quat_to_rotmat(quats)
    mm = rot * scales[:, None, :]                       # M = R diag(s)
    cov = build_covariances(quats, scales)
    if s.viewer_exact:
        c6 = covariance_upper(cov)
        q, _ = quantize_covariances_int16(c6)
        cov = _viewer_cov(cov)
    sig = [[cov[:, i, j] for j in range(3)] for i in range(3)]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    u0 = [dot(sig[i], t0) for i in range(3)]
    u1 = [dot(sig[i], t1) for i in range(3)]
    a = dot(t0, u0) + 0.3
    b = dot(t1, u0)
    c = dot(t1, u1) + 0.3
    mid = 0.5 * (a + c)
    hh = (a - c) / 2.0
    r2 = hh * hh + b * b
    r2_pos = r2 > 0.0
    radius = torch.where(r2_pos, torch.where(r2_pos, r2, 1.0).sqrt(), 0.0)
    lam1 = mid + radius
    l2r = mid - radius
    lam2 = l2r.clamp_min(0.1)
    vx, vy = b, lam1 - a
    v2 = vx * vx + vy * vy
    ok = v2 > 1e-24
    vn = torch.where(ok, v2, 1.0).sqrt()
    dvx = torch.where(ok, vx / vn, 1.0)
    dvy = torch.where(ok, vy / vn, 0.0)
    s1 = (2.0 * lam1).sqrt()
    len1 = s1.clamp_max(1024.0)
    s2 = (2.0 * lam2.clamp_min(0.0)).sqrt()
    len2 = s2.clamp_max(1024.0)
    l1e = 0.5 * len1 * len1
    l2e = 0.5 * len2 * len2
    inv1 = 1.0 / l1e.clamp_min(1e-8)
    inv2 = 1.0 / l2e.clamp_min(1e-8)
    sw = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)

    # -- mean2d -------------------------------------------------------------
    g_px = gmx * (s.width / 2.0) / sw
    g_py = gmy * (s.height / 2.0) / sw
    g_w = torch.where(w.abs() < 1e-8, 0.0, -(g_px * px + g_py * py) / sw)

    # -- conic -> (a, b, c) -------------------------------------------------
    dxx, dyy, dxy = dvx * dvx, dvy * dvy, dvx * dvy
    dinv = inv1 - inv2
    g_inv1 = g_ca * dxx + g_cb * dxy + g_cc * dyy
    g_inv2 = g_ca * dyy - g_cb * dxy + g_cc * dxx
    g_dvx = 2.0 * dvx * (g_ca * inv1 + g_cc * inv2) + g_cb * dinv * dvy
    g_dvy = 2.0 * dvy * (g_ca * inv2 + g_cc * inv1) + g_cb * dinv * dvx
    g_l1e = torch.where(l1e >= 1e-8, -g_inv1 * inv1 * inv1, 0.0)
    g_l2e = torch.where(l2e >= 1e-8, -g_inv2 * inv2 * inv2, 0.0)
    g_lam1 = torch.where(s1 <= 1024.0, g_l1e * len1 / s1, 0.0)
    g_lam2 = torch.where((s2 <= 1024.0) & (lam2 >= 0.0), g_l2e * len2 / s2,
                         0.0)
    g_vn = -(g_dvx * dvx + g_dvy * dvy) / vn
    g_v2 = g_vn / (2.0 * vn)
    g_vx = torch.where(ok, g_dvx / vn + 2.0 * vx * g_v2, 0.0)
    g_vy = torch.where(ok, g_dvy / vn + 2.0 * vy * g_v2, 0.0)
    g_lam1 = g_lam1 + g_vy
    g_l2r = torch.where(l2r >= 0.1, g_lam2, 0.0)
    g_mid = g_lam1 + g_l2r
    g_rad = g_lam1 - g_l2r
    g_r2 = torch.where(r2_pos, g_rad / (2.0 * radius), 0.0)
    g_hh = 2.0 * hh * g_r2
    g_a = 0.5 * g_mid + 0.5 * g_hh - g_vy
    g_b = g_vx + 2.0 * b * g_r2
    g_c = 0.5 * g_mid - 0.5 * g_hh

    # -- (a, b, c) -> T and the covariance ----------------------------------
    g_u0 = [g_a * t0[j] + g_b * t1[j] for j in range(3)]
    g_u1 = [g_c * t1[j] for j in range(3)]
    g_t0 = [g_a * u0[j] + dot([sig[i][j] for i in range(3)], g_u0)
            for j in range(3)]
    g_t1 = [g_b * u0[j] + g_c * u1[j]
            + dot([sig[i][j] for i in range(3)], g_u1) for j in range(3)]
    g_sig = [[g_u0[i] * t0[j] + g_u1[i] * t1[j] for j in range(3)]
             for i in range(3)]

    # -- T -> camera space -> means ----------------------------------------
    g_fz = dot(g_t0, mv[0, :3]) - dot(g_t1, mv[1, :3])
    g_cxf = -dot(g_t0, mv[2, :3])
    g_cyf = dot(g_t1, mv[2, :3])
    g_fz2 = g_cxf * cx + g_cyf * cy
    g_sz = -g_fz * fz / sz - 2.0 * g_fz2 * fz2 / sz
    g_cam = [g_cxf * fz2, g_cyf * fz2,
             torch.where(z_clamped, 0.0, g_sz)
             + (z0 if g_depth is None else g_depth)]
    for j in range(3):
        g_cam[j] = g_cam[j] + g_px * pr[0, j] + g_py * pr[1, j] \
            + g_w * pr[3, j]
    g_means = torch.stack(
        [dot(g_cam, mv[:3, j]) for j in range(3)], dim=-1)

    # -- SH ------------------------------------------------------------------
    g_colors = g_sh = None
    if s.sh_eval and g_color is not None:
        cp = -matmul_f32(mv[:3, :3].T, mv[:3, 3])
        v = means - cp
        n = torch.linalg.norm(v, dim=-1)
        nc = n.clamp_min(1e-12)
        d = v / nc[:, None]
        x, y, z = d.unbind(-1)
        basis = _sh_basis(x, y, z, s.bands)
        pre = colors - 0.5
        if basis:
            pre = pre + sum(bk[:, None] * sh[:, k]
                            for k, bk in enumerate(basis))
        pre = pre + 0.5
        g_colors = torch.where(pre >= 0.0, g_color, 0.0)
        g_sh = g_colors[:, None, :] * torch.stack(basis, 1)[:, :, None] \
            if basis else torch.zeros_like(sh)
        g_b = [(g_colors * sh[:, k]).sum(-1) for k in range(s.bands)]
        if g_b:
            g_d = torch.stack(_sh_basis_grad(x, y, z, g_b), dim=-1)
            g_v = g_d / nc[:, None]
            g_nc = -(g_d * d).sum(-1) / nc
            g_n = torch.where(n >= 1e-12, g_nc / torch.where(
                n > 0.0, n, 1.0), 0.0)
            g_means = g_means + g_v + g_n[:, None] * v

    # -- covariance -> M = R diag(s) -> quats, scales ----------------------
    if s.viewer_exact:
        g6 = [g_sig[0][0], g_sig[0][1] + g_sig[1][0],
              g_sig[0][2] + g_sig[2][0], g_sig[1][1],
              g_sig[1][2] + g_sig[2][1], g_sig[2][2]]
        ac6 = c6.abs()
        mx = ac6.amax(dim=-1)
        g_mx = sum(g6[k] * q[:, k].to(torch.float32) for k in range(6)) \
            / 32767.0
        at = ac6 == mx[:, None]
        g_c6 = torch.where(at, (g_mx / at.sum(-1))[:, None], 0.0) \
            * torch.sign(c6)
        up = [[2.0 * g_c6[:, 0], g_c6[:, 1], g_c6[:, 2]],
              [None, 2.0 * g_c6[:, 3], g_c6[:, 4]],
              [None, None, 2.0 * g_c6[:, 5]]]
        gs = [[up[min(i, j)][max(i, j)] for j in range(3)] for i in range(3)]
    else:
        gs = [[g_sig[i][j] + g_sig[j][i] for j in range(3)] for i in range(3)]
    g_m = [[dot(gs[i], [mm[:, 0, k], mm[:, 1, k], mm[:, 2, k]])
            for k in range(3)] for i in range(3)]
    g_scales = torch.stack(
        [dot([g_m[i][k] for i in range(3)],
             [rot[:, i, k] for i in range(3)]) for k in range(3)], dim=-1)
    g = [[g_m[i][k] * scales[:, k] for k in range(3)] for i in range(3)]
    qw, qx, qy, qz = quats.unbind(-1)
    g_quats = 2.0 * torch.stack([
        -qz * g[0][1] + qy * g[0][2] + qz * g[1][0] - qx * g[1][2]
        - qy * g[2][0] + qx * g[2][1],
        qy * g[0][1] + qz * g[0][2] + qy * g[1][0] - 2.0 * qx * g[1][1]
        - qw * g[1][2] + qz * g[2][0] + qw * g[2][1] - 2.0 * qx * g[2][2],
        -2.0 * qy * g[0][0] + qx * g[0][1] + qw * g[0][2] + qx * g[1][0]
        + qz * g[1][2] - qw * g[2][0] + qz * g[2][1] - 2.0 * qy * g[2][2],
        -2.0 * qz * g[0][0] - qw * g[0][1] + qx * g[0][2] + qw * g[1][0]
        - 2.0 * qz * g[1][1] + qy * g[1][2] + qx * g[2][0] + qy * g[2][1],
    ], dim=-1)
    return g_means, g_quats, g_scales, g_colors, g_sh


_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = [_P] * 8 + [_I] * 2 + [_P] * 4 + [_I] * 5 + [ctypes.c_float] \
    + [_P] * 7
_BWD_ARGTYPES = [_P] * 5 + [_I] * 2 + [_P] * 3 + [_I] * 4 \
    + [_P, ctypes.c_longlong] * 4 + [_P] * 6


def _camera_position(mv: torch.Tensor, s: _Setup) -> Optional[torch.Tensor]:
    """-R^T t of the modelview, on its device, as the plain version
    computes it; None where no SH band reads it."""
    if not s.bands:
        return None
    return -matmul_f32(mv[:3, :3].T, mv[:3, 3])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_kernel_bands(s: _Setup) -> None:
    if s.bands not in SH_BANDS:
        raise ValueError(f"the projection kernels take {SH_BANDS} SH bands, "
                         f"got {s.bands}")


def _forward_kernel(means, quats, scales, cov6, max_scales, colors,
                    opacities, sh, mv, pr, cutout, s: _Setup) -> tuple:
    _check_kernel_bands(s)
    n = means.shape[0]
    dev = means.device
    shapes = dict(means=(n, 3), quats=(n, 4), scales=(n, 3), cov6=(n, 6),
                  max_scales=(n,), colors=(n, 3), opacities=(n,),
                  sh=(n, s.bands, 3), modelview=(4, 4), projection=(4, 4),
                  cutout=(4, 4))
    for name, t in zip(shapes, (means, quats, scales, cov6, max_scales,
                                colors, opacities, sh, mv, pr, cutout)):
        if t is not None:
            kernels.check_tensor(t, name, torch.float32, dev)
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {shapes[name]}")
    f32 = dict(dtype=torch.float32, device=dev)
    mean2d = torch.empty((n, 2), **f32)
    conic = torch.empty((n, 3), **f32)
    depth = torch.empty((n,), **f32)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    bbox = torch.empty((n, 2), **f32)
    color = torch.empty((n, 3), **f32) if s.sh_eval else None
    if n:
        campos = _camera_position(mv, s)
        fn = kernels.function("project", "splat_project_fwd", _FWD_ARGTYPES)
        eps = s.support_eps
        with torch.cuda.device(dev):
            err = fn(
                *(_ptr(t) for t in (means, quats, scales, cov6, max_scales,
                                    colors, opacities, sh)),
                s.bands, int(s.sh_eval), mv.data_ptr(), pr.data_ptr(),
                _ptr(cutout), _ptr(campos), n, s.width, s.height,
                int(s.viewer_exact),
                int(eps is not None), 0.0 if eps is None else math.log(eps),
                *(_ptr(t) for t in (mean2d, conic, depth, mask, bbox, color)),
                kernels.stream_of(dev),
            )
        kernels.check_launch("project_fwd", err)
    return (mean2d, conic, depth, mask, bbox,
            *((color,) if s.sh_eval else ()))


def _cotangent(g: Optional[torch.Tensor], shape: tuple) -> tuple:
    """A cotangent as (pointer, row stride, tensor): rows may be strided
    (the views the row pack's backward hands back), elements not."""
    if g is None:
        return None, 0, None
    if tuple(g.shape) != shape:
        raise ValueError(f"cotangent of shape {tuple(g.shape)}, expected "
                         f"{shape}")
    g = g.to(torch.float32)
    if g.dim() > 1 and g.stride(-1) != 1:
        g = g.contiguous()
    return g.data_ptr(), g.stride(0), g


def _backward_kernel(means, quats, scales, colors, sh, mv, pr, s: _Setup,
                     g_mean2d, g_conic, g_depth, g_color) -> tuple:
    _check_kernel_bands(s)
    n = means.shape[0]
    dev = means.device
    g_means = torch.empty_like(means)
    g_quats = torch.empty_like(quats)
    g_scales = torch.empty_like(scales)
    with_color = s.sh_eval and g_color is not None
    g_colors = torch.empty_like(colors) if with_color else None
    g_sh = torch.empty_like(sh) if with_color and s.bands else None
    cots = [_cotangent(g, shape) for g, shape in (
        (g_mean2d, (n, 2)), (g_conic, (n, 3)), (g_depth, (n,)),
        (g_color if with_color else None, (n, 3)))]
    if n:
        campos = _camera_position(mv, s) if with_color else None
        fn = kernels.function("project", "splat_project_bwd", _BWD_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(
                *(_ptr(t) for t in (means, quats, scales, colors, sh)),
                s.bands, int(with_color), mv.data_ptr(), pr.data_ptr(),
                _ptr(campos), n, s.width, s.height, int(s.viewer_exact),
                *(x for c in cots for x in c[:2]),
                *(_ptr(t) for t in (g_means, g_quats, g_scales, g_colors,
                                    g_sh)),
                kernels.stream_of(dev),
            )
        kernels.check_launch("project_bwd", err)
    if with_color and not s.bands:
        g_sh = torch.zeros_like(sh)
    return g_means, g_quats, g_scales, g_colors, g_sh
