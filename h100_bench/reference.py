"""Plain PyTorch reference of the work the benchmark's cells time.

It imports neither the program nor JAX: projection, tile lists, the
front-to-back blend and the training step are written here again, from
the renderer's documented semantics, so that the comparison that decides
``correct`` has a second reading of every number.

* Projection: EWA splatting with the viewer's culls (frustum guard band
  1.2 w, the size cull max_scale * opacity > 1e-4 |z|, the +0.3 dilation,
  eigenvalue clamps lambda2 >= 0.1 and axis length <= 1024 px), real SH up
  to degree 3, and the opacity-aware support ``min(4, ln(opacity / eps))``
  that sizes each gaussian's tile rectangle.
* Tile lists: every (gaussian, tile) pair of those rectangles, front to
  back by camera depth within a tile (ties in gaussian order).
* Blend: alpha = exp(power) * opacity with the exp(-4) cutoff and the
  alpha clip; a tile stops at the first 128-instance chunk (chunks aligned
  to the tile lists' global offsets) at whose start every pixel's
  transmittance is at or below the early stop.
* Rows: the configured row format's rounding (32-byte rows: color and
  opacity to 1/65535; 16-byte rows: the mean to 1/8 px, the conic to
  bfloat16, color to 1/255, opacity to 1/65535), with a straight-through
  gradient.
* Training: L1 + SSIM (11x11 Gaussian window, sigma 1.5), the gradient by
  autograd through a tile-batched recomputation, and Adam.

Everything runs in float32 with TF32 off; ``dtype=torch.bfloat16`` runs
the blend in bfloat16 instead, the control that the comparison has to
reject.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

POWER_CUTOFF = -4.0
SIZE_CULL = 1e-4
FRUSTUM_GUARD = 1.2
CHUNK = 128
MEAN16_STEP = 0.125
MEAN16_BIAS = 2048.0
# (tiles x pixels x list length) elements per blend batch: without and
# with autograd
BATCH_ELEMENTS = 1 << 24
GRAD_BATCH_ELEMENTS = 1 << 22
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LOG_OM_MIN = -60.0


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions inside, the caller's settings
    after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


# -- cameras ------------------------------------------------------------------

def perspective(fov_y_deg: float, aspect: float, near: float = 0.1,
                far: float = 1000.0) -> torch.Tensor:
    f = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    p = torch.zeros((4, 4), dtype=torch.float64)
    p[0, 0] = f / aspect
    p[1, 1] = f
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -2.0 * far * near / (far - near)
    p[3, 2] = -1.0
    return p.float()


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """World -> camera (GL convention, the camera looks down -z)."""
    eye = torch.tensor(eye, dtype=torch.float64)
    fwd = torch.tensor(target, dtype=torch.float64) - eye
    fwd = fwd / fwd.norm()
    right = torch.linalg.cross(fwd, torch.tensor(up, dtype=torch.float64))
    right = right / right.norm()
    true_up = torch.linalg.cross(right, fwd)
    view = torch.eye(4, dtype=torch.float64)
    view[0, :3], view[1, :3], view[2, :3] = right, true_up, -fwd
    view[:3, 3] = -view[:3, :3] @ eye
    return view.float()


@dataclasses.dataclass(frozen=True)
class View:
    modelview: torch.Tensor   # (4, 4) f32
    projection: torch.Tensor  # (4, 4) f32
    width: int
    height: int
    tile: int

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


# -- the scene's activations and covariances -----------------------------------

def activate(raw: dict) -> dict:
    """Raw training leaves -> the rendered scene (exp scales, normalised
    quaternions, sigmoid color and opacity)."""
    q = raw["quats"]
    return dict(
        means=raw["means"],
        scales=torch.exp(raw["log_scales"]),
        quats=q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12),
        colors=torch.sigmoid(raw["colors"]),
        opacities=torch.sigmoid(raw["logit_opacities"]),
        sh=raw.get("sh"),
    )


def covariances(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R(q) diag(s^2) R(q)^T, (N, 3, 3); R from the bilinear
    quaternion formula (so un-normalised quaternions scale it)."""
    w, x, y, z = quats.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(quats.shape[:-1] + (3, 3))
    m = r * scales[..., None, :]
    return (m[..., :, None, :] * m[..., None, :, :]).sum(dim=-1)


_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def sh_color(sh: Optional[torch.Tensor], dc: torch.Tensor,
             dirs: torch.Tensor) -> torch.Tensor:
    """View-dependent color of real SH bands 1-3 over the DC color,
    clamped at 0."""
    out = dc
    if sh is not None and sh.shape[1] > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        xx, yy, zz = x * x, y * y, z * z
        basis = [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x,
                 _SH_C2[0] * x * y, _SH_C2[1] * y * z,
                 _SH_C2[2] * (2 * zz - xx - yy), _SH_C2[3] * x * z,
                 _SH_C2[4] * (xx - yy),
                 _SH_C3[0] * y * (3 * xx - yy), _SH_C3[1] * x * y * z,
                 _SH_C3[2] * y * (4 * zz - xx - yy),
                 _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 _SH_C3[4] * x * (4 * zz - xx - yy),
                 _SH_C3[5] * z * (xx - yy),
                 _SH_C3[6] * x * (xx - 3 * yy)]
        b = torch.cat(basis[:sh.shape[1]], dim=-1)
        out = (dc - 0.5) + (b[:, :, None] * sh).sum(dim=1) + 0.5
    return out.clamp_min(0.0)


# -- projection ----------------------------------------------------------------

@dataclasses.dataclass
class Projected:
    mean2d: torch.Tensor     # (N, 2) pixels, y up
    conic: torch.Tensor      # (N, 3)
    depth: torch.Tensor      # (N,) camera z, negative in front
    mask: torch.Tensor       # (N,) survives every cull
    bbox_half: torch.Tensor  # (N, 2) support half-extent, pixels
    color: torch.Tensor      # (N, 3)
    opacity: torch.Tensor    # (N,)


def project(means, cov3d, colors, opacities, view: View, *,
            max_scales: torch.Tensor, sh=None,
            support_eps: Optional[float] = None) -> Projected:
    dev = means.device
    mv = view.modelview.to(dev)
    pr = view.projection.to(dev)
    w_px, h_px = view.width, view.height
    focal = (h_px / 2.0) * pr[1, 1].abs()
    cam = (means[:, 0:1] * mv[None, :3, 0] + means[:, 1:2] * mv[None, :3, 1]
           + means[:, 2:3] * mv[None, :3, 2] + mv[None, :3, 3])
    clip = (cam[:, 0:1] * pr[None, :3, 0] + cam[:, 1:2] * pr[None, :3, 1]
            + cam[:, 2:3] * pr[None, :3, 2] + pr[None, :3, 3])
    w_clip = (cam[:, 0] * pr[3, 0] + cam[:, 1] * pr[3, 1]
              + cam[:, 2] * pr[3, 2] + pr[3, 3])
    guard = FRUSTUM_GUARD * w_clip
    in_frustum = ((clip[:, 2] >= -w_clip)
                  & (clip[:, 0] >= -guard) & (clip[:, 0] <= guard)
                  & (clip[:, 1] >= -guard) & (clip[:, 1] <= guard))
    x, y, z = cam.unbind(-1)
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    fz = focal / safe_z
    fz2 = focal / (safe_z * safe_z)
    t0 = fz[:, None] * mv[None, 0, :3] - (x * fz2)[:, None] * mv[None, 2, :3]
    t1 = -fz[:, None] * mv[None, 1, :3] + (y * fz2)[:, None] * mv[None, 2, :3]
    u0 = (cov3d * t0[:, None, :]).sum(dim=-1)
    u1 = (cov3d * t1[:, None, :]).sum(dim=-1)
    a = (t0 * u0).sum(dim=-1) + 0.3
    b = (t1 * u0).sum(dim=-1)
    c = (t1 * u1).sum(dim=-1) + 0.3
    mid = 0.5 * (a + c)
    r2 = ((a - c) / 2.0).square() + b.square()
    pos = r2 > 0.0
    radius = torch.where(pos, torch.where(pos, r2, torch.ones_like(r2)).sqrt(),
                         torch.zeros_like(r2))
    lam1 = mid + radius
    lam2 = torch.clamp_min(mid - radius, 0.1)
    vx, vy = b, lam1 - a
    v2 = vx * vx + vy * vy
    ok = v2 > 1e-24
    vn = torch.where(ok, v2, torch.ones_like(v2)).sqrt()
    dvx = torch.where(ok, vx / vn, torch.ones_like(vx))
    dvy = torch.where(ok, vy / vn, torch.zeros_like(vy))
    len1 = torch.clamp_max((2.0 * lam1).sqrt(), 1024.0)
    len2 = torch.clamp_max((2.0 * lam2.clamp_min(0.0)).sqrt(), 1024.0)
    lam1e = 0.5 * len1 * len1
    lam2e = torch.clamp_min(0.5 * len2 * len2, 1e-8)
    inv1 = 1.0 / torch.clamp_min(lam1e, 1e-8)
    inv2 = 1.0 / lam2e
    conic = torch.stack([inv1 * dvx * dvx + inv2 * dvy * dvy,
                         (inv1 - inv2) * dvx * dvy,
                         inv1 * dvy * dvy + inv2 * dvx * dvx], dim=-1)
    safe_w = torch.where(w_clip.abs() < 1e-8, torch.full_like(w_clip, 1e-8),
                         w_clip)
    ndc = clip[:, :2] / safe_w[:, None]
    mean2d = torch.stack([(ndc[:, 0] + 1.0) * (w_px / 2.0),
                          (ndc[:, 1] + 1.0) * (h_px / 2.0)], dim=-1)
    with torch.no_grad():
        cxx = lam1e * dvx * dvx + lam2e * dvy * dvy
        cyy = lam1e * dvy * dvy + lam2e * dvx * dvx
        bbox = torch.stack([(8.0 * cxx.clamp_min(0.0)).sqrt(),
                            (8.0 * cyy.clamp_min(0.0)).sqrt()], dim=-1)
        if support_eps is not None and support_eps > 0.0:
            t_eff = torch.clamp(opacities.clamp_min(1e-30).log()
                                - math.log(support_eps), 0.0, 4.0)
            shrink = torch.where(t_eff > 0.0, (t_eff * 0.25).sqrt(),
                                 torch.zeros_like(t_eff))
            bbox = bbox * shrink[:, None]
    mask = in_frustum & (z < 0.0) & (max_scales * opacities > SIZE_CULL * (-z))
    color = colors
    if sh is not None:
        cam_pos = -(mv[:3, :3] * mv[:3, 3][:, None]).sum(dim=0)
        dirs = means - cam_pos
        dirs = dirs / torch.linalg.norm(dirs, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
        color = sh_color(sh, colors, dirs)
    return Projected(mean2d, conic, z, mask, bbox, color, opacities)


def project_scene(scene: dict, view: View, *, support_eps) -> Projected:
    return project(scene["means"],
                   covariances(scene["quats"], scene["scales"]),
                   scene["colors"], scene["opacities"], view,
                   max_scales=scene["scales"].amax(dim=-1),
                   sh=scene.get("sh"), support_eps=support_eps)


def features(p: Projected) -> torch.Tensor:
    """(N, 9): mean x, y, conic a, b, c, r, g, b, opacity (0 if culled)."""
    opa = torch.where(p.mask, p.opacity, torch.zeros_like(p.opacity))
    return torch.cat([p.mean2d, p.conic, p.color, opa[:, None]], dim=-1)


def _straight(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def _unit16(x):
    return torch.floor(x.clamp(0.0, 1.0) * 65535.0 + 0.5) * (1.0 / 65535.0)


def rows_rounding(feat: torch.Tensor, rows: Optional[str]) -> torch.Tensor:
    """The configured row format's rounding of (N, 9) features: "32"
    (color and opacity to 1/65535), "16" (mean to 1/8 px, conic bfloat16,
    color 1/255, opacity 1/65535) or None (float32 throughout)."""
    if rows is None:
        return feat
    if rows == "32":
        q = torch.cat([feat[:, :5], _unit16(feat[:, 5:9])], dim=1)
    elif rows == "16":
        mean = (torch.floor((feat[:, :2] + MEAN16_BIAS) / MEAN16_STEP + 0.5)
                .clamp(0.0, 65535.0) * MEAN16_STEP - MEAN16_BIAS)
        conic = feat[:, 2:5].to(torch.bfloat16).float()
        col = torch.floor(feat[:, 5:8].clamp(0.0, 1.0) * 255.0 + 0.5) \
            * (1.0 / 255.0)
        q = torch.cat([mean, conic, col, _unit16(feat[:, 8:9])], dim=1)
    else:
        raise ValueError(f"rows must be '32', '16' or None, got {rows!r}")
    return _straight(feat, q)


# -- tile lists ------------------------------------------------------------------

@dataclasses.dataclass
class Lists:
    """Every (gaussian, tile) pair, tile-major, front to back in a tile."""

    gid: torch.Tensor      # (K,) long
    starts: torch.Tensor   # (T,) long, global offset of each tile's list
    counts: torch.Tensor   # (T,) long

    @property
    def total(self) -> int:
        return int(self.gid.shape[0])


def tile_counts(p: Projected, view: View):
    """Each gaussian's tile rectangle and pair count (0 if culled or off
    screen)."""
    t = view.tile
    mx, my = p.mean2d[:, 0].detach(), p.mean2d[:, 1].detach()
    bx, by = p.bbox_half[:, 0], p.bbox_half[:, 1]
    x0 = torch.floor((mx - bx) / t).long()
    x1 = torch.floor((mx + bx) / t).long()
    y0 = torch.floor((my - by) / t).long()
    y1 = torch.floor((my + by) / t).long()
    off = (x1 < 0) | (x0 >= view.tiles_x) | (y1 < 0) | (y0 >= view.tiles_y)
    x0 = x0.clamp(0, view.tiles_x - 1)
    x1 = x1.clamp(0, view.tiles_x - 1)
    y0 = y0.clamp(0, view.tiles_y - 1)
    y1 = y1.clamp(0, view.tiles_y - 1)
    keep = p.mask & ~off
    count = torch.where(keep, (x1 - x0 + 1) * (y1 - y0 + 1),
                        torch.zeros_like(x0))
    return x0, y0, x1 - x0 + 1, count


def demand(p: Projected, view: View) -> int:
    """Pairs the view needs: the instance capacity it takes."""
    return int(tile_counts(p, view)[3].sum())


def tile_lists(p: Projected, view: View) -> Lists:
    x0, y0, spanw, count = tile_counts(p, view)
    dev = count.device
    key = torch.where(count > 0, -p.depth.detach(),
                      torch.full_like(p.depth, math.inf))
    order = torch.sort(key, stable=True).indices
    order = order[count[order] > 0]
    cnt = count[order]
    total = int(cnt.sum())
    gid = torch.repeat_interleave(order, cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(total, device=dev) - torch.repeat_interleave(
        first, cnt, output_size=total)
    sw = spanw[gid]
    tile = (y0[gid] + local // sw) * view.tiles_x + x0[gid] + local % sw
    by_tile = torch.sort(tile, stable=True).indices
    counts = torch.bincount(tile, minlength=view.num_tiles)
    return Lists(gid[by_tile], torch.cumsum(counts, 0) - counts, counts)


# -- the blend -----------------------------------------------------------------

def _batches(lists: Lists, pixels: int, budget: int):
    """Tiles with a list, deepest first, in groups of at most ``budget``
    (tiles x pixels x padded length) elements."""
    counts = lists.counts
    tiles = torch.argsort(counts, descending=True, stable=True)
    n_live = int((counts > 0).sum())
    lengths = counts[tiles[:n_live]].tolist()
    out, i = [], 0
    while i < n_live:
        length = lengths[i]
        b = max(1, budget // (pixels * length))
        out.append((tiles[i:i + b], length))
        i += b
    return out


def _pixel_basis(tile: int, dev):
    pix = torch.arange(tile * tile, device=dev)
    x = (pix % tile).float() + 0.5 - 0.5 * tile
    y = (pix // tile).float() + 0.5 - 0.5 * tile
    return x, y


def _blend(feat, lists: Lists, view: View, tiles, length, *, alpha_clip,
           early_stop, dtype, walked=None):
    """Blend one batch of tiles. Returns rgb (B, P, 3), log T (B, P), the
    walked mask (B, L), the in-list mask (B, L) and each pixel's needed
    depth (B, P)."""
    dev = feat.device
    t = view.tile
    st = lists.starts[tiles]
    j = torch.arange(length, device=dev)
    inl = j[None, :] < lists.counts[tiles][:, None]
    pos = (st[:, None] + j[None, :]).clamp(max=max(lists.total - 1, 0))
    f = feat[lists.gid[pos]]                                  # (B, L, 9)
    ox = (tiles % view.tiles_x).float() * t + 0.5 * t
    oy = (tiles // view.tiles_x).float() * t + 0.5 * t
    mxl = f[..., 0] - ox[:, None]
    myl = f[..., 1] - oy[:, None]
    ca, cb, cc = f[..., 2], f[..., 3], f[..., 4]
    lnopa = f[..., 8].clamp_min(1e-30).log()
    coef = (-0.5 * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + lnopa,
            ca * mxl + cb * myl, cc * myl + cb * mxl,
            -0.5 * ca, -cb, -0.5 * cc)
    x, y = _pixel_basis(t, dev)
    basis = (x, y, x * x, x * y, y * y)
    coef = [c.to(dtype) for c in coef]
    power = coef[0][:, None, :]
    for cf, bs in zip(coef[1:], basis):
        power = power + cf[:, None, :] * bs.to(dtype)[None, :, None]
    valid = (power >= (lnopa.to(dtype) + POWER_CUTOFF)[:, None, :]) \
        & inl[:, None, :]
    if alpha_clip is not None:
        # the log of the float32-rounded clip
        clip = torch.tensor(alpha_clip, dtype=torch.float32).item()
        power = torch.clamp_max(power, math.log(clip))
    zero = torch.zeros((), dtype=dtype, device=dev)
    alpha = torch.where(valid, power.exp(), zero)
    # where the clip rounds to 1 in the working precision, log(1 - alpha)
    # is floored, as the renderer floors it for a clip that does not bound
    # alpha below 1
    s = torch.log1p(-alpha).clamp_min(LOG_OM_MIN)
    s_excl = torch.cumsum(s, dim=2) - s
    log_eps = math.log(early_stop) if early_stop > 0 else -math.inf
    need = ((s_excl > log_eps) & inl[:, None, :]).sum(dim=2)
    if walked is not None:
        walked = walked[pos] & inl
    else:
        with torch.no_grad():
            first = ((st[:, None] + j[None, :]) // CHUNK * CHUNK
                     - st[:, None]).clamp_min(0)
            at_chunk = s_excl.detach().gather(
                2, first[:, None, :].expand(-1, s.shape[1], -1))
            walked = (at_chunk.amax(dim=1) > log_eps) & inl
    keep = valid & walked[:, None, :]
    w = torch.where(keep, (s_excl + power).exp(), zero)
    col = f[..., 5:8].to(dtype)
    rgb = torch.bmm(w.float(), col.float()) if dtype == torch.float32 \
        else torch.bmm(w, col).float()
    log_t = torch.where(keep, s, zero).sum(dim=2).float()
    return rgb, log_t, walked, inl, need


@dataclasses.dataclass
class Blend:
    image: torch.Tensor           # (H, W, 4), row 0 on top
    walked: torch.Tensor          # (K,) bool: list entries walked
    fragments: int                # sum over pixels of the needed depth
    instances: int                # sum over tiles of the deepest need
    walked_instances: int         # instances in walked chunks
    listed: int                   # pairs in the lists


def _tiles_to_image(out: torch.Tensor, view: View) -> torch.Tensor:
    t = view.tile
    x = out.reshape(view.tiles_y, view.tiles_x, t, t, 4)
    x = x.permute(0, 2, 1, 3, 4).reshape(view.tiles_y * t,
                                         view.tiles_x * t, 4)
    return x[:view.height, :view.width].flip(0).contiguous()


def _image_to_tiles(img: torch.Tensor, view: View) -> torch.Tensor:
    t = view.tile
    x = F.pad(img.flip(0), (0, 0, 0, view.tiles_x * t - view.width,
                            0, view.tiles_y * t - view.height))
    x = x.reshape(view.tiles_y, t, view.tiles_x, t, -1).permute(0, 2, 1, 3, 4)
    return x.reshape(view.num_tiles, t * t, -1)


def blend(feat: torch.Tensor, lists: Lists, view: View, *, alpha_clip,
          early_stop, dtype=torch.float32) -> Blend:
    """The image of (N, 9) features over ``lists``, and the work it
    needs."""
    p_n = view.tile * view.tile
    dev = feat.device
    out = torch.zeros((view.num_tiles, p_n, 4), dtype=torch.float32,
                      device=dev)
    out[..., 3] = 1.0
    walked_all = torch.zeros((lists.total,), dtype=torch.bool, device=dev)
    frags = inst = 0
    with torch.no_grad(), no_tf32():
        for tiles, length in _batches(lists, p_n, BATCH_ELEMENTS):
            rgb, log_t, walked, inl, need = _blend(
                feat, lists, view, tiles, length, alpha_clip=alpha_clip,
                early_stop=early_stop, dtype=dtype)
            out[tiles, :, :3] = rgb
            out[tiles, :, 3] = log_t.exp()
            pos = lists.starts[tiles][:, None] + torch.arange(
                length, device=dev)[None, :]
            walked_all[pos[inl]] = walked[inl]
            frags += int(need.sum())
            inst += int(need.amax(dim=1).sum())
    out[..., 3] = 1.0 - out[..., 3]
    return Blend(_tiles_to_image(out, view), walked_all, frags, inst,
                 int(walked_all.sum()), lists.total)


def blend_backward(feat_leaf: torch.Tensor, lists: Lists, view: View,
                   done: Blend, g_image: torch.Tensor, *, alpha_clip,
                   early_stop, dtype=torch.float32) -> None:
    """Accumulate d loss / d features into ``feat_leaf.grad`` from the
    image cotangent ``g_image`` (H, W, 4; only RGB is used), recomputing
    each batch of ``done`` with autograd over the chunks it walked."""
    p_n = view.tile * view.tile
    g_tiles = _image_to_tiles(g_image[..., :3], view)
    with no_tf32():
        for tiles, length in _batches(lists, p_n, GRAD_BATCH_ELEMENTS):
            rgb = _blend(feat_leaf, lists, view, tiles, length,
                         alpha_clip=alpha_clip, early_stop=early_stop,
                         dtype=dtype, walked=done.walked)[0]
            rgb.backward(g_tiles[tiles])


# -- loss and the training step -----------------------------------------------

def _window(size=11, sigma=1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _blur(x, win):
    return F.conv2d(x.permute(2, 0, 1)[:, None], win[None, None])[:, 0] \
        .permute(1, 2, 0)


def loss_fn(pred: torch.Tensor, target: torch.Tensor,
            ssim_weight: float) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM) on RGB."""
    p, t = pred[..., :3], target[..., :3]
    l1 = (p - t).abs().mean()
    win = _window(device=p.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m1, m2 = _blur(p, win), _blur(t, win)
    s1 = _blur(p * p, win) - m1 * m1
    s2 = _blur(t * t, win) - m2 * m2
    s12 = _blur(p * t, win) - m1 * m2
    ssim = ((2 * m1 * m2 + c1) * (2 * s12 + c2)
            / ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2))).mean()
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim)


def render(scene: dict, view: View, *, rows, alpha_clip, early_stop,
           dtype=torch.float32, lists_view: Optional[View] = None) -> Blend:
    """A frame: lists from ``lists_view`` (default ``view``), projection
    and blend under ``view``."""
    with torch.no_grad():
        at = project_scene(scene, lists_view or view, support_eps=early_stop)
        lists = tile_lists(at, lists_view or view)
        p = at if lists_view is None else project_scene(scene, view,
                                                         support_eps=None)
        feat = rows_rounding(features(p), rows)
        return blend(feat, lists, view, alpha_clip=alpha_clip,
                     early_stop=early_stop, dtype=dtype)


class Adam:
    """Adam with one learning rate per leaf (torch's update, written
    out)."""

    def __init__(self, lrs: dict):
        self.lrs = lrs
        self.m, self.v, self.t = {}, {}, 0

    def step(self, raw: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = ADAM_BETAS
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m.get(k, torch.zeros_like(g)).mul(b1).add(
                    g, alpha=1.0 - b1)
                v = self.v.get(k, torch.zeros_like(g)).mul(b2).addcmul(
                    g, g, value=1.0 - b2)
                self.m[k], self.v[k] = m, v
                raw[k].sub_(self.lrs[k] / c1 * m
                            / (v.sqrt() / math.sqrt(c2) + ADAM_EPS))


def train_step(raw: dict, adam: Adam, view: View, target: torch.Tensor, *,
               rows, alpha_clip, early_stop, ssim_weight,
               dtype=torch.float32, rows_in_loss: Optional[int] = None):
    """One step on the raw leaves (updated in place). Returns the loss,
    each leaf's gradient and the step's blend. ``rows_in_loss`` takes the
    loss over the image's first rows only (a planted fault)."""
    leaves = {k: v.detach().requires_grad_() for k, v in raw.items()
              if v is not None}
    scene = activate(leaves)
    p = project_scene(scene, view, support_eps=early_stop)
    with torch.no_grad():
        lists = tile_lists(p, view)
    feat = rows_rounding(features(p), rows)
    done = blend(feat.detach(), lists, view, alpha_clip=alpha_clip,
                 early_stop=early_stop, dtype=dtype)
    img = done.image.requires_grad_()
    keep = slice(None, rows_in_loss)
    with no_tf32():
        loss = loss_fn(img[keep], target[keep], ssim_weight)
        loss.backward()
    leaf = feat.detach().requires_grad_()
    blend_backward(leaf, lists, view, done, img.grad, alpha_clip=alpha_clip,
                   early_stop=early_stop, dtype=dtype)
    feat.backward(leaf.grad)
    grads = {k: v.grad for k, v in leaves.items()}
    adam.step(raw, grads)
    return float(loss.detach()), grads, done
