"""Independent NumPy transcription of the WebGL viewer math, for tests and
the chip smoke run (a float64 copy of ``splatjax/reference/viewer_math.py``).

This module deliberately mirrors the reference *structurally* — scalar
per-splat loops, GLSL column-major matrix constructors, THREE quaternion
handling (index.js:101-164 vertex shader, 328-402 pushDataBuffer, 507-567
worker) — so it can serve as a differential oracle for the vectorized
torch implementation in :mod:`splatjax_torch.ops.projection` and the CUDA
kernels behind :func:`splatjax_torch.render.render`. It stays scalar NumPy
on purpose: an oracle that shares the port's vectorised code would share
its faults. Never used in the hot path.

Inputs here are the *raw .splat row fields* (positions as stored, stored-order
quaternion bytes), exercising the full load->render chain.
"""
from __future__ import annotations

import numpy as np


def three_quat_to_rotmat(x: float, y: float, z: float, w: float) -> np.ndarray:
    """THREE.Matrix4.makeRotationFromQuaternion (upper 3x3, math layout)."""
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ],
        dtype=np.float64,
    )


def push_data_buffer_math(raw_rows: np.ndarray):
    """pushDataBuffer per-splat math (index.js:343-402).

    raw_rows: (N, 32) uint8 .splat rows. Returns dict with the quantities the
    viewer stores: centers (z-negated), int16-quantized covariance + scale,
    colors, opacities, sort metric (max_scale * alpha).
    """
    n = raw_rows.shape[0]
    floats = raw_rows[:, :24].copy().view("<f4").reshape(n, 6)
    centers = np.empty((n, 3), np.float64)
    cov6_q = np.empty((n, 6), np.int16)
    quant_scale = np.empty((n,), np.float64)
    sort_metric = np.empty((n,), np.float64)
    for i in range(n):
        b = raw_rows[i]
        # THREE.Quaternion(x, y, z, w) mapping, index.js:344-349
        qx = (float(b[29]) - 128.0) / 128.0
        qy = (float(b[30]) - 128.0) / 128.0
        qz = -(float(b[31]) - 128.0) / 128.0
        qw = (float(b[28]) - 128.0) / 128.0
        center = np.array(
            [floats[i, 0], floats[i, 1], -floats[i, 2]], np.float64
        )  # :350-354
        scale = floats[i, 3:6].astype(np.float64)

        rot = three_quat_to_rotmat(qx, qy, qz, qw)
        m = rot.T @ np.diag(scale)       # mtx.transpose(); mtx.scale(scale)
        sigma = m @ m.T                  # premultiply by clone: M M^T, :361-367

        # column-major flat indices [0,1,2,5,6,10] -> (00,10,20,11,21,22)
        cov6 = np.array(
            [
                sigma[0, 0], sigma[1, 0], sigma[2, 0],
                sigma[1, 1], sigma[2, 1], sigma[2, 2],
            ]
        )
        max_value = np.max(np.abs(cov6))
        safe = max_value if max_value > 0 else 1.0
        cov6_q[i] = np.trunc(cov6 * 32767.0 / safe).astype(np.int16)  # parseInt
        quant_scale[i] = max_value / 32767.0
        centers[i] = center
        sort_metric[i] = np.max(scale) * (float(b[27]) / 255.0)  # :396-397
    return dict(
        centers=centers,
        cov6_q=cov6_q,
        quant_scale=quant_scale,
        colors=raw_rows[:, 24:27].astype(np.float64) / 255.0,
        opacities=raw_rows[:, 27].astype(np.float64) / 255.0,
        sort_metric=sort_metric,
    )


def vertex_shader_math(
    center: np.ndarray,
    cov6: np.ndarray,
    modelview: np.ndarray,
    projection: np.ndarray,
    viewport: tuple[float, float],
    focal: float,
):
    """One splat through the vertex shader (index.js:101-164).

    Returns None if frustum-culled, else (ndc_center, v1, v2, depth_ndc).
    cov6 in the packed order (M11, M12, M13, M22, M23, M33) == (00,10,20,11,21,22).
    """
    mv = np.asarray(modelview, np.float64)
    pr = np.asarray(projection, np.float64)
    camspace = mv @ np.array([center[0], center[1], center[2], 1.0])
    pos2d = pr @ camspace

    bounds = 1.2 * pos2d[3]
    if (
        pos2d[2] < -pos2d[3]
        or pos2d[0] < -bounds or pos2d[0] > bounds
        or pos2d[1] < -bounds or pos2d[1] > bounds
    ):
        return None

    m11, m12, m13, m22, m23, m33 = [float(v) for v in cov6]
    vrk = np.array(
        [[m11, m12, m13], [m12, m22, m23], [m13, m23, m33]], np.float64
    )
    # GLSL mat3 column-major constructor, index.js:127-131
    j = np.zeros((3, 3))
    j[:, 0] = [focal / camspace[2], 0.0, -(focal * camspace[0]) / camspace[2] ** 2]
    j[:, 1] = [0.0, -focal / camspace[2], (focal * camspace[1]) / camspace[2] ** 2]
    w = mv[:3, :3].T
    t = w @ j
    cov = t.T @ vrk @ t

    diag1 = cov[0, 0] + 0.3
    off = cov[1, 0]  # GLSL cov[0][1] = column 0 row 1
    diag2 = cov[1, 1] + 0.3
    mid = 0.5 * (diag1 + diag2)
    radius = np.hypot((diag1 - diag2) / 2.0, off)
    lam1 = mid + radius
    lam2 = max(mid - radius, 0.1)
    dvec = np.array([off, lam1 - diag1])
    nrm = np.linalg.norm(dvec)
    dvec = dvec / nrm if nrm > 0 else np.array([1.0, 0.0])
    v1 = min(np.sqrt(2.0 * lam1), 1024.0) * dvec
    v2 = min(np.sqrt(2.0 * lam2), 1024.0) * np.array([dvec[1], -dvec[0]])

    ndc_center = pos2d[:2] / pos2d[3]
    return ndc_center, v1, v2, pos2d[2] / pos2d[3]


def fragment_alpha(u: float, v: float, opacity: float) -> float:
    """Fragment shader (index.js:170-175): quad coords (u, v) in [-2, 2]."""
    a = -(u * u + v * v)
    if a < -4.0:
        return 0.0
    return float(np.exp(a)) * opacity


def splat_alpha_at_pixel(
    ndc_center, v1, v2, pixel_xy_up, viewport, opacity
) -> float:
    """Alpha of one splat at a pixel center (y-up frame), via the quad
    parameterization: pixel_offset = u * v2 + v * v1 (index.js:160-163)."""
    w_px, h_px = viewport
    cx = (ndc_center[0] + 1.0) * w_px / 2.0
    cy = (ndc_center[1] + 1.0) * h_px / 2.0
    d = np.array([pixel_xy_up[0] - cx, pixel_xy_up[1] - cy])
    m = np.array([[v2[0], v1[0]], [v2[1], v1[1]]])
    det = np.linalg.det(m)
    if abs(det) < 1e-12:
        return 0.0
    uv = np.linalg.solve(m, d)
    if np.max(np.abs(uv)) > 2.0:  # outside the quad: never rasterized
        return 0.0
    return fragment_alpha(uv[0], uv[1], opacity)


def worker_sort_cull(
    centers: np.ndarray,
    sort_metric: np.ndarray,
    modelview: np.ndarray,
    cutout: np.ndarray | None = None,
):
    """Worker depth cull + 16-bit counting sort (index.js:507-567).

    Returns far-to-near index list (uint32), exactly bucketed like the worker.
    """
    view = np.asarray(modelview, np.float64)[2, :]  # row 2: [m2, m6, m10, m14]
    depths, valid = [], []
    for i in range(centers.shape[0]):
        depth = (
            view[0] * centers[i, 0]
            + view[1] * centers[i, 1]
            + view[2] * centers[i, 2]
            + view[3]
        )
        keep = depth < 0 and sort_metric[i] > -0.0001 * depth
        if keep and cutout is not None:
            p = np.array([centers[i, 0], -centers[i, 1], centers[i, 2], 1.0])
            h = np.asarray(cutout, np.float64) @ p
            q = h[:3] / h[3]
            if np.any(np.abs(q) > 0.5):
                keep = False
        if keep:
            depths.append(depth)
            valid.append(i)
    if not valid:
        return np.zeros((0,), np.uint32)
    depths = np.array(depths)
    dmin, dmax = depths.min(), depths.max()
    inv = (256 * 256 - 1) / (dmax - dmin) if dmax > dmin else 0.0
    buckets = ((depths - dmin) * inv).astype(np.int64)
    order = np.argsort(buckets, kind="stable")
    return np.array(valid, np.uint32)[order]


def viewer_render(raw_rows: np.ndarray, modelview, projection, width: int,
                  height: int, cutout: np.ndarray | None = None
                  ) -> np.ndarray:
    """The viewer's whole pipeline, one splat and one pixel at a time:
    pushDataBuffer, the worker's cull and counting sort (far to near), the
    vertex shader, the fragment alpha at every pixel center and WebGL's
    back-to-front "over" blending (index.js:170-181). Returns an
    (H, W, 4) float64 RGBA image, row 0 on top.

    splatjax composes these steps inside its test
    (tests/test_reference_rasterizer.py); the port keeps the composition
    here so that its tests and the chip smoke run share one oracle."""
    viewer = push_data_buffer_math(raw_rows)
    mv = np.asarray(modelview, np.float64)
    pr = np.asarray(projection, np.float64)
    focal = (height / 2.0) * abs(pr[1, 1])
    order = worker_sort_cull(viewer["centers"], viewer["sort_metric"], mv,
                             cutout=cutout)
    img = np.zeros((height, width, 4))  # y-up rows; flipped at the end
    for idx in order:  # far to near
        i = int(idx)
        cov6 = viewer["cov6_q"][i].astype(np.float64) * viewer["quant_scale"][i]
        out = vertex_shader_math(
            viewer["centers"][i], cov6, mv, pr, (width, height), focal
        )
        if out is None:
            continue
        ndc_center, v1, v2, _ = out
        color = viewer["colors"][i]
        opacity = viewer["opacities"][i]
        for iy in range(height):
            for ix in range(width):
                a = splat_alpha_at_pixel(
                    ndc_center, v1, v2,
                    (ix + 0.5, iy + 0.5), (width, height), opacity,
                )
                if a <= 0.0:
                    continue
                # gl blend: rgb = src*a + dst*(1-a); alpha = src + dst*(1-a)
                img[iy, ix, :3] = color * a + img[iy, ix, :3] * (1 - a)
                img[iy, ix, 3] = a + img[iy, ix, 3] * (1 - a)
    return img[::-1]
