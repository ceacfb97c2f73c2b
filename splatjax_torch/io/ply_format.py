"""3DGS ``.ply`` loader and saver (the port's own copy of
``splatjax/io/ply_format.py``; parsing is NumPy on the host, the scene is
placed on the caller's device).

Mirrors the reference viewer's processPlyBuffer:
  * binary-little-endian ply, the header parsed for per-property offsets
    and types (``_PLY_DTYPES``; an unknown type reads as int8, as the
    viewer's type map falls back to getInt8);
  * importance = exp(scale_0) exp(scale_1) exp(scale_2) sigmoid(opacity),
    splats sorted by it, descending and stable, so a capacity cut keeps the
    most visible ones;
  * activations: scales = exp(scale_k), color = 0.5 + SH_C0 f_dc_k or raw
    red/green/blue over 255, opacity = sigmoid;
  * the quaternion (rot_0..rot_3) normalized, stored as (w, x, y, z);
  * fallbacks for missing fields: scale 0.01, the identity quaternion,
    color 0.5, alpha 1.

Then the .splat loader's coordinate mapping (Z negated, quaternion
conjugated). Higher SH bands (``f_rest_*``), which the viewer discards, are
kept as (N, K, 3), their z-odd coefficients negated for the Z reflection.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

import numpy as np
import torch

from splatjax_torch.scene import GaussianScene, scene_from_numpy

SH_C0 = 0.28209479177387814

# The framework maps 3DGS world space through the viewer's Z reflection.
# Real SH basis functions that are odd in z flip sign under z -> -z, so
# their coefficients are negated on load (and again on save). Within the
# (N, K, 3) band layout (bands 1..3, DC excluded) the z-odd indices are:
#   band 1: z -> 1;  band 2: yz, xz -> 4, 6;
#   band 3: xyz, z(2z^2-3x^2-3y^2), z(x^2-y^2) -> 9, 11, 13
_SH_Z_ODD = (1, 4, 6, 9, 11, 13)

_PLY_DTYPES = {
    "double": "<f8",
    "int": "<i4",
    "uint": "<u4",
    "float": "<f4",
    "short": "<i2",
    "ushort": "<u2",
    "uchar": "u1",
    "char": "i1",
}


def _flip_sh_z(sh: np.ndarray) -> np.ndarray:
    """A copy of (N, K, 3) ``sh`` with the z-odd coefficients negated."""
    sh = sh.copy()
    for i in _SH_Z_ODD:
        if i < sh.shape[1]:
            sh[:, i, :] = -sh[:, i, :]
    return sh


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def parse_ply_arrays(data: bytes, *, max_sh_degree: int = 3,
                     importance_sort: bool = True
                     ) -> dict[str, Optional[np.ndarray]]:
    """Parse .ply bytes into numpy float32 arrays keyed like the scene
    fields (``sh`` is None without ``f_rest_*`` or at degree 0)."""
    header_end = b"end_header\n"
    idx = data.find(header_end)
    if idx < 0:
        raise ValueError("Unable to read .ply file header")
    header = data[:idx].decode("ascii", errors="replace")
    m = re.search(r"element vertex (\d+)", header)
    if not m:
        raise ValueError("missing 'element vertex' in .ply header")
    n = int(m.group(1))

    fields: list[tuple[str, str]] = []
    for line in header.split("\n"):
        line = line.strip()
        if line.startswith("property "):
            parts = line.split(" ")
            if parts[1] == "list":
                raise ValueError("list properties unsupported for 3DGS ply")
            fields.append((parts[2], _PLY_DTYPES.get(parts[1], "i1")))
    dtype = np.dtype([(name, dt) for name, dt in fields])
    body = np.frombuffer(data, dtype=dtype, count=n,
                         offset=idx + len(header_end))
    names = set(dtype.names or ())

    def col(name: str) -> np.ndarray:
        return body[name].astype(np.float32)

    positions = np.stack([col("x"), col("y"), col("z")], axis=-1)

    if "scale_0" in names:
        scales = np.exp(np.stack(
            [col("scale_0"), col("scale_1"), col("scale_2")], axis=-1))
        q = np.stack([col(f"rot_{i}") for i in range(4)], axis=-1)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    else:
        scales = np.full((n, 3), 0.01, dtype=np.float32)
        q = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32),
                    (n, 1))

    if "f_dc_0" in names:
        colors = 0.5 + SH_C0 * np.stack(
            [col("f_dc_0"), col("f_dc_1"), col("f_dc_2")], axis=-1)
    elif "red" in names:
        colors = np.stack([col("red"), col("green"), col("blue")],
                          axis=-1) / 255.0
    else:
        colors = np.full((n, 3), 0.5, dtype=np.float32)

    if "opacity" in names:
        opacities = _sigmoid(col("opacity"))
    else:
        opacities = np.ones((n,), dtype=np.float32)

    sh = None
    if max_sh_degree > 0:
        n_rest = sum(1 for f in names if f.startswith("f_rest_"))
        if n_rest > 0:
            per_chan = n_rest // 3
            keep = min(per_chan, (max_sh_degree + 1) ** 2 - 1)
            rest = np.stack(
                [col(f"f_rest_{i}") for i in range(n_rest)], axis=-1
            ).reshape(n, 3, per_chan)  # 3DGS ply stores channel-major
            sh = np.transpose(rest[:, :, :keep], (0, 2, 1)).astype(
                np.float32)
            sh = _flip_sh_z(sh)

    if importance_sort and "scale_0" in names:
        importance = scales.prod(axis=-1) * opacities
        order = np.argsort(-importance, kind="stable")
        positions, scales, q = positions[order], scales[order], q[order]
        colors, opacities = colors[order], opacities[order]
        if sh is not None:
            sh = sh[order]

    positions = positions * np.array([1.0, 1.0, -1.0], dtype=np.float32)
    quats = np.stack([q[:, 0], -q[:, 1], -q[:, 2], q[:, 3]], axis=-1)
    return dict(
        means=positions.astype(np.float32),
        scales=scales.astype(np.float32),
        quats=quats.astype(np.float32),
        colors=np.clip(colors, 0.0, None).astype(np.float32),
        opacities=opacities.astype(np.float32),
        sh=sh,
    )


def parse_ply_bytes(data: bytes, *, max_sh_degree: int = 3,
                    importance_sort: bool = True, device="cuda"
                    ) -> GaussianScene:
    """Parse 3DGS .ply bytes into a scene on ``device``."""
    return scene_from_numpy(
        parse_ply_arrays(data, max_sh_degree=max_sh_degree,
                         importance_sort=importance_sort), device)


def load_ply(path: Union[str, os.PathLike], backend: str = "auto", *,
             device="cuda", **kw) -> GaussianScene:
    """Load a 3DGS .ply onto ``device``. backend: "numpy" (also what
    "auto" takes: the semantics of record); "native" (the C++ converter,
    built at first use; raises if it cannot be built). The native
    converter's scales and opacities can differ from NumPy's by a few
    ulps (the C library's ``expf``), which can swap near-tied splats in
    the importance order, so "auto" never takes it: a .ply loads the same
    whatever is built."""
    with open(path, "rb") as f:
        data = f.read()
    if backend == "native":
        from splatjax_torch.io import native

        if not (native.available() or native.ensure_built()):
            raise RuntimeError("native ingestion library unavailable")
        return native.parse_ply_bytes_native(data, device=device, **kw)
    return parse_ply_bytes(data, device=device, **kw)


def save_ply(path: Union[str, os.PathLike], scene: GaussianScene) -> None:
    """Write a standard 3DGS binary ply (inverse activations); the bytes
    are splatjax's for the same scene."""
    def host(t):
        return None if t is None else t.detach().to(
            "cpu", torch.float32).numpy()

    means = host(scene.means) * np.array([1, 1, -1], np.float32)
    scales, quats = host(scene.scales), host(scene.quats)
    colors, opac = host(scene.colors), host(scene.opacities)
    sh = host(scene.sh)
    n = means.shape[0]

    qn = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True),
                            1e-12)
    stored_q = np.stack([qn[:, 0], -qn[:, 1], -qn[:, 2], qn[:, 3]], axis=-1)
    log_scales = np.log(np.maximum(scales, 1e-12))
    f_dc = (colors - 0.5) / SH_C0
    eps = 1e-6
    o = np.clip(opac, eps, 1 - eps)
    logit_o = np.log(o) - np.log1p(-o)
    n_rest = 0 if sh is None else sh.shape[1] * 3

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )
    out = np.zeros((n, len(props)), dtype="<f4")
    out[:, 0:3] = means
    out[:, 6:9] = f_dc
    off = 9
    if sh is not None:
        # invert the loader's z-odd coefficient flip (see _SH_Z_ODD)
        rest = np.transpose(_flip_sh_z(sh), (0, 2, 1)).reshape(n, -1)
        out[:, off: off + n_rest] = rest
        off += n_rest
    out[:, off] = logit_o
    out[:, off + 1: off + 4] = log_scales
    out[:, off + 4: off + 8] = stored_q
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(out.tobytes())
