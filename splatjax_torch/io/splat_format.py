"""`.splat` binary format with the reference viewer's byte semantics (the
port's own copy of ``splatjax/io/splat_format.py``).

Row layout (32 bytes):
  bytes  0-11: position xyz, 3x float32 (little-endian)
  bytes 12-23: scale xyz, 3x float32 (linear std-devs)
  bytes 24-27: color RGBA, 4x uint8
  bytes 28-31: quaternion (w, x, y, z), uint8, value*128+128

The viewer negates Z of positions and builds its quaternion from
(x=q1, y=q2, z=-q3, w=q0); folding the transpose into the quaternion gives
framework quats (w, x, y, z) = (q0, -q1, -q2, q3) and Sigma = R S^2 R^T.
"""
from __future__ import annotations

import io as _io
import os
from typing import Optional, Union

import numpy as np
import torch

from splatjax_torch.scene import GaussianScene, scene_from_numpy

ROW_LENGTH = 32


def parse_splat_arrays(data: bytes) -> dict[str, np.ndarray]:
    """Parse raw .splat bytes (whole rows only) into numpy float32 arrays
    keyed like the scene fields."""
    n = len(data) // ROW_LENGTH
    raw = np.frombuffer(data, dtype=np.uint8, count=n * ROW_LENGTH)
    rows = raw.reshape(n, ROW_LENGTH)

    floats = rows[:, :24].copy().view("<f4")
    positions = floats[:, :3].astype(np.float32)
    scales = floats[:, 3:6].astype(np.float32)

    rgba = rows[:, 24:28].astype(np.float32) / 255.0
    qb = rows[:, 28:32].astype(np.float32)
    q = (qb - 128.0) / 128.0
    positions = positions * np.array([1.0, 1.0, -1.0], dtype=np.float32)
    quats = np.stack([q[:, 0], -q[:, 1], -q[:, 2], q[:, 3]], axis=-1)
    return dict(means=positions, scales=scales, quats=quats,
                colors=rgba[:, :3], opacities=rgba[:, 3])


def parse_splat_bytes(data: bytes, device="cuda") -> GaussianScene:
    """Parse raw .splat bytes into a scene on ``device``."""
    return scene_from_numpy(parse_splat_arrays(data), device)


def load_splat(path: Union[str, os.PathLike], backend: str = "auto", *,
               device="cuda") -> GaussianScene:
    """Load a .splat file onto ``device``. backend: "numpy"; "native" (the
    C++ parser, built at first use; raises if it cannot be built); "auto"
    takes the native parser when it is already built (bit-equal), else
    NumPy."""
    with open(path, "rb") as f:
        data = f.read()
    if backend in ("auto", "native"):
        from splatjax_torch.io import native

        if native.available() or (
            backend == "native" and native.ensure_built()
        ):
            return native.parse_splat_bytes_native(data, device)
        if backend == "native":
            raise RuntimeError("native ingestion library unavailable")
    return parse_splat_bytes(data, device)


def scene_to_splat_bytes(scene: GaussianScene) -> bytes:
    """Serialize a scene to .splat bytes (inverse of the loader).

    Quaternions are normalized, then quantized with round-to-nearest like
    the viewer's .ply converter output path."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    means, scales = host(scene.means), host(scene.scales)
    quats, colors = host(scene.quats), host(scene.colors)
    opac = host(scene.opacities)
    n = means.shape[0]

    qn = quats / np.maximum(
        np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12
    )
    stored_q = np.stack([qn[:, 0], -qn[:, 1], -qn[:, 2], qn[:, 3]], axis=-1)
    qb = np.clip(np.rint(stored_q * 128.0 + 128.0), 0, 255).astype(np.uint8)
    pos_out = means * np.array([1.0, 1.0, -1.0], dtype=np.float32)

    rows = np.zeros((n, ROW_LENGTH), dtype=np.uint8)
    rows[:, :12] = np.ascontiguousarray(
        pos_out.astype("<f4")
    ).view(np.uint8).reshape(n, 12)
    rows[:, 12:24] = np.ascontiguousarray(
        scales.astype("<f4")
    ).view(np.uint8).reshape(n, 12)
    rows[:, 24:27] = np.clip(np.rint(colors * 255.0), 0, 255).astype(np.uint8)
    rows[:, 27] = np.clip(np.rint(opac * 255.0), 0, 255).astype(np.uint8)
    rows[:, 28:32] = qb
    return rows.tobytes()


def save_splat(path: Union[str, os.PathLike], scene: GaussianScene) -> None:
    with open(path, "wb") as f:
        f.write(scene_to_splat_bytes(scene))


class StreamingSplatReader:
    """Progressive .splat ingestion: feed byte chunks of any size, get the
    complete rows back as scenes on ``device`` (partial rows are carried
    over to the next chunk, as the viewer's streaming loader does)."""

    def __init__(self, device="cuda") -> None:
        self._pending = _io.BytesIO()
        self.rows_emitted = 0
        self.device = device

    def feed(self, chunk: bytes) -> Optional[GaussianScene]:
        self._pending.write(chunk)
        buf = self._pending.getvalue()
        n_rows = len(buf) // ROW_LENGTH
        if n_rows == 0:
            return None
        complete = buf[: n_rows * ROW_LENGTH]
        remainder = buf[n_rows * ROW_LENGTH:]
        self._pending = _io.BytesIO()
        self._pending.write(remainder)
        self.rows_emitted += n_rows
        return parse_splat_bytes(complete, self.device)
