"""ctypes bindings of the native (C++) asset-ingestion library (the port's
counterpart of ``splatjax/io/native.py``).

``native/splat_ingest.cpp`` runs the loaders' hot loops outside Python with
the NumPy loaders' byte semantics; :mod:`splatjax_torch.tools.build_native`
builds it at first use. The NumPy loaders stay the semantics of record:
.splat rows parse bit-equal, .ply values agree within a few f32 ulps (the
C library's ``expf`` against NumPy's ``exp``), so the importance order
can differ between splats whose importances are that close.
"""
from __future__ import annotations

import ctypes
import subprocess
from typing import Optional

import numpy as np
import torch

from splatjax_torch.scene import GaussianScene, scene_from_numpy

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    from splatjax_torch.tools.build_native import library_path

    path = library_path()
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.splat_count.restype = ctypes.c_int64
    lib.splat_count.argtypes = [ctypes.c_int64]
    lib.splat_parse.restype = None
    lib.splat_parse.argtypes = [u8p, ctypes.c_int64] + [f32p] * 5
    lib.splat_serialize.restype = None
    lib.splat_serialize.argtypes = [f32p] * 5 + [ctypes.c_int64, u8p]
    lib.ply_info.restype = ctypes.c_int64
    lib.ply_info.argtypes = [u8p, ctypes.c_int64, i32p]
    lib.ply_parse.restype = ctypes.c_int64
    lib.ply_parse.argtypes = (
        [u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32] + [f32p] * 6
    )
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built (nothing is compiled here)."""
    return _load() is not None


def ensure_built() -> bool:
    """Build the library if it is missing; returns availability."""
    if available():
        return True
    from splatjax_torch.tools.build_native import build

    try:
        build(verbose=False)
    except (OSError, subprocess.CalledProcessError):  # no g++, or it failed
        return False
    return available()


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingestion library not built")
    return lib


def _f32(a: Optional[np.ndarray]):
    ptr = ctypes.POINTER(ctypes.c_float)
    return ctypes.cast(None, ptr) if a is None else a.ctypes.data_as(ptr)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def parse_splat_bytes_native(data: bytes, device="cuda") -> GaussianScene:
    """.splat bytes -> scene on ``device`` (bit-equal to the NumPy
    parser)."""
    lib = _lib_or_raise()
    buf = np.frombuffer(data, np.uint8)
    n = lib.splat_count(len(data))
    out = dict(means=np.empty((n, 3), np.float32),
               scales=np.empty((n, 3), np.float32),
               quats=np.empty((n, 4), np.float32),
               colors=np.empty((n, 3), np.float32),
               opacities=np.empty((n,), np.float32))
    lib.splat_parse(_u8(buf), n, *(_f32(out[k]) for k in (
        "means", "scales", "quats", "colors", "opacities")))
    return scene_from_numpy(out, device)


def scene_to_splat_bytes_native(scene: GaussianScene) -> bytes:
    """Scene -> .splat bytes (the u8 channels may differ from the NumPy
    writer by one at exact .5 ties)."""
    lib = _lib_or_raise()
    n = scene.num_gaussians
    out = np.empty((n * 32,), np.uint8)
    arrs = [np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())
            for t in (scene.means, scene.scales, scene.quats, scene.colors,
                      scene.opacities)]
    lib.splat_serialize(*(_f32(a) for a in arrs), n, _u8(out))
    return out.tobytes()


def parse_ply_bytes_native(data: bytes, *, max_sh_degree: int = 3,
                           importance_sort: bool = True, device="cuda"
                           ) -> GaussianScene:
    """3DGS .ply bytes -> scene on ``device``; raises ``ValueError`` on a
    header or body the converter cannot read."""
    lib = _lib_or_raise()
    buf = np.frombuffer(data, np.uint8)
    n_rest = ctypes.c_int32(0)
    n = lib.ply_info(_u8(buf), len(data), ctypes.byref(n_rest))
    if n < 0:
        raise ValueError("Unable to read .ply file header")
    keep = min(n_rest.value // 3, (max_sh_degree + 1) ** 2 - 1)
    out = dict(means=np.empty((n, 3), np.float32),
               scales=np.empty((n, 3), np.float32),
               quats=np.empty((n, 4), np.float32),
               colors=np.empty((n, 3), np.float32),
               opacities=np.empty((n,), np.float32),
               sh=np.empty((n, keep, 3), np.float32) if keep > 0 else None)
    rc = lib.ply_parse(
        _u8(buf), len(data), int(importance_sort), keep,
        *(_f32(out[k]) for k in ("means", "scales", "quats", "colors",
                                 "opacities", "sh")))
    if rc < 0:
        raise ValueError("malformed .ply body")
    return scene_from_numpy(out, device)
