"""Dependency-free PNG writer (stdlib zlib only; port of
``splatjax/utils/png.py``, the same bytes for the same array).

The demo scripts (the analogue of the reference's demo pages, index.html /
cutout-demo.html) write their frames with it: 8-bit gray/RGB/RGBA PNGs (no
palette, no interlace, filter byte 0, zlib level 6) straight from float or
uint8 arrays or tensors.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def to_u8(img) -> np.ndarray:
    """Float [0,1] (or already-uint8) (H, W[, {1,3,4}]) array or tensor ->
    (H, W, C) uint8: ``floor(clip(x, 0, 1) * 255 + 0.5)`` in float32.
    A tensor is read through ``.detach().cpu()``, never ``np.asarray`` on a
    device tensor."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
        arr = np.floor(arr * np.float32(255.0) + np.float32(0.5)).astype(
            np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def encode_png(img) -> bytes:
    """Encode an (H, W, {1,3,4}) or (H, W) image (float [0,1] or uint8) as
    PNG bytes."""
    arr = to_u8(img)
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
