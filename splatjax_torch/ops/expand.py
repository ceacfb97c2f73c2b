"""Instance expansion (K1): depth-ordered gaussians -> per-instance
(tile, gaussian id). Wrapper of ``csrc/expand.cu`` plus its plain PyTorch
version; replaces ``splatjax/ops/expand.py::_expand_kernel``.

Slot ``j < min(total, capacity)`` belongs to the depth-ordered gaussian
``g = #{r : cum_d[r] <= j}``; with ``local = j - cum_ex[g]`` it holds
``tile = (y0 + local // span_w) * tiles_x + x0 + local % span_w`` and
``gid = perm[g]``. Slots past the end hold ``tile = num_tiles`` and
``gid = n - 1`` (the backward's run arithmetic relies on that id).
Capacity overflow drops the depth-farthest instances. ``cum_d`` may
saturate (``ops.binning.CUM_MAX``) past the capacity: only slots below it
are expanded.
"""
from __future__ import annotations

import ctypes

import torch

from splatjax_torch import kernels

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def _check_inputs(arrays: dict[str, torch.Tensor], capacity: int
                  ) -> torch.device:
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    n = arrays["cum_d"].shape[0]
    dev = arrays["cum_d"].device
    for name, t in arrays.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
        kernels.check_tensor(t, name, torch.int32, dev)
    if n == 0:
        raise ValueError("expansion needs at least one gaussian")
    return dev


def expand_instances(x0_d, y0_d, spanw_d, cum_d, perm, capacity: int,
                     tiles_x: int, num_tiles: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand depth-ordered gaussians into (tile, gid), each (capacity,)
    int32. Inputs are (N,) int32 in depth order: tile-rect origin
    ``x0_d, y0_d``, rect width ``spanw_d``, inclusive instance cumsum
    ``cum_d`` and original ids ``perm``. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = _check_inputs(dict(x0_d=x0_d, y0_d=y0_d, spanw_d=spanw_d,
                             cum_d=cum_d, perm=perm), capacity)
    if dev.type == "cpu":
        return expand_instances_plain(x0_d, y0_d, spanw_d, cum_d, perm,
                                      capacity, tiles_x, num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tile = torch.empty((capacity,), dtype=torch.int32, device=dev)
    gid = torch.empty((capacity,), dtype=torch.int32, device=dev)
    fn = kernels.function("expand", "splat_expand_instances", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            x0_d.data_ptr(), y0_d.data_ptr(), spanw_d.data_ptr(),
            cum_d.data_ptr(), perm.data_ptr(),
            cum_d.shape[0], capacity, tiles_x, num_tiles,
            tile.data_ptr(), gid.data_ptr(), kernels.stream_of(dev),
        )
    kernels.check_launch("expand", err)
    return tile, gid


def expand_instances_plain(x0_d, y0_d, spanw_d, cum_d, perm, capacity: int,
                           tiles_x: int, num_tiles: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`expand_instances` (same contract)."""
    n = cum_d.shape[0]
    dev = cum_d.device
    # counts cut at the capacity: the slots past it are never materialised
    cum = cum_d.long().clamp(max=capacity)
    count = torch.diff(cum, prepend=cum.new_zeros(1))
    cum_ex = cum - count
    total = int(cum[-1])
    g = torch.repeat_interleave(
        torch.arange(n, device=dev), count
    )[:total]
    local = torch.arange(total, device=dev) - cum_ex[g]
    w = spanw_d.long()[g]
    r = local // w
    tile = torch.full((capacity,), num_tiles, dtype=torch.int32, device=dev)
    gid = torch.full((capacity,), n - 1, dtype=torch.int32, device=dev)
    tile[:total] = ((y0_d.long()[g] + r) * tiles_x
                    + x0_d.long()[g] + (local - r * w)).int()
    gid[:total] = perm[g]
    return tile, gid
