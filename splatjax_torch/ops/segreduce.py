"""Per-gaussian run sums of gid-sorted gradient rows (K5, K6, K7): wrappers
of ``csrc/segreduce.cu`` plus their plain PyTorch versions (port of
``splatjax/ops/segreduce.py``).

The backward's per-instance gradient rows are re-ordered by source gaussian
(a stable sort by gid and a row gather, :mod:`splatjax_torch.ops.binning`),
so gaussian g owns the contiguous run ``[eff_cum[g-1], eff_cum[g])``. Three
decodes of the rows, as in splatjax:

* :func:`segment_reduce_rows` (K5): f32 rows (K, C) -> (N, C);
* :func:`segment_reduce_packed_u16` (K6): (K, 8) int32 lanes holding
  ``((q[c+8] + 32768) << 16) | (q[c] + 32768)`` -> (N, 16) exact sums of q,
  rounded once to f32 (bit-equal to splatjax);
* :func:`segment_reduce_packed_bf16` (K7): (K, 8) int32 lanes holding
  ``bf16(g[c+8]) << 16 | bf16(g[c])`` -> (N, 16) f32 sums.

Layouts are instance-major (splatjax's are feature-major: (C, K) in,
(C, N) out), and the port needs no padding of K or N. ``eff_cum`` is the
(N,) int32 inclusive run-end prefix, monotone, ``eff_cum[-1] <= K``.

The plain versions add each row to its run's sum in float64 (K6: int64):
exact for K6, within one f32 rounding of the exact sum for K5/K7. The
kernels add each run in a fixed order in f32 (K6: int64), so they are
deterministic but differ from the plain K5/K7 by f32 summation rounding.
"""
from __future__ import annotations

import ctypes

import torch

from splatjax_torch import kernels

PACKED_PLANES = 8
# both C entries: (rows, eff_cum, out, n, c or mode, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _check(rows: torch.Tensor, eff_cum: torch.Tensor, dtype: torch.dtype,
           channels=None) -> torch.device:
    dev = rows.device
    if rows.dim() != 2:
        raise ValueError(f"rows must be 2-D (K, C), got {tuple(rows.shape)}")
    if channels is not None and rows.shape[1] != channels:
        raise ValueError(f"rows must be (K, {channels}), got "
                         f"{tuple(rows.shape)}")
    kernels.check_tensor(rows, "rows", dtype, dev)
    if eff_cum.dim() != 1:
        raise ValueError("eff_cum must be 1-D (N,)")
    kernels.check_tensor(eff_cum, "eff_cum", torch.int32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _run_sums(values: torch.Tensor, eff_cum: torch.Tensor) -> torch.Tensor:
    """Run sums of ``values`` (K, C) in the values' dtype: each row is added
    to its own run's sum (rows past ``eff_cum[-1]`` to a dropped one), so a
    run's rounding depends on its own rows only."""
    n = eff_cum.shape[0]
    run = torch.searchsorted(eff_cum.long(),
                             torch.arange(values.shape[0],
                                          device=values.device),
                             right=True)
    out = values.new_zeros((n + 1, values.shape[1]))
    return out.index_add_(0, run, values)[:n]


def unpack_u16_pairs(rows: torch.Tensor) -> torch.Tensor:
    """(K, 8) biased-u16 pair lanes -> (K, 16) int64 unbiased q."""
    r = rows.long()
    return torch.cat([(r & 0xFFFF) - 32768, ((r >> 16) & 0xFFFF) - 32768],
                     dim=1)


def unpack_bf16_pairs(rows: torch.Tensor) -> torch.Tensor:
    """(K, 8) bf16 pair lanes -> (K, 16) f32 (channel c low, c + 8 high)."""
    return torch.cat([(rows << 16).view(torch.float32),
                      (rows & -65536).view(torch.float32)], dim=1)


def segment_reduce_rows(rows: torch.Tensor, eff_cum: torch.Tensor
                        ) -> torch.Tensor:
    """K5: per-run sums of f32 rows (K, C), C dividing 32 -> (N, C) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check(rows, eff_cum, torch.float32)
    c = rows.shape[1]
    if c < 1 or 32 % c:
        raise ValueError(f"segment_reduce_rows takes C dividing 32, got {c}")
    if dev.type == "cpu":
        return segment_reduce_rows_plain(rows, eff_cum)
    n = eff_cum.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = kernels.function("segreduce", "splat_segreduce_f32", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), eff_cum.data_ptr(), out.data_ptr(), n, c,
                 kernels.stream_of(dev))
    kernels.check_launch("segreduce_rows", err)
    return out


def segment_reduce_rows_plain(rows: torch.Tensor, eff_cum: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_rows` (float64 sums)."""
    return _run_sums(rows.double(), eff_cum).float()


def _packed(rows: torch.Tensor, eff_cum: torch.Tensor, mode: int,
            counter: str) -> torch.Tensor:
    dev = rows.device
    n = eff_cum.shape[0]
    out = torch.empty((n, 2 * PACKED_PLANES), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    fn = kernels.function("segreduce", "splat_segreduce_packed",
                          _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), eff_cum.data_ptr(), out.data_ptr(), n,
                 mode, kernels.stream_of(dev))
    kernels.check_launch(counter, err)
    return out


def segment_reduce_packed_u16(rows: torch.Tensor, eff_cum: torch.Tensor
                              ) -> torch.Tensor:
    """K6: exact per-run sums of the unbiased u16 pairs, (N, 16) f32
    (multiply by the quantization scale outside)."""
    dev = _check(rows, eff_cum, torch.int32, PACKED_PLANES)
    if dev.type == "cpu":
        return segment_reduce_packed_u16_plain(rows, eff_cum)
    return _packed(rows, eff_cum, 0, "segreduce_u16")


def segment_reduce_packed_u16_plain(rows: torch.Tensor,
                                    eff_cum: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_packed_u16` (int64 sums:
    exact, then one rounding to f32, as the kernel)."""
    return _run_sums(unpack_u16_pairs(rows), eff_cum).float()


def segment_reduce_packed_bf16(rows: torch.Tensor, eff_cum: torch.Tensor
                               ) -> torch.Tensor:
    """K7: per-run sums of bf16 pairs, (N, 16) f32."""
    dev = _check(rows, eff_cum, torch.int32, PACKED_PLANES)
    if dev.type == "cpu":
        return segment_reduce_packed_bf16_plain(rows, eff_cum)
    return _packed(rows, eff_cum, 1, "segreduce_bf16")


def segment_reduce_packed_bf16_plain(rows: torch.Tensor,
                                     eff_cum: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_packed_bf16` (float64
    sums)."""
    return _run_sums(unpack_bf16_pairs(rows).double(), eff_cum).float()
