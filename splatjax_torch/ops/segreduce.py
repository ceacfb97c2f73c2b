"""Per-gaussian run sums of gradient rows (K5, K6, K7): wrappers of
``csrc/segreduce.cu`` plus their plain PyTorch versions (port of
``splatjax/ops/segreduce.py``).

Three decodes of the rows, as in splatjax:

* K5: f32 rows (K, C) -> (N, C);
* K6: (K, 8) int32 lanes holding ``((q[c+8] + 32768) << 16) | (q[c] +
  32768)`` -> (N, 16) exact sums of q, rounded once to f32 (bit-equal to
  splatjax);
* K7: (K, 8) int32 lanes holding ``bf16(g[c+8]) << 16 | bf16(g[c])`` ->
  (N, 16) f32 sums.

Two ways to name a gaussian's rows, one kernel:

* direct (:func:`segment_reduce_rows`, :func:`segment_reduce_packed_u16`,
  :func:`segment_reduce_packed_bf16`): rows grouped by gaussian, gaussian g
  owning ``[eff_cum[g-1], eff_cum[g])``; ``eff_cum`` is the (N,) int32
  inclusive run-end prefix, monotone, ``eff_cum[-1] <= K``. splatjax's
  contract.
* slots (``_segment_reduce_slots_rows``, ...; library-internal, fed only
  from ``bin_gaussians``' own outputs, because the kernel trusts
  ``slot_pos``, ``cum_d`` and ``perm`` as indices): rows in tile order, as
  the backward writes them. Depth rank r owns the expansion slots
  ``[min(cum_d[r-1], K), min(cum_d[r], K))``, slot s lies at row
  ``slot_pos[s]`` (the inverse of the stable tile sort), and the sum goes
  to row ``perm[r]``. A gaussian's slots ascend in tile id, so its rows
  come in the order a stable sort by gid gives them: the direct sums of the
  gid-sorted rows, with no sort and no row copy.

Layouts are instance-major (splatjax's are feature-major: (C, K) in,
(C, N) out), and the port needs no padding of K or N.

The plain versions add each row to its run's sum in float64 (K6: int64):
exact for K6, within one f32 rounding of the exact sum for K5/K7. The
kernels add each run in a fixed order in f32 (K6: int32, int64 past 65,537
rows), so they are deterministic but differ from the plain K5/K7 by f32
summation rounding.
"""
from __future__ import annotations

import ctypes

import torch

from splatjax_torch import kernels

PACKED_PLANES = 8
# direct C entries: (rows, eff_cum, out, n, c or mode, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
# slot C entries: (rows, slot_pos, cum_d, perm, out, n, k, c or mode,
# stream)
_SLOT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def _check_rows(rows: torch.Tensor, dtype: torch.dtype,
                channels=None) -> torch.device:
    dev = rows.device
    if rows.dim() != 2:
        raise ValueError(f"rows must be 2-D (K, C), got {tuple(rows.shape)}")
    if channels is not None and rows.shape[1] != channels:
        raise ValueError(f"rows must be (K, {channels}), got "
                         f"{tuple(rows.shape)}")
    kernels.check_tensor(rows, "rows", dtype, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the "
                         "kernel reads 16-byte lanes)")
    return dev


def _check(rows: torch.Tensor, eff_cum: torch.Tensor, dtype: torch.dtype,
           channels=None) -> torch.device:
    dev = _check_rows(rows, dtype, channels)
    if eff_cum.dim() != 1:
        raise ValueError("eff_cum must be 1-D (N,)")
    kernels.check_tensor(eff_cum, "eff_cum", torch.int32, dev)
    return dev


def _check_slots(rows, slot_pos, cum_d, perm, dtype: torch.dtype,
                 channels=None) -> torch.device:
    dev = _check_rows(rows, dtype, channels)
    if tuple(slot_pos.shape) != (rows.shape[0],):
        raise ValueError(f"slot_pos must be ({rows.shape[0]},), got "
                         f"{tuple(slot_pos.shape)}")
    kernels.check_tensor(slot_pos, "slot_pos", torch.int32, dev)
    n = cum_d.shape[0]
    for name, t in (("cum_d", cum_d), ("perm", perm)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        kernels.check_tensor(t, name, torch.int32, dev)
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


def _launch(entry: str, argtypes: list, counter: str, rows: torch.Tensor,
            index: tuple, n: int, ints: tuple, cols: int) -> torch.Tensor:
    """Launch C entry ``entry`` of ``csrc/segreduce.cu`` as (rows, *index,
    out, n, *ints, stream) into a new (n, cols) f32 output."""
    dev = rows.device
    out = torch.empty((n, cols), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = kernels.function("segreduce", entry, argtypes)
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), *(t.data_ptr() for t in index),
                 out.data_ptr(), n, *ints, kernels.stream_of(dev))
    kernels.check_launch(counter, err)
    return out


def _f32_lanes(rows: torch.Tensor) -> torch.Tensor:
    """f32 rows for the kernel, which reads 16-byte lanes: C must divide 32,
    and C < 4 is padded with zero channels to 4."""
    c = rows.shape[1]
    if c < 1 or 32 % c:
        raise ValueError(f"segment sums of f32 rows take C dividing 32, got "
                         f"{c}")
    return torch.nn.functional.pad(rows, (0, 4 - c)) if c < 4 else rows


def segment_reduce_rows(rows: torch.Tensor, eff_cum: torch.Tensor
                        ) -> torch.Tensor:
    """K5: per-run sums of f32 rows (K, C), C dividing 32 -> (N, C) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check(rows, eff_cum, torch.float32)
    lanes = _f32_lanes(rows)
    if dev.type == "cpu":
        return segment_reduce_rows_plain(rows, eff_cum)
    c = rows.shape[1]
    out = _launch("splat_segreduce_f32", _ARGTYPES, "segreduce_rows", lanes,
                  (eff_cum,), eff_cum.shape[0], (lanes.shape[1],),
                  lanes.shape[1])
    return out if lanes is rows else out[:, :c].contiguous()


def segment_reduce_rows_plain(rows: torch.Tensor, eff_cum: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_rows` (float64 sums)."""
    return _run_sums(rows.double(), eff_cum).float()


def segment_reduce_packed_u16(rows: torch.Tensor, eff_cum: torch.Tensor
                              ) -> torch.Tensor:
    """K6: exact per-run sums of the unbiased u16 pairs, (N, 16) f32
    (multiply by the quantization scale outside)."""
    dev = _check(rows, eff_cum, torch.int32, PACKED_PLANES)
    if dev.type == "cpu":
        return segment_reduce_packed_u16_plain(rows, eff_cum)
    return _launch("splat_segreduce_packed", _ARGTYPES, "segreduce_u16", rows,
                   (eff_cum,), eff_cum.shape[0], (0,), 2 * PACKED_PLANES)


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
    return _launch("splat_segreduce_packed", _ARGTYPES, "segreduce_bf16",
                   rows, (eff_cum,), eff_cum.shape[0], (1,),
                   2 * PACKED_PLANES)


def segment_reduce_packed_bf16_plain(rows: torch.Tensor,
                                     eff_cum: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_packed_bf16` (float64
    sums)."""
    return _run_sums(unpack_bf16_pairs(rows).double(), eff_cum).float()


def _slot_sums(values: torch.Tensor, slot_pos: torch.Tensor,
               cum_d: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Sums of ``values`` (K, C) over each depth rank's slots, in row
    ``perm[r]``: the rows gathered into slot order, summed per run of the
    capacity-clamped depth cumsum (slots past it to a dropped run)."""
    k = values.shape[0]
    by_rank = _run_sums(values.index_select(0, slot_pos.long()),
                        cum_d.clamp(max=k))
    return torch.empty_like(by_rank).index_copy_(0, perm.long(), by_rank)


def _segment_reduce_slots_rows(rows, slot_pos, cum_d, perm
                               ) -> torch.Tensor:
    """K5 on rows in tile order: (K, C) f32, C dividing 32, ``slot_pos``
    (K,) int32, ``cum_d``/``perm`` (N,) int32 -> (N, C) f32 per-gaussian
    sums (see the module doc). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    dev = _check_slots(rows, slot_pos, cum_d, perm, torch.float32)
    lanes = _f32_lanes(rows)
    if dev.type == "cpu":
        return _segment_reduce_slots_rows_plain(rows, slot_pos, cum_d,
                                                perm)
    c = rows.shape[1]
    out = _launch("splat_segreduce_slots_f32", _SLOT_ARGTYPES,
                  "segreduce_rows", lanes, (slot_pos, cum_d, perm),
                  cum_d.shape[0], (rows.shape[0], lanes.shape[1]),
                  lanes.shape[1])
    return out if lanes is rows else out[:, :c].contiguous()


def _segment_reduce_slots_rows_plain(rows, slot_pos, cum_d, perm
                                    ) -> torch.Tensor:
    """Plain version of :func:`_segment_reduce_slots_rows` (float64
    sums)."""
    return _slot_sums(rows.double(), slot_pos, cum_d, perm).float()


def _segment_reduce_slots_packed_u16(rows, slot_pos, cum_d, perm
                                    ) -> torch.Tensor:
    """K6 on (K, 8) int32 biased-u16 pairs in tile order -> (N, 16) f32
    exact per-gaussian sums of q."""
    dev = _check_slots(rows, slot_pos, cum_d, perm, torch.int32,
                       PACKED_PLANES)
    if dev.type == "cpu":
        return _segment_reduce_slots_packed_u16_plain(rows, slot_pos,
                                                      cum_d, perm)
    return _launch("splat_segreduce_slots_packed", _SLOT_ARGTYPES,
                   "segreduce_u16", rows, (slot_pos, cum_d, perm),
                   cum_d.shape[0], (rows.shape[0], 0), 2 * PACKED_PLANES)


def _segment_reduce_slots_packed_u16_plain(rows, slot_pos, cum_d, perm
                                          ) -> torch.Tensor:
    """Plain version of :func:`_segment_reduce_slots_packed_u16` (int64
    sums, then one rounding to f32)."""
    return _slot_sums(unpack_u16_pairs(rows), slot_pos, cum_d, perm).float()


def _segment_reduce_slots_packed_bf16(rows, slot_pos, cum_d, perm
                                     ) -> torch.Tensor:
    """K7 on (K, 8) int32 bf16 pairs in tile order, as the 16-byte backward
    writes them -> (N, 16) f32 per-gaussian sums."""
    dev = _check_slots(rows, slot_pos, cum_d, perm, torch.int32,
                       PACKED_PLANES)
    if dev.type == "cpu":
        return _segment_reduce_slots_packed_bf16_plain(rows, slot_pos,
                                                       cum_d, perm)
    return _launch("splat_segreduce_slots_packed", _SLOT_ARGTYPES,
                   "segreduce_bf16", rows, (slot_pos, cum_d, perm),
                   cum_d.shape[0], (rows.shape[0], 1), 2 * PACKED_PLANES)


def _segment_reduce_slots_packed_bf16_plain(rows, slot_pos, cum_d, perm
                                           ) -> torch.Tensor:
    """Plain version of :func:`_segment_reduce_slots_packed_bf16` (float64
    sums)."""
    return _slot_sums(unpack_bf16_pairs(rows).double(), slot_pos, cum_d,
                      perm).float()
