"""The least time a rasterizer kernel could take on one H100, from the work
its inputs need, counted by the benchmark's reference (never read from the
kernel's own output).

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores, at the full 700 W; the run prints the
card's power limit beside them.

Operations per walked fragment (a pixel's list entry up to the depth at
which its transmittance falls below the early stop): the forward
rasterizer's power polynomial as 5 FMAs (10), the cutoff compare (1) and
the alpha exp (1); the backward's 22 add the 10 that fold the fragment's
sums into its instance's reduction; the fused redraw adds 192 per needed
instance for its in-kernel projection (splatjax's ``_project_rows`` counted
op by op).

Bytes: each needed instance's row read once (its tile's deepest need) and
each output byte written once: the forward's (tiles, 8, pixels) float32
planes; the backward reads them with the 4-channel cotangent and writes
one gradient row per needed instance.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
FWD_OPS_PER_FRAGMENT = 12
BWD_OPS_PER_FRAGMENT = 22
CACHED_OPS_PER_INSTANCE = 192
OUT_BYTES_PER_PIXEL = 8 * 4
COTANGENT_BYTES_PER_PIXEL = 4 * 4
CACHED_ROW_BYTES = 16 * 4
GRAD_ROW_BYTES = {16: 8 * 4, 32: 16 * 4}


def seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S)


def forward(w: dict, row_bytes: int) -> float:
    """K2 on one frame's work ``w`` (fragments, instances, pixels)."""
    return seconds(FWD_OPS_PER_FRAGMENT * w["fragments"],
                   row_bytes * w["instances"]
                   + OUT_BYTES_PER_PIXEL * w["pixels"])


def cached(w: dict) -> float:
    """K3: K2's blend plus the projection of every needed instance."""
    return seconds(FWD_OPS_PER_FRAGMENT * w["fragments"]
                   + CACHED_OPS_PER_INSTANCE * w["instances"],
                   CACHED_ROW_BYTES * w["instances"]
                   + OUT_BYTES_PER_PIXEL * w["pixels"])


def backward(w: dict, row_bytes: int) -> float:
    """K4 on one step's work."""
    return seconds(BWD_OPS_PER_FRAGMENT * w["fragments"],
                   (row_bytes + GRAD_ROW_BYTES[row_bytes]) * w["instances"]
                   + (OUT_BYTES_PER_PIXEL + COTANGENT_BYTES_PER_PIXEL)
                   * w["pixels"])
