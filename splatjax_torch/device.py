"""Device selection and the f32 matmul rule shared by the port's modules."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    CUDA device is present. The port never falls back to the CPU on its
    own: a caller that wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "splatjax_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32.

    TF32 keeps ~3 decimal digits, which breaks the 1e-3 viewer-parity
    budget, so every f32 matmul of the port goes through here with TF32
    switched off for CUDA matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so that a
    host clock read after it covers the device's time."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
