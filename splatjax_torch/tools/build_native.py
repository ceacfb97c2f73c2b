"""Build the native ingestion library from ``native/splat_ingest.cpp``.

    python -m splatjax_torch.tools.build_native

Compiles the source where it stands with ``g++`` into
``build/splatjax_torch/``, named by the hash of the source and the flags
(as :mod:`splatjax_torch.kernels` names its CUDA libraries), so an edited
source builds anew. :mod:`splatjax_torch.io.native` loads it; nothing is
built at import.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

from splatjax_torch.kernels import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "native" / "splat_ingest.cpp"
# No -march=native and no FMA contraction: the library's products and
# sums round as NumPy's do, on any host.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")


def library_path() -> Path:
    """Build path of the library, keyed by its source and the flags."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"splat_ingest-{digest[:16]}.so"


def build(verbose: bool = True) -> Path:
    """Compile the library if it is missing; returns its path. Raises
    ``subprocess.CalledProcessError`` (or ``OSError`` without g++) on a
    failed build."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
