"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. A
library is named by the hash of its source, the shared headers and the
flags, so an edited source builds anew at first use; the build goes to
``build/splatjax_torch/`` at the repository root. Nothing is built or
loaded at import time.

``LAUNCHES`` counts kernel launches per kernel (a library can hold more
than one; the rasterizers K2, K3 and K4 count each tile edge apart,
:func:`tiled_counter`); each wrapper adds one where it launches its
kernel, and nowhere else. :func:`timed_launches` brackets the launches of
one C entry with CUDA events, for timing a kernel apart from its wrapper.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "splatjax_torch"
SOURCES = {
    "expand": "expand.cu",
    "rasterize_fwd": "rasterize_fwd.cu",
    "rasterize_cached": "rasterize_cached.cu",
    "rasterize_bwd": "rasterize_bwd.cu",
    "segreduce": "segreduce.cu",
    "project": "project.cu",
    "pack_rows": "pack_rows.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The square tile edges the rasterizers (K2, K3, K4) are instantiated for,
# and the default one.
TILE_EDGES = (8, 16, 32, 64)
DEFAULT_TILE = 16
# the counters of the kernels that are instantiated per tile edge
_TILED = ("rasterize_fwd", "rasterize_fwd16", "rasterize_cached",
          "rasterize_bwd")

# counter -> launches: K1, K2 (32-byte rows), K2 (16-byte rows), K3, K4,
# K5, K6, K7 (K2, K3 and K4 at the default tile edge), the projection and
# its backward, the row pack and gather (32- and 16-byte rows), then K2, K3
# and K4 at each other edge as "<counter>@<edge>"
LAUNCHES = {name: 0 for name in (
    "expand", "rasterize_fwd", "rasterize_fwd16", "rasterize_cached",
    "rasterize_bwd", "segreduce_rows", "segreduce_u16", "segreduce_bf16",
    "project_fwd", "project_bwd", "pack_rows", "pack_rows16",
    *(f"{n}@{t}" for t in TILE_EDGES if t != DEFAULT_TILE for n in _TILED),
)}

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> Path:
    """Build path of library ``name``, keyed by its source, the shared
    headers of ``csrc/`` and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, Path]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` per source, all started together. Returns name -> .so path.
    The compiler's register/spill report lands beside each library as
    ``.log``."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            paths[n].with_suffix(".log").write_bytes(out)
            if proc.returncode != 0:
                failed.append(f"{n}:\n{out.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def function(lib: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``name`` of library ``lib`` (built and loaded at first
    use), with its argument types set. Every entry returns the
    ``cudaError_t`` of its launch."""
    key = (lib, name)
    if key not in _functions:
        if lib not in _libs:
            _libs[lib] = ctypes.CDLL(str(build([lib])[lib]))
        fn = getattr(_libs[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


@contextlib.contextmanager
def timed_launches(lib: str, name: str) -> Iterator[list]:
    """Within the block, each call of the C entry ``name`` of library
    ``lib`` (loaded by an earlier launch) is bracketed by two CUDA events
    recorded on the current stream, the stream every wrapper launches on.
    Yields the list that collects one (start, stop) pair per launch; the
    wrapper's other device work (allocations, fills) falls outside."""
    key = (lib, name)
    raw = _functions[key]
    pairs: list = []

    def launch(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = raw(*args)
        stop.record()
        pairs.append((start, stop))
        return err

    _functions[key] = launch
    try:
        yield pairs
    finally:
        _functions[key] = raw


def rasterizer_attributes(name: str, tile: int,
                          packed16: bool = False) -> dict[str, int]:
    """``cudaFuncGetAttributes`` of rasterizer ``name`` (K2's counters
    ``rasterize_fwd`` and ``rasterize_fwd16``, K3's ``rasterize_cached``,
    or K4's ``rasterize_bwd``, whose row width is ``packed16``) at tile
    edge ``tile``: registers a thread (``num_regs``), local memory bytes a
    thread, which spills use (``local_bytes``), the largest block
    (``max_threads``), the blocks an SM holds at once (``blocks_per_sm``)
    and, for the thread-block cluster kernels, the clusters the device
    holds at once (``clusters``, else 0)."""
    out = (ctypes.c_int * 5)()
    ptr = ctypes.POINTER(ctypes.c_int)
    if name == "rasterize_cached":
        fn = function(name, "splat_rasterize_cached_attributes",
                      [ctypes.c_int, ptr])
        err = fn(tile, out)
    elif name == "rasterize_bwd":
        fn = function(name, "splat_rasterize_bwd_attributes",
                      [ctypes.c_int, ctypes.c_int, ptr])
        err = fn(tile, int(packed16), out)
    else:
        fn = function("rasterize_fwd", "splat_rasterize_fwd_attributes",
                      [ctypes.c_int, ctypes.c_int, ptr])
        err = fn(tile, int(name == "rasterize_fwd16"), out)
    if err != 0:
        raise RuntimeError(f"{name} attributes at {tile} px: cudaError {err}")
    return dict(num_regs=out[0], local_bytes=out[1], max_threads=out[2],
                blocks_per_sm=out[3], clusters=out[4])


def tiled_counter(name: str, tile: int) -> str:
    """The launch counter of rasterizer ``name`` (K2, K3 or K4) at tile
    edge ``tile``: ``name`` at the default edge, ``name@tile`` else."""
    return name if tile == DEFAULT_TILE else f"{name}@{tile}"


def check_launch(counter: str, err: int) -> None:
    """Raise on a launch error; count the launch under ``counter``
    otherwise."""
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: cudaError {err}")
    LAUNCHES[counter] += 1


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device) -> None:
    """Validate a tensor that a kernel (or its plain twin) is handed."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
