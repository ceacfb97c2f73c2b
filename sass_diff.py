#!/usr/bin/env python3
"""Compare the compiled SASS of the port's CUDA kernels with another tree's.

    python3 sass_diff.py OTHER_TREE [--csrc DIR] [SOURCE ...]

OTHER_TREE is a checkout of another commit (for example ``git archive``
of the parent, unpacked under ``build/``). Each source of
``splatjax_torch/csrc`` (default: the three rasterizers) is compiled to a
cubin from both trees (this tree's sources, or those in DIR, for example
a variant's under ``build/cluster_variants/<variant>/csrc``) for
``sm_90a`` at ``-O3``, as
``splatjax_torch.kernels`` builds it, and disassembled with ``cuobjdump
-sass``. For every kernel of the
other tree it prints its instruction count and the kernels of this tree
whose instructions are the same, ignoring addresses and encodings; where
none is, the count of differing instructions against this tree's
instantiation of the same kernel, tile edge and row width, and the first
SHOWN pairs that differ. Needs ``nvcc`` and
``cuobjdump`` (CUDA_HOME or /usr/local/cuda), no card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("splatjax_torch", "csrc")
SOURCES = ("rasterize_fwd.cu", "rasterize_cached.cu", "rasterize_bwd.cu")
SHOWN = 4  # differing instructions printed an instantiation


def disassemble(source: str, workdir: str) -> dict[str, list[str]]:
    """Kernel name -> its SASS instructions, without addresses and
    encodings."""
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cubin = os.path.join(workdir, "k.cubin")
    subprocess.run([os.path.join(cuda, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", cubin, source], check=True)
    text = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                           cubin], check=True, capture_output=True,
                          text=True).stdout
    kernels: dict[str, list[str]] = {}
    body = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = kernels.setdefault(m.group(1), [])
            continue
        ins = re.sub(r"/\*[0-9a-fx]+\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
        if body is not None and ins:
            body.append(ins)
    return kernels


def kernel_key(name: str) -> tuple[str, int, bool]:
    """(kernel function, its tile edge or 0 where it takes none, its
    PACKED16 argument) of a mangled name."""
    edge = re.search(r"ILi(\d+)E", name)
    return (re.search(r"(rasterize_[a-z]+\d*(?:_[a-z]+)*_kernel)",
                      name).group(1),
            int(edge.group(1)) if edge else 0, "Lb1E" in name)


def compare(other: str, source: str,
            csrc: str = os.path.join(HERE, CSRC)) -> None:
    with tempfile.TemporaryDirectory() as d:
        theirs = disassemble(os.path.join(other, CSRC, source), d)
        ours = disassemble(os.path.join(csrc, source), d)
    for name, body in theirs.items():
        same = [n for n, b in ours.items() if b == body]
        print(f"{source}: {kernel_key(name)}: {len(body)} instructions; "
              f"{len(same)} identical here")
        for n, b in ours.items():
            if not same and kernel_key(n) == kernel_key(name):
                pairs = [(x, y) for x, y in zip(body, b) if x != y]
                differ = len(pairs) + abs(len(body) - len(b))
                print(f"  the same instantiation here: {len(b)} "
                      f"instructions, {differ} differ position by position")
                for x, y in pairs[:SHOWN]:
                    print(f"    theirs: {x}\n    here:   {y}")


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("other")
    parser.add_argument("--csrc", default=os.path.join(HERE, CSRC))
    parser.add_argument("sources", nargs="*", default=list(SOURCES))
    args = parser.parse_intermixed_args(argv)
    for source in args.sources:
        compare(args.other, source, args.csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
