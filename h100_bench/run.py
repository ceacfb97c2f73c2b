#!/usr/bin/env python3
"""One run of one cell of the splatjax_torch benchmark on this machine's
cards:

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It makes the cell's inputs from the seed, builds and warms the program
(``splatjax_torch``), measures for ``--seconds`` (``--trace 1``: a short
profiled window instead, for the per-layer metrics), checks what the timed
path produced against the plain reference, and prints one JSON line last.
Without a card, or with fewer than the cell asks for, it prints no result
and exits 2; on any other failure, 1.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build" / "h100_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness

    try:
        bench = harness.Bench(ROOT)
        cell = bench.cell(args.workload)
        harness.require_cards(cell.chips)
        import torch

        torch.set_num_threads(4)
        harness.log(f"[card] {harness.nvidia_smi()}")
        run = bench.driver(cell).run(
            cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device="cuda", t0=T0, bench_dir=HERE)
        harness.log(f"[card] {harness.nvidia_smi()}")
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips,
                  "memory_peak_bytes": run.memory_peak_bytes}
        res = harness.result(cell, run, bool(args.trace), device)
    except harness.NoCards as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 - the run's boundary: report, no result
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"h100_bench: loaded {found}: the run must not import JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
