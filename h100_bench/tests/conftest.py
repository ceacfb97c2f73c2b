"""CPU tests of the benchmark harness: the port runs with its plain twins
at tiny sizes. Tests marked ``card`` need a CUDA card and skip without
one (the check is made inside the test, never at import)."""
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes every cell is cut to here
TINY = {"splats": 1500, "width": 64, "height": 48}
TINY_EYES = 8
SEED = 2 ** 31 + 7


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures on the H100")


def tiny(name: str):
    """The cell ``name`` of the repository's BENCHMARK.json at tiny
    sizes."""
    import harness

    cell = harness.Bench(ROOT).cell(name)
    cell.config.update(TINY)
    cell.traffic["eyes"]["count"] = TINY_EYES
    return cell


def run_tiny(name: str, seconds: float = 4.0, trace: bool = False,
             seed: int = SEED):
    import harness

    cell = tiny(name)
    driver = harness.Bench(ROOT).driver(cell)
    run = driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                     device="cpu", t0=time.perf_counter(), bench_dir=BENCH)
    return cell, run, harness.result(cell, run, trace, {"platform": "cpu"})
