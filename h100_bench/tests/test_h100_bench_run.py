"""The command: it measures only on a card, and nothing it loads is JAX
or the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "viewer_1m_1080p.jump", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode == 2
    assert "correct" not in out.stdout
    assert "no card" in out.stderr


def test_fails_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's own files: no program, so
    no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "viewer_1m_1080p.jump", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout


PROBE = r"""
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import harness
from conftest import run_tiny
for name in ("viewer_1m_1080p.jump", "m360_3m_sh3.fit"):
    run_tiny(name, seconds=0.5)
import control
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_loads_no_jax():
    code = PROBE.format(bench=str(BENCH), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH / "tests", timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "splatjax_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "splatjax"}


@pytest.mark.card
def test_card_run(need_card):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "viewer_1m_1080p.jump", "--seed", str(2 ** 31 + 11), "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
