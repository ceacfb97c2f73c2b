"""The benchmark's frame: find a cell's files by name, check the cards, run
the cell's driver, read its metrics, judge ``correct`` and print the
result.

Everything that belongs to one configuration, traffic mix, metric or
cell is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the ``file`` of its entry): sizes;
* ``traffic/<traffic>.json``: the mix's parameters, read by the driver it
  names, ``drivers/<driver>.py``;
* ``metrics/<metric>.py``: ``read(run)`` returns the metric's value, or
  None when the run holds nothing for it to read;
* ``limits/<cell>.json``: each number the cell compares, with its limit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splatjax")
_START = time.perf_counter()


class NoCards(RuntimeError):
    """The run cannot measure: no card, or fewer than the cell asks."""


def log(msg: str) -> None:
    """A diagnostic line, with the seconds since the harness was loaded."""
    print(f"{time.perf_counter() - _START:9.3f} {msg}", flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list        # (name, unit, reader module) for this cell
    traced_metrics: list


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files its names point to."""

    def __init__(self, root: Path, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir else HERE
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _metrics(self, key: str, cell: str, moves: set) -> list:
        out = []
        for m in self.spec[key]:
            cells = m.get("workloads")
            if cells is not None and cell not in cells:
                continue
            if cells is None and key == "per_layer" and m["moves"] not in moves:
                continue
            reader = load_module(self.dir / "metrics" / f"{m['name']}.py",
                                 f"h100_bench_metric_{m['name']}")
            out.append((m["name"], m["unit"], reader))
        return out

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name),
                 None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        c = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        config = json.loads((self.root / c["file"]).read_text())
        traffic = json.loads(
            (self.dir / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads(
            (self.dir / "limits" / f"{name}.json").read_text())
        e2e = self._metrics("end_to_end", name, set())
        moves = {n for n, _, _ in e2e}
        return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                    self._metrics("per_layer", name, moves))

    def driver(self, cell: Cell):
        return load_module(self.dir / "drivers" / f"{cell.traffic['driver']}.py",
                           f"h100_bench_driver_{cell.traffic['driver']}")


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCards("torch.cuda.is_available() is false: no card, no run")
    if torch.cuda.device_count() < chips:
        raise NoCards(f"{torch.cuda.device_count()} cards, the cell asks "
                      f"for {chips}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


@dataclasses.dataclass
class Run:
    """What a driver hands back; the metric readers read it."""

    unit: str                       # "frame" or "step"
    attempted: int
    failed: int
    durations: list                 # seconds per unit, host clock
    window_s: float
    setup_s: float
    checks: dict                    # number compared -> value
    memory_peak_bytes: int
    trace: object = None            # trace.Trace of a traced run
    work: dict = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    finite and at or under its limit."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        shown[name] = {"value": v, "limit": limit}
    return ok, shown


def read_metrics(specs: list, run: Run) -> dict:
    out = {}
    for name, unit, reader in specs:
        v = reader.read(run)
        if v is not None:
            out[name] = {"value": float(v), "unit": unit}
    return out


def result(cell: Cell, run: Run, traced: bool, device: dict) -> dict:
    ok, shown = judge(run.checks, cell.limits)
    res = {
        "correct": ok,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": read_metrics(cell.traced_metrics if traced
                                else cell.metrics, run),
        "device": device,
    }
    if traced and run.trace is not None:
        for name, sec in run.trace.top_ops(25):
            log(f"[trace] {sec * 1e3:10.4f} ms  {name}")
        res["device"]["busy_s"] = run.trace.busy_s()
        res["device"]["window_s"] = run.trace.window_s
        res["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    res["checks"] = shown
    return res


def emit(res: dict) -> None:
    for name, c in res["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
