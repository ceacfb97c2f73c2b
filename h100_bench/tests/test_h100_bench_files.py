"""Cells, configurations, traffic mixes, limits and metrics are files
found by name; a new one is picked up without an edit."""
import json
import re
import shutil

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_files():
    bench = harness.Bench(ROOT)
    spec = bench.spec
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.metrics and cell.traced_metrics and cell.limits
        assert bench.driver(cell).run
        assert {"setup_s"} < {n for n, _, _ in cell.metrics}
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "viewer_1m_1080p.wide", "config": "viewer_1m_1080p",
        "traffic": "wide", "chips": 1, "why": "a new mix"})
    spec["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "frame_ms",
        "workloads": ["viewer_1m_1080p.wide"]})
    spec["end_to_end"][0]["workloads"].append("viewer_1m_1080p.wide")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    tr = json.loads((BENCH / "traffic" / "jump.json").read_text())
    tr["eyes"]["half_angle_deg"] = 60.0
    (root / "h100_bench" / "traffic" / "wide.json").write_text(
        json.dumps(tr))
    (root / "h100_bench" / "limits" / "viewer_1m_1080p.wide.json").write_text(
        json.dumps({"bad_px_ppm": 1.0}))
    (root / "h100_bench" / "metrics" / "frames_traced.py").write_text(
        "def read(run):\n    return run.trace.units if run.trace else None\n")
    bench = harness.Bench(root, root / "h100_bench")
    cell = bench.cell("viewer_1m_1080p.wide")
    assert cell.traffic["eyes"]["half_angle_deg"] == 60.0
    assert cell.limits == {"bad_px_ppm": 1.0}
    assert "frames_traced" in [n for n, _, _ in cell.traced_metrics]
    assert "frame_ms" in [n for n, _, _ in cell.metrics]
