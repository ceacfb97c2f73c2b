"""The readers of the program's spans and counters on hand-made traces:
exact span names, self times, idle time inside a span, counter records,
and None where the program made no span or kept no counter."""
import pytest

import harness
import spans
from conftest import BENCH
from profiling import Trace

# two frames of 100 us: each projects, bins and gathers; the second's
# gather_bwd-named span must not count as a gather
FRAME_HOST = [
    ("h100_bench.window", 0.0, 200.0),
    ("sj.frame", 0.0, 80.0), ("sj.project", 5.0, 10.0),
    ("sj.bin", 20.0, 10.0), ("sj.gather", 40.0, 10.0),
    ("sj.frame", 100.0, 80.0), ("sj.project", 105.0, 10.0),
    ("sj.bin", 120.0, 10.0), ("sj.gather", 140.0, 10.0),
    ("sj.gather_bwd", 160.0, 10.0), ("aten::cat", 141.0, 2.0),
]
# (name, start, dur, launch): device time in us, by the launching span
FRAME_KERNELS = [
    ("proj", 10.0, 4.0, 6.0), ("sort", 30.0, 6.0, 22.0),
    ("gather", 50.0, 20.0, 41.0), ("k2", 72.0, 8.0, 60.0),
    ("proj", 110.0, 4.0, 106.0), ("sort", 130.0, 6.0, 121.0),
    ("gather", 150.0, 20.0, 142.0), ("seg", 172.0, 3.0, 165.0),
    ("lost", 190.0, 1.0, None),
]


def _trace(host, kernels, units, window=(0.0, 200.0)):
    device = [(n, "kernel", s, d) for n, s, d, _ in kernels]
    return Trace(window, device, kernels, host, units)


def _run(unit, trace):
    return harness.Run(unit=unit, attempted=trace.units, failed=0,
                       durations=[1e-3] * trace.units, window_s=2e-4,
                       setup_s=1.0, checks={}, memory_peak_bytes=0,
                       trace=trace)


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"test_reader_{name}")


def test_exact_names():
    t = _trace(FRAME_HOST, FRAME_KERNELS, 2)
    assert spans.device_s(t, "sj.gather") == pytest.approx(40e-6)
    assert spans.device_s(t, "sj.gather_bwd") == pytest.approx(3e-6)
    # the substring match of Trace.launched_within takes both
    assert t.launched_within("sj.gather") == pytest.approx(43e-6)
    assert spans.device_s(t, "sj.nothing") is None


def test_self_time_and_host_time():
    t = _trace(FRAME_HOST, FRAME_KERNELS, 2)
    assert spans.device_s(t, "sj.frame") == pytest.approx(71e-6)
    # K2 of frame 1 and the gather_bwd-named kernel of frame 2
    assert spans.device_s(t, "sj.frame", exclude=(
        "sj.project", "sj.bin", "sj.gather")) == pytest.approx(11e-6)
    assert spans.host_s(t, "sj.frame") == pytest.approx(160e-6)
    assert spans.host_s(t, "sj.loss") is None


def test_idle_inside_a_span():
    t = _trace(FRAME_HOST, FRAME_KERNELS, 2)
    # frame 1 (0-80 us) is busy 10-14, 30-36, 50-70, 72-80: 38 us;
    # frame 2 (100-180) 110-114, 130-136, 150-170, 172-175: 33 us
    assert spans.idle_s(t, "sj.frame") == pytest.approx((42 + 47) * 1e-6)
    assert spans.idle_s(t, "sj.step") is None


def test_frame_readers():
    run = _run("frame", _trace(FRAME_HOST, FRAME_KERNELS, 2))
    want = {"project_ms_per_frame": 4e-3, "bin_ms_per_frame": 6e-3,
            "gather_ms_per_frame": 20e-3, "host_ms_per_frame": 80e-3,
            "enqueue_idle_ms_per_frame": 44.5e-3}
    for name, value in want.items():
        assert _reader(name).read(run) == pytest.approx(value), name
        assert _reader(name).read(_run("step", run.trace)) is None
    bare = _run("frame", _trace([("h100_bench.window", 0.0, 200.0)],
                                FRAME_KERNELS, 2))
    for name in want:
        assert _reader(name).read(bare) is None, name


STEP_HOST = [
    ("h100_bench.window", 0.0, 200.0), ("sj.step", 0.0, 190.0),
    ("sj.project", 0.0, 10.0), ("sj.bin", 10.0, 10.0),
    ("sj.gather", 20.0, 10.0), ("sj.loss", 40.0, 10.0),
    ("sj.loss_bwd", 50.0, 10.0), ("sj.render_bwd", 60.0, 100.0),
    ("sj.rasterize_bwd", 70.0, 20.0), ("sj.gather_bwd", 100.0, 20.0),
    ("Optimizer.step#Adam.step", 170.0, 10.0),
]
STEP_KERNELS = [
    ("proj", 1.0, 5.0, 1.0), ("sort", 11.0, 5.0, 11.0),
    ("gather", 21.0, 7.0, 21.0), ("conv", 41.0, 3.0, 41.0),
    ("dgrad", 51.0, 2.0, 51.0), ("assemble_bwd", 61.0, 1.0, 61.0),
    ("k4", 71.0, 11.0, 71.0), ("k7", 101.0, 13.0, 101.0),
    ("proj_bwd", 130.0, 17.0, 130.0), ("adam", 171.0, 5.0, 171.0),
]


def test_step_readers():
    run = _run("step", _trace(STEP_HOST, STEP_KERNELS, 1))
    want = {"project_ms_per_step": (5 + 1 + 17) * 1e-3,
            "gather_ms_per_step": (7 + 13) * 1e-3,
            "loss_layer_ms_per_step": (3 + 2) * 1e-3}
    for name, value in want.items():
        assert _reader(name).read(run) == pytest.approx(value), name
        assert _reader(name).read(_run("frame", run.trace)) is None
    # a program without the backward's spans gives none of them
    fwd_only = [h for h in STEP_HOST if not h[0].endswith("_bwd")]
    bare = _run("step", _trace(fwd_only, STEP_KERNELS, 1))
    for name in want:
        assert _reader(name).read(bare) is None, name


def test_live_rows(monkeypatch):
    from splatjax_torch import trace as program

    recs = [program.Record("sj.frame", 0, {"instances": [5000],
                                           "rows": [4096]}),
            program.Record(None, 1, {"rows": [7]}),
            program.Record("sj.frame", 2, {"instances": [1024],
                                           "rows": [4096]}),
            program.Record("sj.frame", 3, {}),
            program.Record("sj.step", 4, {"instances": [3000],
                                          "rows": [4096]})]
    monkeypatch.setattr(program, "records", lambda: list(recs))
    frames = _run("frame", _trace(FRAME_HOST, FRAME_KERNELS, 2))
    steps = _run("step", _trace(STEP_HOST, STEP_KERNELS, 1))
    frame_reader = _reader("live_rows_pct.frame")
    step_reader = _reader("live_rows_pct.step")
    # the window's two frames: the index-2 rebuild and a redraw
    assert [r.index for r in spans.records(frames, "sj.frame")] == [2, 3]
    assert frame_reader.read(frames) == pytest.approx(25.0)
    assert step_reader.read(steps) == pytest.approx(100.0 * 3000 / 4096)
    assert step_reader.read(frames) is None
    # more window frames than records: nothing to read
    many = _run("frame", _trace(FRAME_HOST, FRAME_KERNELS, 5))
    assert frame_reader.read(many) is None
    monkeypatch.setattr(program, "records", lambda: [])
    assert frame_reader.read(frames) is None
