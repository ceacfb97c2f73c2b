"""The band cell's readers on a hand-made trace of two band steps: the
collective spans' kernels, NCCL's kernels inside them only, the pair
counters, and None where the program made no such span or kept no such
counter (the program before it had spans in ``parallel/``)."""
import pytest

import harness
from conftest import BENCH
from profiling import Trace

# two steps of 100 us; the first step's all_reduce of the losses lies
# outside every collective span and must not count as NCCL's
BAND_HOST = [
    ("h100_bench.window", 0.0, 200.0),
    ("sj.step", 0.0, 95.0), ("sj.redistribute", 5.0, 10.0),
    ("sj.band_gather", 20.0, 5.0), ("sj.band_gather_bwd", 40.0, 5.0),
    ("sj.redistribute_bwd", 50.0, 10.0), ("sj.grad_reduce", 70.0, 10.0),
    ("sj.step", 100.0, 95.0), ("sj.redistribute", 105.0, 10.0),
    ("sj.band_gather", 120.0, 5.0), ("sj.band_gather_bwd", 140.0, 5.0),
    ("sj.redistribute_bwd", 150.0, 10.0), ("sj.grad_reduce", 170.0, 10.0),
]
# (name, start, dur, launch) in us
BAND_KERNELS = [
    ("sort", 6.0, 2.0, 6.0), ("ncclDevKernel_SendRecv", 9.0, 4.0, 8.0),
    ("ncclDevKernel_AllGather_RING_LL", 21.0, 3.0, 21.0),
    ("k2", 26.0, 10.0, 26.0),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 41.0, 2.0, 41.0),
    ("ncclDevKernel_SendRecv", 51.0, 4.0, 51.0), ("gather", 56.0, 3.0, 56.0),
    ("cat", 71.0, 1.0, 71.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 72.0, 6.0, 72.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 90.0, 1.0, 90.0),
    ("sort", 106.0, 2.0, 106.0), ("ncclDevKernel_SendRecv", 109.0, 4.0, 108.0),
    ("ncclDevKernel_AllGather_RING_LL", 121.0, 3.0, 121.0),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 141.0, 2.0, 141.0),
    ("ncclDevKernel_SendRecv", 151.0, 4.0, 151.0),
    ("gather", 156.0, 3.0, 156.0), ("cat", 171.0, 1.0, 171.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 172.0, 6.0, 172.0),
]
READERS = ("redistribute_ms_per_step", "band_gather_ms_per_step",
           "grad_reduce_ms_per_step", "nccl_ms_per_step", "pair_fill_pct")


def _trace(host, kernels=BAND_KERNELS, units=2):
    device = [(n, "kernel", s, d) for n, s, d, _ in kernels]
    return Trace((0.0, 200.0), device, kernels, host, units)


def _run(trace, unit="step"):
    return harness.Run(unit=unit, attempted=trace.units, failed=0,
                       durations=[1e-4] * trace.units, window_s=2e-4,
                       setup_s=1.0, checks={}, memory_peak_bytes=0,
                       trace=trace)


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"test_band_reader_{name}")


def test_collective_span_readers():
    run = _run(_trace(BAND_HOST))
    # per step: redistribute 2 + 4 and 4 + 3; tiles 3 and 2; gradient
    # 1 + 6; NCCL 4 + 3 + 2 + 4 + 6 (the losses' all_reduce is outside)
    want = {"redistribute_ms_per_step": 13e-3,
            "band_gather_ms_per_step": 5e-3,
            "grad_reduce_ms_per_step": 7e-3,
            "nccl_ms_per_step": 19e-3}
    for name, value in want.items():
        assert _reader(name).read(run) == pytest.approx(value), name
        assert _reader(name).read(_run(run.trace, "frame")) is None, name


def test_readers_without_the_spans():
    bare = _run(_trace([("h100_bench.window", 0.0, 200.0),
                        ("sj.step", 0.0, 95.0), ("sj.step", 100.0, 95.0)]))
    for name in READERS:
        assert _reader(name).read(bare) is None, name
    untraced = harness.Run(unit="step", attempted=2, failed=0,
                           durations=[1e-4] * 2, window_s=2e-4, setup_s=1.0,
                           checks={}, memory_peak_bytes=0)
    for name in READERS:
        assert _reader(name).read(untraced) is None, name
    # a backward span missing: no redistribution or band-gather reading
    fwd_only = [h for h in BAND_HOST if not h[0].endswith("_bwd")]
    run = _run(_trace(fwd_only))
    assert _reader("redistribute_ms_per_step").read(run) is None
    assert _reader("band_gather_ms_per_step").read(run) is None
    assert _reader("grad_reduce_ms_per_step").read(run) == \
        pytest.approx(7e-3)


def test_pair_fill(monkeypatch):
    from splatjax_torch import trace as program

    recs = [program.Record("sj.step", 0, {"pair_rows": [900],
                                          "pair_capacity_rows": [1000]}),
            program.Record("sj.frame", 1, {"pair_rows": [7]}),
            program.Record("sj.step", 2, {"pair_rows": [300],
                                          "pair_capacity_rows": [1000],
                                          "instances": [50]}),
            program.Record("sj.step", 3, {"pair_rows": [500],
                                          "pair_capacity_rows": [1000]})]
    monkeypatch.setattr(program, "records", lambda: list(recs))
    reader = _reader("pair_fill_pct")
    # the window's two steps are the last two step records
    assert reader.read(_run(_trace(BAND_HOST))) == pytest.approx(40.0)
    assert reader.read(_run(_trace(BAND_HOST), "frame")) is None
    monkeypatch.setattr(program, "records", lambda: [
        program.Record("sj.step", 4, {"instances": [5]}),
        program.Record("sj.step", 5, {"instances": [5]})])
    assert reader.read(_run(_trace(BAND_HOST))) is None


BAND = "sharded_4m_4k.band_step"


def test_band_cell_is_correct_and_traced():
    from conftest import run_tiny

    _, run, res = run_tiny(BAND, seconds=1.0)
    assert res["correct"], res["checks"]
    assert run.attempted > 0 and run.failed == 0
    assert res["checks"]["rank_mismatch"]["value"] == 0
    _, run, res = run_tiny(BAND, trace=True)
    assert res["correct"], res["checks"]
    assert run.trace is not None and run.trace.units == 2
    assert set(READERS) <= set(res["metrics"])
    assert 0 < res["metrics"]["pair_fill_pct"]["value"] <= 100


def test_band_controls_are_not_correct():
    import control_band
    from conftest import SEED, tiny

    cell = tiny(BAND)
    band = harness.Bench(BENCH.parent).driver(cell)
    for row in control_band._readings(band, cell, SEED, "cpu"):
        got = {k: row[k] for k in ("loss_gap", "grad_gap", "change_gap")}
        ok, shown = harness.judge({**got, "rank_mismatch": 0}, cell.limits)
        assert not ok, (row["control"], shown)
