"""``correct`` at tiny sizes on the CPU: the port against the reference
comes out true; the control and each fault a cell can have, planted
under the timed path, come out false."""
import json

import pytest
import torch

import harness
from conftest import BENCH, SEED, run_tiny, tiny

CELLS = ("viewer_1m_1080p.jump", "viewer_1m_1080p.orbit", "m360_3m_sh3.fit")


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    _, run, res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert run.attempted > 0 and run.failed == 0
    for n, c in res["checks"].items():
        assert c["value"] <= c["limit"], n


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    _, run, res = run_tiny(name, trace=True)
    assert res["correct"], res["checks"]
    assert run.trace is not None and run.trace.units > 0
    assert res["device"]["window_s"] > 0
    assert list(res)[-1] == "checks"


def _limits(name):
    return json.loads((BENCH / "limits" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import control

    cell = tiny(name)
    driver = harness.Bench(BENCH.parent).driver(cell)
    if cell.traffic["driver"] == "frames":
        got = control.frames_control(driver, cell, SEED, "cpu")
    else:
        got = control.steps_control(driver, cell, SEED, "cpu")
    ok, shown = harness.judge(got, _limits(name))
    assert not ok, shown


def test_fit_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    _, run, res = run_tiny("m360_3m_sh3.fit")
    assert not res["correct"]
    assert run.checks["change_gap"] == pytest.approx(1.0)


def test_fit_fault_half_the_image(monkeypatch):
    import importlib

    fit = importlib.import_module("splatjax_torch.train.fit")
    real = fit.combined_loss

    def half(pred, target, **kw):
        h = pred.shape[0] // 2
        return real(pred[:h], target[:h], **kw)

    monkeypatch.setattr(fit, "combined_loss", half)
    _, _, res = run_tiny("m360_3m_sh3.fit")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS[:2])
def test_frame_fault_answer_altered(name, monkeypatch):
    import splatjax_torch.viewer as viewer

    real = viewer.SplatRenderer.render

    def altered(self, camera, **kw):
        out = real(self, camera, **kw)
        img = out[0] if isinstance(out, tuple) else out
        img[:16, :16, :3] += 0.01      # one tile's worth of pixels
        return out

    monkeypatch.setattr(viewer.SplatRenderer, "render", altered)
    _, _, res = run_tiny(name)
    assert not res["correct"], res["checks"]
