"""The port's spans and counters (:mod:`splatjax_torch.trace`) on the CPU
at tiny sizes: which spans a viewer frame and a training step make and how
they nest in the profiler's Chrome trace, one counter record per frame or
step, the training step's split backward bit-equal to one
``loss.backward()``, and nothing made or kept without a profiler."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import splatjax_torch as st
from splatjax_torch import trace
from splatjax_torch.io.synthetic import synthetic_scene
from splatjax_torch.train.fit import FitConfig, _optimizer, make_train_step
from splatjax_torch.train.loss import combined_loss, psnr

W = H = 32
CAPACITY = 1024
EPS_US = 0.002          # the Chrome trace's microsecond rounding


def _scene():
    return synthetic_scene(40, seed=7, extent=0.6, scale_range=(0.03, 0.1),
                           device="cpu")


def _cam(eye=(0.0, 0.0, 2.4)):
    return st.make_camera(eye, (0, 0, 0), width=W, height=H, device="cpu")


def _spans(prof, tmp_path):
    """(name, start, end) of every ``sj.*`` annotation in the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e["name"].startswith("sj."))


def _inside(outer, spans) -> list:
    """The names of the spans that lie within ``outer``, in time order."""
    _, a, b = outer
    return [n for n, s, e in sorted(spans, key=lambda x: x[1])
            if (n, s, e) != outer and s >= a - EPS_US and e <= b + EPS_US]


def _new_records(before: int) -> list:
    return trace.records()[before:]


def test_flag_flips_inside_a_profiler():
    assert not trace._recording()
    assert trace.span("sj.x") is trace.span("sj.y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace._recording()
        assert trace.span("sj.x") is not trace.span("sj.y")
    assert not trace._recording()


def test_exact_frame_spans_and_counters(tmp_path):
    scene, cam = _scene(), _cam()
    r = st.SplatRenderer(scene=scene, capacity=CAPACITY, device="cpu")
    bins = st.bin_scene(scene, cam, capacity=CAPACITY)
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            r.render(cam)
    spans = _spans(prof, tmp_path)
    frames = [s for s in spans if s[0] == "sj.frame"]
    assert len(frames) == 2
    for f in frames:
        assert _inside(f, spans) == ["sj.project", "sj.bin", "sj.gather"]
    recs = _new_records(before)
    assert [rec.name for rec in recs] == ["sj.frame"] * 2
    assert recs[1].index == recs[0].index + 1
    for rec in recs:
        assert rec.get("instances") == int(bins.num_instances) > 0
        assert rec.get("rows") == CAPACITY
        # the count is the last of the scene's cumulative sum of instances:
        # the record keeps its 8 bytes, not the sum
        (kept,) = rec.values["instances"]
        assert kept.untyped_storage().nbytes() == kept.element_size()


@pytest.mark.parametrize("feature_bytes,redraw", [
    (16, []),                # the redraw is K3 alone
    (32, ["sj.project"]),    # a projection of the cached rows, then K2
])
def test_stale_order_frames(tmp_path, feature_bytes, redraw):
    """A rebuild and a redraw at ``resort_interval`` 8."""
    scene, cam = _scene(), _cam()
    r = st.SplatRenderer(scene=scene, capacity=CAPACITY, resort_interval=8,
                         feature_bytes=feature_bytes, device="cpu")
    bins = st.bin_scene(scene, cam, capacity=CAPACITY)
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(cam)
        r.render(_cam((0.02, 0.0, 2.4)))
    spans = _spans(prof, tmp_path)
    frames = [s for s in spans if s[0] == "sj.frame"]
    assert len(frames) == 2
    # a rebuild draws as a redraw does, after the index and its cache
    assert _inside(frames[0], spans) == [
        "sj.project", "sj.bin", "sj.gather"] + redraw
    assert _inside(frames[1], spans) == redraw
    rebuild, redrawn = _new_records(before)
    assert rebuild.get("instances") == int(bins.num_instances) > 0
    assert rebuild.get("rows") == CAPACITY
    assert redrawn.name == "sj.frame" and redrawn.values == {}


def test_kept_counts_hold_no_larger_buffer():
    """A count that views a larger tensor is kept as a copy of its own, so
    the records, kept after the profiler stops, hold no (N,) buffer."""
    cum = torch.arange(10_000, dtype=torch.int64).cumsum(0)
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count(instances=cum[-1])
    (rec,) = _new_records(before)
    assert rec.name is None
    (kept,) = rec.values["instances"]
    assert kept.untyped_storage().nbytes() == 8
    assert rec.get("instances") == int(cum[-1])


def _fit_start():
    g = torch.Generator().manual_seed(11)
    n = 30
    return dict(
        means=(torch.rand((n, 3), generator=g) - 0.5),
        log_scales=torch.full((n, 3), -2.5),
        quats=torch.tensor([[1.0, 0, 0, 0]])
        + 0.01 * torch.randn((n, 4), generator=g),
        logit_opacities=torch.full((n,), -1.0),
        colors=0.3 * torch.randn((n, 3), generator=g))


def _target(cam):
    with torch.no_grad():
        return st.render(_scene(), cam, capacity=CAPACITY)


def test_train_step_spans(tmp_path):
    cam = _cam()
    cfg = FitConfig(capacity=CAPACITY)
    params = st.TrainableGaussians(**_fit_start())
    opt = _optimizer(params, cfg)
    step = make_train_step([cam], cfg, CAPACITY)
    target = _target(cam)
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, cam.modelview, cam.projection, target)
    spans = _spans(prof, tmp_path)
    (root,) = [s for s in spans if s[0] == "sj.step"]
    assert _inside(root, spans) == [
        "sj.project", "sj.bin", "sj.gather", "sj.loss", "sj.loss_bwd",
        "sj.render_bwd", "sj.rasterize_bwd", "sj.gather_bwd"]
    (bwd,) = [s for s in spans if s[0] == "sj.render_bwd"]
    assert _inside(bwd, spans) == ["sj.rasterize_bwd", "sj.gather_bwd"]
    (loss_bwd,) = [s for s in spans if s[0] == "sj.loss_bwd"]
    assert _inside(loss_bwd, spans) == []
    (rec,) = _new_records(before)
    assert rec.name == "sj.step" and rec.get("rows") == CAPACITY
    assert rec.get("instances") > 0


def test_split_backward_is_bit_equal():
    """The step's two backward calls give the gradients and the update of
    one ``loss.backward()``, bit for bit, over two steps."""
    cam = _cam()
    cfg = FitConfig(capacity=CAPACITY)
    target = _target(cam)
    a = st.TrainableGaussians(**_fit_start())
    b = st.TrainableGaussians(**_fit_start())
    opt_a, opt_b = _optimizer(a, cfg), _optimizer(b, cfg)
    step = make_train_step([cam], cfg, CAPACITY)

    def one_backward(params, opt):
        opt.zero_grad(set_to_none=True)
        img = st.render(params.to_scene(), cam, capacity=CAPACITY,
                        alpha_clip=cfg.alpha_clip, early_stop=cfg.early_stop,
                        feature_bytes=cfg.feature_bytes)
        loss = combined_loss(img, target, ssim_weight=cfg.ssim_weight)
        loss.backward()
        opt.step()
        with torch.no_grad():
            return loss.detach(), psnr(img, target), \
                params.means.grad.norm(dim=-1)

    for _ in range(2):
        got = step(a, opt_a, cam.modelview, cam.projection, target)
        want = one_backward(b, opt_b)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p.grad, q.grad), name
            assert torch.equal(p, q), name
    assert float(got[0]) > 0


def test_nothing_without_a_profiler(monkeypatch):
    """No profiler: no annotation is made and no record is kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    scene, cam = _scene(), _cam()
    before = trace.records()
    st.SplatRenderer(scene=scene, capacity=CAPACITY, device="cpu").render(cam)
    stale = st.SplatRenderer(scene=scene, capacity=CAPACITY, device="cpu",
                             resort_interval=8, feature_bytes=16)
    stale.render(cam)
    stale.render(cam)
    cfg = FitConfig(capacity=CAPACITY)
    params = st.TrainableGaussians(**_fit_start())
    make_train_step([cam], cfg, CAPACITY)(
        params, _optimizer(params, cfg), cam.modelview, cam.projection,
        _target(cam))
    trace.count(rows=1)
    after = trace.records()
    assert len(after) == len(before)
    assert all(x is y for x, y in zip(after, before))
