"""The (view x band) training step against the benchmark's plain
mean-view reference, and the spans and counters of
``splatjax_torch.parallel``, on a 4-rank gloo group.

The ranks (``test_torch_parallel``'s :class:`RankRun`) run
``make_dp_band_train_step`` on a (view 2, band 2) mesh for 3 steps over
4,096 seeded random splats with SH 3 at 128x96 on 16-byte rows, step j
rendering views 2j and 2j + 1 of 6; this process runs
``h100_bench/reference_band.py`` (loaded by path; plain torch, no code of
the port) from the same numpy inputs. This module imports no jax and
nothing of the benchmark at its top, because each rank imports it.

Tolerances, each with its reason (measured here, worst leaf: loss
2.8e-7, first gradient 2.5e-3 (quats), change 2.9e-2 (quats)):

* loss, relative a step, 1e-5: the band render and the reference blend
  the same rounded rows in the same order; only the early stop's chunk
  boundaries (each band's own lists against the whole view's) and f32
  sums in another order part them.
* first gradient, per leaf, ``|program - reference| / |reference|``,
  5e-3: the 16-byte rows' gradients are summed from bfloat16 pairs (K7's
  format), ~2^-8 of a row each, which the reference keeps in f32.
* change over the 3 steps, per leaf, the same ratio, 0.1: Adam's first
  steps move each element by about its learning rate whatever the size
  of its gradient, so an element whose gradient is near zero moves by a
  full step on either side of a rounding (quats and log scales read
  2.5-3e-2).

A mean that drops one view of each step fails all three (measured: loss
2.8e-3-2.1e-2, first gradient 0.45-0.66, change 0.82-0.90).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import RankRun, _get

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
N, W, H = 4096, 128, 96
STEPS = 3
EYES = ((-0.6, 0.1, 2.3), (0.5, -0.2, 2.4), (0.0, 0.4, 2.5),
        (0.3, 0.3, 2.2), (-0.3, -0.3, 2.4), (0.7, 0.2, 2.1))
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors",
          "sh")
LR = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats",
      "logit_opacities": "lr_opacities", "colors": "lr_colors",
      "sh": "lr_sh"}
TOL = {"loss": 1e-5, "grad": 5e-3, "change": 0.1}
SPANS = ("sj.step", "sj.redistribute", "sj.redistribute_bwd",
         "sj.band_gather", "sj.band_gather_bwd", "sj.grad_reduce")


# -- inputs shared by the ranks and the reference -----------------------------

def _raw():
    """The start's raw leaves (numpy, float32)."""
    rng = np.random.default_rng(23)
    f = np.float32
    return dict(
        means=rng.uniform(-0.7, 0.7, (N, 3)).astype(f),
        log_scales=np.log(rng.uniform(0.01, 0.06, (N, 3))).astype(f),
        quats=rng.normal(size=(N, 4)).astype(f),
        logit_opacities=rng.normal(0.0, 1.5, N).astype(f),
        colors=rng.normal(size=(N, 3)).astype(f),
        sh=rng.normal(0.0, 0.1, (N, 15, 3)).astype(f),
    )


def _targets():
    return np.random.default_rng(24).random(
        (len(EYES), H, W, 4)).astype(np.float32)


def _cams():
    import splatjax_torch as st

    return [st.make_camera(e, (0, 0, 0), width=W, height=H, device="cpu")
            for e in EYES]


def _views(j):
    return [(2 * j) % len(EYES), (2 * j + 1) % len(EYES)]


def _fit():
    from splatjax_torch.train.fit import FitConfig

    return FitConfig(feature_bytes=16)


# -- the ranks ---------------------------------------------------------------

def _band_step():
    from splatjax_torch.parallel import make_dp_band_train_step, make_mesh_2d
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train.fit import _optimizer

    cams, cfg = _cams(), _fit()
    params = TrainableGaussians(**{k: torch.from_numpy(v)
                                   for k, v in _raw().items()})
    mesh = make_mesh_2d((2, 2), ("view", "band"), device="cpu")
    step = make_dp_band_train_step(cams, cfg, mesh, view_axis="view",
                                   band_axis="band")
    mvs = torch.stack([c.modelview for c in cams])
    prs = torch.stack([c.projection for c in cams])
    tgs = torch.from_numpy(_targets())

    def one(j):
        v = _views(j)
        return step(params, opt, mvs[v], prs[v], tgs[v])

    opt = _optimizer(params, cfg)
    return params, one


def _case_ref(rank):
    params, one = _band_step()
    out = {"loss": [], "drops": []}
    for j in range(STEPS):
        loss, _, _, drops = one(j)
        out["loss"].append(float(loss))
        out["drops"].append(int(drops))
        if j == 0:
            for name, p in params.named_parameters():
                out[f"grad/{name}"] = p.grad.clone()
    for name, p in params.named_parameters():
        out[f"param/{name}"] = p.detach().clone()
    return out


def _case_spans(rank):
    from torch.profiler import ProfilerActivity, profile

    from splatjax_torch import trace

    params, one = _band_step()
    before = len(trace.records())
    one(0)
    unrecorded = len(trace.records()) - before
    sends = []
    real = dist.all_to_all_single

    def spy(out, x, *args, **kw):
        sends.append(x.detach().clone())
        return real(out, x, *args, **kw)

    dist.all_to_all_single = spy
    try:
        before = len(trace.records())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for j in (1, 2):
                one(j)
    finally:
        dist.all_to_all_single = real
    names = [e.name for e in prof.events()]
    recs = [r for r in trace.records()[before:] if r.name == "sj.step"]
    # each step exchanges its send buffer, then (backward) its cotangent;
    # a sent row holds a gaussian that survived the culls (mask column 1)
    fwd = sends[0::2]
    return {"spans": [names.count(n) for n in SPANS],
            "unrecorded": unrecorded,
            "pair_rows": [r.get("pair_rows") for r in recs],
            "sent_rows": [int((s[:, 12] > 0.5).sum()) for s in fwd],
            "pair_capacity_rows": [r.get("pair_capacity_rows")
                                   for r in recs],
            "send_buffer_rows": [s.shape[0] for s in fwd]}


_CASES = {"ref": _case_ref, "spans": _case_spans}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = RankRun(__name__, tmp_path_factory.mktemp("ranks"))
    yield run
    run.outputs()


# -- the reference ------------------------------------------------------------

def _reference_band():
    """``h100_bench/reference_band.py``, loaded by path (it imports its
    sibling ``reference`` by name)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    spec = importlib.util.spec_from_file_location(
        "test_reference_band", BENCH / "reference_band.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 3 steps, with the two views' mean and with the
    second view dropped from it (each step given its first view alone):
    (losses, first gradient, change) each."""
    rb = _reference_band()
    import reference

    cfg, cams, tgs = _fit(), _cams(), torch.from_numpy(_targets())
    views = [reference.View(c.modelview, c.projection, W, H, 16)
             for c in cams]
    lrs = {k: getattr(cfg, LR[k]) for k in LEAVES}
    out = {}
    for label, kept in (("mean", 2), ("dropped", 1)):
        raw = {k: torch.from_numpy(v) for k, v in _raw().items()}
        start = {k: v.clone() for k, v in raw.items()}
        steps = [_views(j)[:kept] for j in range(STEPS)]
        losses, grad, _ = rb.run_steps(
            raw, lrs, [[views[v] for v in s] for s in steps],
            [[tgs[v] for v in s] for s in steps], STEPS,
            rows="16", alpha_clip=cfg.alpha_clip, early_stop=cfg.early_stop,
            ssim_weight=cfg.ssim_weight)
        out[label] = (losses, {k: g.numpy() for k, g in grad.items()},
                      {k: (raw[k] - start[k]).numpy() for k in LEAVES})
    return out


def _gaps(ranks, ref):
    """The program's worst relative miss of each compared quantity."""
    losses, grad, change = ref
    start = _raw()
    prog_loss = _get(ranks, "ref", "loss")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    return {
        "loss": max(abs(p - r) / abs(r) for p, r in zip(prog_loss, losses)),
        "grad": max(rel(_get(ranks, "ref", f"grad/{k}"), grad[k])
                    for k in LEAVES),
        "change": max(rel(_get(ranks, "ref", f"param/{k}") - start[k],
                          change[k]) for k in LEAVES),
    }


# -- tests -------------------------------------------------------------------

def test_band_step_matches_the_mean_view_reference(ranks, reference_runs):
    assert list(_get(ranks, "ref", "drops")) == [0] * STEPS
    gaps = _gaps(ranks, reference_runs["mean"])
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_a_mean_that_drops_a_view_misses_the_tolerances(ranks,
                                                        reference_runs):
    gaps = _gaps(ranks, reference_runs["dropped"])
    assert all(gaps[k] > TOL[k] for k in TOL), gaps


def test_collective_spans_once_a_step(ranks):
    assert list(_get(ranks, "spans", "spans")) == [2] * len(SPANS)


def test_pair_counters_read_the_send_buffer(ranks):
    outs = ranks.outputs()
    for r in range(4):
        got = outs[r]
        assert list(got["spans/pair_rows"]) == list(got["spans/sent_rows"])
        assert list(got["spans/pair_capacity_rows"]) == list(
            got["spans/send_buffer_rows"])
        assert 0 < min(got["spans/pair_rows"])


def test_nothing_recorded_without_a_profiler(ranks):
    assert int(_get(ranks, "spans", "unrecorded")) == 0
