"""Port parity, multi-card training: ``make_dp_train_step``,
``make_dp_band_train_step`` and ``fit(mesh=..., band_axis=...)`` (with a
densify pass) on a 4-rank gloo group against splatjax's on the same numpy
inputs, over a JAX mesh of the same size. The ranks run this module's
``_CASES`` through ``test_torch_parallel``'s harness; jax is imported
inside the tests only.

Tolerances (``test_torch_train.py``'s): per leaf, the parameters within
half that leaf's learning rate of splatjax's, after one step and after a
fit of several; the moves at cosine > 0.999 over the elements splatjax
moved by at least half a step (the band case's quaternions do not move:
its scales are isotropic, so the rotation has no gradient); the logged
losses within 1e-3 relative; the densify report equal. Measured: 0.011
lr after one step (the DP step's colors), 0.255 lr after the densify fit
(its means). The step functions are bit-equal to ``fit``'s first step,
and every rank's outputs bit-identical.
"""
import numpy as np
import pytest
import torch

from test_torch_parallel import (
    LEAVES,
    LR,
    RankRun,
    _get,
    _j_cam,
    _j_scene,
    _leaves,
    _t_cam,
    _t_scene,
)

DP_VIEWS = [((0.5 * np.cos(a), 0.2, 2.0 + 0.3 * np.sin(a)), 48, 32)
            for a in np.linspace(0, 1.5, 8)]
DP_FIT = dict(log_every=1, capacity=2048, early_stop=0.0, feature_bytes=32)
# one densify pass after step 1 over test_torch_densify's 300-row start
BAND_VIEWS = ((0, 0, 2.0), (0.6, 0.3, 1.9))
BAND_FIT = dict(log_every=1, capacity=4096, feature_bytes=32)
DENSE_KW = dict(start=0, stop=1, every=2, grad_threshold=2.2e-5,
                split_scale=0.06)
ROUTE_VIEWS = [(0.3 * i - 0.3, 0.1, 2.1) for i in range(2)]


def _targets(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.random(shape).astype(np.float32) for _ in range(n)]


def _dense_leaves():
    """Every 10th gaussian nearly transparent, half small, half large."""
    n = 300
    rng = np.random.default_rng(5)
    logit = np.full((n,), -1.0, np.float32)
    logit[::10] = -6.0
    scale = np.where(np.arange(n) % 2 == 0, 0.03, 0.12).astype(np.float32)
    quats = np.array([[1, 0, 0, 0]], np.float32) + 0.01 * np.random \
        .default_rng(6).normal(size=(n, 4))
    return dict(
        means=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        log_scales=np.repeat(np.log(scale)[:, None], 3, axis=1),
        quats=quats.astype(np.float32),
        logit_opacities=logit,
        colors=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32))


def _band_targets():
    """The 60-splat target scene rendered by the port in both views (the
    references take the same arrays)."""
    import splatjax_torch as st

    scene = _t_scene(60, 41, extent=0.5, scale_range=(0.05, 0.12),
                     opacity_range=(0.6, 1.0))
    return [st.render(scene, _t_cam(e, 48, 32)).numpy() for e in BAND_VIEWS]


# -- the ranks ---------------------------------------------------------------

def _stack_views(cams):
    return (torch.stack([c.modelview for c in cams]),
            torch.stack([c.projection for c in cams]))


def _case_dp(rank):
    from splatjax_torch.parallel import make_mesh
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train import FitConfig, fit, make_dp_train_step
    from splatjax_torch.train.fit import _optimizer

    cams = [_t_cam(e, w, h) for e, w, h in DP_VIEWS]
    targets = [torch.from_numpy(t) for t in _targets((32, 48, 4), 3, 8)]
    scene = _t_scene(256, 97)
    mesh = make_mesh(4, device="cpu")
    cfg = FitConfig(steps=1, **DP_FIT)
    params = TrainableGaussians.from_scene(scene)
    step = make_dp_train_step(cams, cfg, 2048, mesh)
    loss, _, gnorm = step(params, _optimizer(params, cfg),
                          *_stack_views(cams[:4]), torch.stack(targets[:4]))
    out = {f"step/{k}": v for k, v in _leaves(params).items()}
    one, _ = fit(TrainableGaussians.from_scene(scene), cams, targets, cfg,
                 mesh=mesh)
    out["step_is_fit"] = all(torch.equal(getattr(one, k),
                                         getattr(params, k)) for k in LEAVES)
    two, hist = fit(TrainableGaussians.from_scene(scene), cams, targets,
                    FitConfig(steps=2, **DP_FIT), mesh=mesh)
    out.update({f"fit/{k}": v for k, v in _leaves(two).items()})
    out["loss"] = [h["loss"] for h in hist]
    out["step_loss"], out["gnorm"] = loss, gnorm
    return out


def _case_band(rank):
    import splatjax_torch as st
    from splatjax_torch.parallel import make_dp_band_train_step, make_mesh_2d
    from splatjax_torch.train import DensifyConfig, FitConfig, fit
    from splatjax_torch.train.fit import _optimizer

    cams = [_t_cam(e, 48, 32) for e in BAND_VIEWS]
    targets = [torch.from_numpy(t) for t in _band_targets()]
    mesh = make_mesh_2d((2, 2), ("view", "band"), device="cpu")
    axes = dict(dp_axis="view", band_axis="band")
    cfg = FitConfig(steps=1, **BAND_FIT)

    def start():
        return st.trainable_from_numpy(_dense_leaves(), device="cpu")

    params = start()
    step = make_dp_band_train_step(cams, cfg, mesh, view_axis="view",
                                   band_axis="band", capacity=4096)
    loss, _, gnorm, drops = step(params, _optimizer(params, cfg),
                                 *_stack_views(cams), torch.stack(targets))
    out = {f"step/{k}": v for k, v in _leaves(params).items()}
    one, _ = fit(start(), cams, targets, cfg, mesh=mesh, **axes)
    out["step_is_fit"] = all(torch.equal(getattr(one, k),
                                         getattr(params, k)) for k in LEAVES)
    events = []
    grown, hist = fit(start(), cams, targets, FitConfig(steps=4, **BAND_FIT),
                      densify=DensifyConfig(**DENSE_KW), densify_seed=4,
                      log_fn=events.append, mesh=mesh, **axes)
    out.update({f"fit/{k}": v for k, v in _leaves(grown).items()})
    keys = ("cloned", "split", "pruned", "alive", "capacity")
    out["report"] = [[e["densify"][k] for k in keys] for e in events
                     if "densify" in e]
    out["loss"] = [h["loss"] for h in hist]
    out["drops"] = [h["drops"] for h in hist]
    out["step_drops"], out["gnorm"] = drops, gnorm
    return out


def _case_route(rank):
    """fit on the view x band mesh: the loss falls, drops are recorded,
    two steps per call run the same steps, a run cut after its step-4
    checkpoint and resumed ends where an uninterrupted one does, and a
    row count the band size does not divide is refused."""
    import splatjax_torch as st
    from splatjax_torch.parallel import make_mesh_2d
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train import FitConfig, fit

    cams = [_t_cam(e, 48, 32) for e in ROUTE_VIEWS]
    scene = _t_scene(64, 171)
    targets = [st.render(scene, c, early_stop=0.0) for c in cams]
    start = _t_scene(64, 172, scale_range=(0.03, 0.08))
    kw = dict(mesh=make_mesh_2d((2, 2), ("view", "band"), device="cpu"),
              dp_axis="view", band_axis="band")
    base = dict(steps=8, log_every=2, capacity=2048, lr_means=2e-3)
    p1, h1 = fit(TrainableGaussians.from_scene(start), cams, targets,
                 FitConfig(**base), **kw)
    p2, h2 = fit(TrainableGaussians.from_scene(start), cams, targets,
                 FitConfig(**base, steps_per_call=2), **kw)
    ck = dict(checkpoint_dir="route_ckpt", checkpoint_every=4)
    fit(TrainableGaussians.from_scene(start), cams, targets,
        FitConfig(**{**base, "steps": 4}), **ck, **kw)
    p3, h3 = fit(TrainableGaussians.from_scene(start), cams, targets,
                 FitConfig(**base), resume=True, **ck, **kw)
    odd = TrainableGaussians.from_scene(_t_scene(63, 173))
    try:
        fit(odd, cams, targets, FitConfig(steps=1, capacity=2048), **kw)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"loss": [h["loss"] for h in h1],
            "steps": [h["step"] for h in h1],
            "drops": [h["drops"] for h in h1 + h2],
            "k2_equal": all(torch.equal(getattr(p1, k), getattr(p2, k))
                            for k in LEAVES),
            "resumed_steps": [h["step"] for h in h3],
            "resumed_equal": all(torch.equal(getattr(p1, k),
                                             getattr(p3, k))
                                 for k in LEAVES),
            "refused": np.array(refused)}


_CASES = {"dp": _case_dp, "band": _case_band, "route": _case_route}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = RankRun(__name__, tmp_path_factory.mktemp("ranks"))
    yield run
    run.outputs()


# -- tests -------------------------------------------------------------------

def _close(got, ref, base, cfg):
    for k in LEAVES:
        a, b, a0 = np.asarray(getattr(ref, k)), got[k], base[k]
        assert a.shape == b.shape, k
        lr = getattr(cfg, LR[k])
        assert np.abs(a - b).max() <= 0.5 * lr, (k, np.abs(a - b).max())
        if a0.shape != a.shape:
            continue
        moved = np.abs(a - a0) >= 0.5 * lr
        if moved.any():
            da, db = (a - a0)[moved], (b - a0)[moved]
            cos = float(da @ db / (np.linalg.norm(da) * np.linalg.norm(db)))
            assert cos > 0.999, (k, cos)


def _j_fit(start, cams, targets, cfg, **kw):
    """splatjax's fit with the parameters after every step."""
    import jax.numpy as jnp
    from splatjax.train import fit

    snaps = []
    params, hist = fit(start, cams, [jnp.asarray(t) for t in targets], cfg,
                       checkpoint_every=1,
                       checkpoint_fn=lambda s, p: snaps.append(p), **kw)
    return snaps, hist


def test_dp_train_step_and_fit_match_splatjax(ranks):
    """make_dp_train_step's one step, and fit(mesh=make_mesh(4)) over 8
    views (steps take views 0-3, then 4-7)."""
    from splatjax.parallel import make_mesh
    from splatjax.scene import TrainableGaussians
    from splatjax.train import FitConfig

    cfg = FitConfig(steps=2, **DP_FIT)
    start = TrainableGaussians.from_scene(_j_scene(256, 97))
    snaps, hist = _j_fit(start, [_j_cam(e, w, h) for e, w, h in DP_VIEWS],
                         _targets((32, 48, 4), 3, 8), cfg,
                         mesh=make_mesh(4))
    base = {k: np.asarray(getattr(start, k)) for k in LEAVES}
    assert _get(ranks, "dp", "step_is_fit")
    _close({k: _get(ranks, "dp", f"step/{k}") for k in LEAVES},
                    snaps[0], base, cfg)
    np.testing.assert_allclose(_get(ranks, "dp", "step_loss"),
                               hist[0]["loss"], rtol=1e-3)
    np.testing.assert_allclose(_get(ranks, "dp", "loss"),
                               [h["loss"] for h in hist], rtol=1e-3)
    _close({k: _get(ranks, "dp", f"fit/{k}") for k in LEAVES},
               snaps[1], base, cfg)
    assert _get(ranks, "dp", "gnorm").shape == (256,)


def test_band_train_step_and_densify_fit_match_splatjax(ranks):
    """make_dp_band_train_step's one step, and fit on the (view, band)
    mesh with a densify pass after step 1: the same clones, splits,
    prunes and row growth as splatjax's."""
    import jax.numpy as jnp
    from splatjax.parallel import make_mesh_2d
    from splatjax.scene import TrainableGaussians
    from splatjax.train import DensifyConfig, FitConfig

    cfg = FitConfig(steps=4, **BAND_FIT)
    leaves = _dense_leaves()
    start = TrainableGaussians(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()})
    events = []
    snaps, hist = _j_fit(
        start, [_j_cam(e, 48, 32) for e in BAND_VIEWS], _band_targets(),
        cfg, densify=DensifyConfig(**DENSE_KW), densify_seed=4,
        log_fn=events.append, mesh=make_mesh_2d((2, 2), ("view", "band")),
        dp_axis="view", band_axis="band")
    assert _get(ranks, "band", "step_is_fit")
    _close({k: _get(ranks, "band", f"step/{k}") for k in LEAVES},
                    snaps[0], leaves, cfg)
    assert int(_get(ranks, "band", "step_drops")) == 0
    assert _get(ranks, "band", "gnorm").shape == (300,)
    keys = ("cloned", "split", "pruned", "alive", "capacity")
    want = [[e["densify"][k] for k in keys] for e in events
            if "densify" in e]
    report = _get(ranks, "band", "report")
    np.testing.assert_array_equal(report, want)
    cloned, split, pruned, _, capacity = report[0]
    assert len(report) == 1 and cloned > 0 and split > 0 and pruned > 0
    assert capacity == 1024 == _get(ranks, "band", "fit/means").shape[0]
    np.testing.assert_allclose(_get(ranks, "band", "loss"),
                               [h["loss"] for h in hist], rtol=1e-3)
    assert [h["drops"] for h in hist] == list(_get(ranks, "band", "drops"))
    _close({k: _get(ranks, "band", f"fit/{k}") for k in LEAVES},
               snaps[-1], leaves, cfg)


def test_fit_routes_to_view_band_mesh(ranks):
    loss = _get(ranks, "route", "loss")
    assert list(_get(ranks, "route", "steps")) == [0, 2, 4, 6, 7]
    assert loss[0] > loss[-1], loss
    assert not _get(ranks, "route", "drops").any()
    assert _get(ranks, "route", "k2_equal")
    assert list(_get(ranks, "route", "resumed_steps")) == [4, 6, 7]
    assert _get(ranks, "route", "resumed_equal")
    assert "band-axis" in str(_get(ranks, "route", "refused"))
