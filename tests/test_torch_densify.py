"""Port parity, adaptive density control: ``densify_and_prune`` and
``fit(densify=...)`` of the port against splatjax's on the same numpy
inputs and the same ``np.random.Generator`` seed (CPU).

Tolerances:
* ``densify_and_prune`` on the same parameters, optimizer moments,
  gradient sums and generator: parameters, moments and the slot mask equal
  within 1e-6 (both run the same NumPy bookkeeping; measured bit-equal),
  the report equal.
* ``fit(densify=...)``, 32-byte rows, 6 steps over two views with one
  densify pass after step 1 (300 gaussians, then the 1024-row bucket):
  the densify report and the slot mask equal; the logged losses within
  1e-3 relative; per leaf, the parameters within half that leaf's
  learning rate of splatjax's (as ``test_torch_train.py``). The scene is
  built so that no decision sits near a threshold: opacities of 0.0025
  (pruned) or 0.27 against 0.005, scales of 0.03 or 0.12 against the
  split size 0.06, and the gradient threshold in a gap of the measured
  mean gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.render import render as j_render
from splatjax.scene import TrainableGaussians as JTrainable
from splatjax.train import DensifyConfig as JDensifyConfig
from splatjax.train import FitConfig as JFitConfig
from splatjax.train import densify_and_prune as j_densify
from splatjax.train import fit as j_fit
from splatjax.train.fit import _optimizer as j_optimizer

import splatjax_torch as st
from splatjax_torch import train as tt
from splatjax_torch.ops.projection import SIZE_CULL_THRESHOLD
from splatjax_torch.train.densify import (
    DEAD_LOG_SCALE, DEAD_LOGIT, _bucket,
)
from splatjax_torch.train.fit import _optimizer as t_optimizer

LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")
LR = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats",
      "logit_opacities": "lr_opacities", "colors": "lr_colors"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(n, rng):
    """n gaussians: every 10th nearly transparent, half small, half
    large."""
    logit = np.full((n,), -1.0, np.float32)
    logit[::10] = -6.0
    scale = np.where(np.arange(n) % 2 == 0, 0.03, 0.12).astype(np.float32)
    return dict(
        means=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        log_scales=np.repeat(np.log(scale)[:, None], 3, axis=1),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=logit,
        colors=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32))


def _states(leaves, rng, count=5):
    """The same Adam state for both packages: optax's multi_transform state
    and the port's per-leaf torch.optim.Adam."""
    moments = {(kind, k): rng.normal(size=v.shape).astype(np.float32) ** (
        2 if kind == "nu" else 1)
        for k, v in leaves.items() for kind in ("mu", "nu")}
    jp = JTrainable(**{k: jnp.asarray(v) for k, v in leaves.items()})
    j_state = j_optimizer(JFitConfig()).init(jp)

    def fill(path, x):
        keys = [getattr(e, "name", getattr(e, "key", None)) for e in path]
        if keys[-1] == "count":
            return jnp.asarray(count, x.dtype)
        return jnp.asarray(moments[(keys[-2], keys[-1])])

    j_state = jax.tree_util.tree_map_with_path(fill, j_state)
    tp = st.trainable_from_numpy(leaves, device="cpu")
    opt = t_optimizer(tp, tt.FitConfig())
    for k in LEAVES:
        opt.state[getattr(tp, k)] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(moments[("mu", k)].copy()),
            "exp_avg_sq": torch.from_numpy(moments[("nu", k)].copy())}
    return jp, j_state, tp, opt


def _j_moments(j_state):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(j_state)[0]:
        keys = [getattr(e, "name", getattr(e, "key", None)) for e in path]
        if keys[-1] != "count":
            out[(keys[-2], keys[-1])] = np.asarray(x)
    return out


CASES = {
    # (n, grad scale, max_gaussians): children fit the slots that an
    # earlier pass left dead (the upper half) and those freed now
    "in_place": (300, 3e-4, 1 << 22),
    # more children than free slots: the rows grow to the next bucket
    "grow": (1024, 3e-4, 1 << 22),
    # the budget drops children; split parents without children live
    "budget": (1024, 3e-4, 1340),
    # nothing hot, nothing transparent: the inputs come back unchanged
    "idle": (300, 0.0, 1 << 22),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_and_prune_matches_splatjax(case):
    n, gscale, max_g = CASES[case]
    rng = np.random.default_rng(17)
    leaves = _leaves(n, rng)
    if case == "idle":
        leaves["logit_opacities"][:] = -1.0
    grad_sum = rng.uniform(0.0, 4.0, n) * gscale
    grad_cnt = np.full((n,), 2, np.int64)
    grad_cnt[5] = 0
    alive = np.ones((n,), bool)
    if case == "in_place":
        alive[n // 2:] = False
        leaves["logit_opacities"][n // 2:] = DEAD_LOGIT
        leaves["log_scales"][n // 2:] = DEAD_LOG_SCALE
    jp, j_state, tp, opt = _states(leaves, rng)
    cfg_kw = dict(grad_threshold=2e-4, split_scale=0.06,
                  max_gaussians=max_g)
    jp2, j_state2, j_alive, j_rep = j_densify(
        jp, j_state, grad_sum, grad_cnt, alive, JDensifyConfig(**cfg_kw),
        np.random.default_rng(3))
    tp2, opt2, t_alive, t_rep = tt.densify_and_prune(
        tp, opt, grad_sum, grad_cnt, alive, tt.DensifyConfig(**cfg_kw),
        np.random.default_rng(3))
    assert t_rep == j_rep
    np.testing.assert_array_equal(t_alive, j_alive)
    if case == "idle":
        assert tp2 is tp and opt2 is opt and t_rep["pruned"] == 0
        return
    assert t_rep["cloned"] > 0 and t_rep["split"] > 0
    assert t_rep["pruned"] > 0
    if case == "in_place":
        assert t_rep["capacity"] == n
    else:
        assert t_rep["capacity"] == _bucket(t_rep["capacity"], 1.5) > n
    if case == "budget":
        assert t_rep["dropped_children"] > 0
    moments = _j_moments(j_state2)
    assert [g["params"][0] for g in opt2.param_groups] == [
        getattr(tp2, k) for k in LEAVES]
    for k in LEAVES:
        got = getattr(tp2, k)
        assert isinstance(got, torch.nn.Parameter)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(getattr(jp2, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        state = opt2.state[got]
        assert float(state["step"]) == 5.0
        for kind, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            np.testing.assert_allclose(state[key].numpy(),
                                       moments[(kind, k)], rtol=1e-6,
                                       atol=1e-6, err_msg=(k, kind))
    # the group hyperparameters survive the rebuild
    assert [g["lr"] for g in opt2.param_groups] == [
        g["lr"] for g in opt.param_groups]


def test_dead_slots_are_culled_by_projection():
    """A dead slot (DEAD_LOGIT, DEAD_LOG_SCALE) fails the projection's
    size x opacity cull at any depth in front of the far plane."""
    scale = float(np.exp(DEAD_LOG_SCALE))
    opacity = float(1.0 / (1.0 + np.exp(-DEAD_LOGIT)))
    assert scale * opacity < SIZE_CULL_THRESHOLD * 1e-3
    leaves = _leaves(8, np.random.default_rng(2))
    leaves["logit_opacities"][:4] = DEAD_LOGIT
    leaves["log_scales"][:4] = DEAD_LOG_SCALE
    leaves["means"][:] = 0.0
    params = st.trainable_from_numpy(leaves, device="cpu")
    cam = st.make_camera((0.0, 0.0, 0.5), (0, 0, 0), width=48, height=32,
                         device="cpu")
    scene = params.to_scene()
    from splatjax_torch.ops.projection import project_gaussians

    proj = project_gaussians(
        scene.means, st.build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, 48,
        32, max_scales=scene.scales.amax(dim=-1), support_eps=1e-4)
    assert proj.mask.tolist() == [False] * 4 + [True] * 4


@pytest.fixture(scope="module")
def fit_case():
    """Targets from a 60-splat scene in two views; a 300-gaussian start."""
    target = synthetic_scene(60, seed=41, extent=0.5,
                             scale_range=(0.05, 0.12),
                             opacity_range=(0.6, 1.0))
    views = ((0, 0, 2.0), (0.6, 0.3, 1.9))
    cams_j = [j_make_camera(e, (0, 0, 0), width=48, height=32)
              for e in views]
    cams_t = [st.make_camera(e, (0, 0, 0), width=48, height=32,
                             device="cpu") for e in views]
    targets = [np.asarray(j_render(target, c)) for c in cams_j]
    leaves = _leaves(300, np.random.default_rng(5))
    leaves["quats"] = (np.array([[1, 0, 0, 0]], np.float32) + 0.01 * np.random
                       .default_rng(6).normal(size=(300, 4))).astype(
                           np.float32)
    return leaves, cams_j, cams_t, targets


FIT_KW = dict(steps=6, log_every=1, capacity=4096, feature_bytes=32)
# the mean gradients over steps 0-1 sit at 1.90e-5 and 2.43e-5 on either
# side of the threshold (the port's, measured): 269 of 270 live gaussians
# are hot
DENSE_KW = dict(start=0, stop=1, every=2, grad_threshold=2.2e-5,
                split_scale=0.06)


@pytest.fixture(scope="module")
def splatjax_fit(fit_case):
    leaves, cams_j, _, targets = fit_case
    events = []
    params, hist = j_fit(
        JTrainable(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        cams_j, [jnp.asarray(x) for x in targets], JFitConfig(**FIT_KW),
        densify=JDensifyConfig(**DENSE_KW), densify_seed=4,
        log_fn=events.append)
    return params, hist, [e for e in events if "densify" in e]


def test_fit_densify_matches_splatjax(fit_case, splatjax_fit):
    leaves, _, cams_t, targets = fit_case
    pj, hj, dj = splatjax_fit
    events = []
    start = st.trainable_from_numpy(leaves, device="cpu")
    pt, ht = tt.fit(start, cams_t,
                    [torch.from_numpy(np.array(x)) for x in targets],
                    tt.FitConfig(**FIT_KW),
                    densify=tt.DensifyConfig(**DENSE_KW), densify_seed=4,
                    log_fn=events.append)
    dt = [e for e in events if "densify" in e]
    assert dt == dj and len(dt) == 1
    rep = dt[0]["densify"]
    assert rep["cloned"] > 0 and rep["split"] > 0 and rep["pruned"] > 0
    assert rep["capacity"] == 1024 and pt is not start
    assert pt.num_gaussians == 1024
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-3)
    cfg = tt.FitConfig(**FIT_KW)
    for k in LEAVES:
        a = np.asarray(getattr(pj, k))
        b = getattr(pt, k).detach().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 0.5 * getattr(cfg, LR[k]), k


def test_fit_densify_refuses_steps_per_call():
    leaves = _leaves(16, np.random.default_rng(1))
    cam = st.make_camera((0, 0, 2.0), (0, 0, 0), width=16, height=16,
                         device="cpu")
    with pytest.raises(ValueError, match="steps_per_call"):
        tt.fit(st.trainable_from_numpy(leaves, device="cpu"), [cam],
               [torch.zeros((16, 16, 4))],
               tt.FitConfig(steps=2, steps_per_call=2),
               densify=tt.DensifyConfig())
