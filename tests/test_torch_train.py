"""Port parity, training: the losses, ``TrainableGaussians`` and a short
``fit()`` of the port against splatjax's on the same numpy inputs (CPU).

Tolerances:
* ``ssim`` / ``l1`` / ``combined_loss`` / ``psnr``: 1e-5 relative plus
  1e-6 absolute (the same f32 formulas; the blur is a convolution in
  another summation order).
* ``to_scene`` / ``from_scene``: 1e-6 relative (elementwise f32).
* ``fit()``, 3 Adam steps with the default ``FitConfig`` (16-byte rows):
  the logged losses within 1e-3 relative; per leaf, the parameters within
  half that leaf's learning rate of splatjax's, and the parameter moves at
  cosine > 0.999. The first Adam steps move each parameter by about
  lr x sign(gradient), so a parameter whose gradient is near zero can step
  the other way on rounding alone; measured: 0.12 lr at most (quats).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.render import render as j_render
from splatjax.scene import GaussianScene as JScene
from splatjax.scene import TrainableGaussians as JTrainable
from splatjax.train import FitConfig as JFitConfig
from splatjax.train import combined_loss as j_combined_loss
from splatjax.train import fit as j_fit
from splatjax.train import l1 as j_l1
from splatjax.train import psnr as j_psnr
from splatjax.train import ssim as j_ssim

import splatjax_torch as st
from splatjax_torch import train as tt

LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")
LR = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats",
      "logit_opacities": "lr_opacities", "colors": "lr_colors"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_losses_match_splatjax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(40, 52, 4)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    pairs = ((j_ssim, tt.ssim, (a[..., :3], b[..., :3])),
             (j_l1, tt.l1, (a, b)),
             (j_psnr, tt.psnr, (a, b)),
             (j_combined_loss, tt.combined_loss, (a, b)))
    for jf, tf, (x, y) in pairs:
        want = float(jf(jnp.asarray(x), jnp.asarray(y)))
        got = float(tf(_t(x), _t(y)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert float(tt.ssim(_t(a), _t(a))) > 0.9999
    assert float(tt.combined_loss(_t(a), _t(a))) < 1e-6
    np.testing.assert_allclose(
        float(tt.combined_loss(_t(a), _t(b), ssim_weight=0.7)),
        float(j_combined_loss(jnp.asarray(a), jnp.asarray(b),
                              ssim_weight=0.7)), rtol=1e-5, atol=1e-6)


def test_combined_loss_gradient_matches_splatjax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(24, 30, 4)).astype(np.float32)
    b = rng.uniform(size=(24, 30, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: j_combined_loss(
        x, jnp.asarray(b)))(jnp.asarray(a)))
    x = _t(a).requires_grad_()
    tt.combined_loss(x, _t(b)).backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale)


def test_trainable_gaussians_round_trip():
    s = synthetic_scene(50, seed=3, extent=0.6, scale_range=(0.02, 0.08))
    jt = JTrainable.from_scene(s)
    leaves = {k: np.asarray(getattr(jt, k)) for k in LEAVES}
    params = st.trainable_from_numpy(leaves, device="cpu")
    assert isinstance(params, torch.nn.Module)
    assert [n for n, _ in params.named_parameters()] == list(LEAVES)
    assert params.num_gaussians == 50 and params.sh is None
    js, ts_ = jt.to_scene(), params.to_scene()
    for f in ("means", "scales", "quats", "colors", "opacities"):
        np.testing.assert_allclose(getattr(ts_, f).detach().numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   atol=1e-7)
    scene = st.scene_from_numpy(
        {f: np.asarray(getattr(s, f)) for f in
         ("means", "scales", "quats", "colors", "opacities")}, device="cpu")
    back = st.TrainableGaussians.from_scene(scene)
    for k in LEAVES:
        np.testing.assert_allclose(getattr(back, k).detach().numpy(),
                                   leaves[k], rtol=1e-6, atol=1e-6)


def _fit_setup():
    target = synthetic_scene(20, seed=41, extent=0.5,
                             scale_range=(0.06, 0.15),
                             opacity_range=(0.6, 1.0))
    views = ((0, 0, 2.0), (0.6, 0.3, 1.9))
    cams_j = [j_make_camera(e, (0, 0, 0), width=32, height=24)
              for e in views]
    cams_t = [st.make_camera(e, (0, 0, 0), width=32, height=24,
                             device="cpu") for e in views]
    targets = [np.asarray(j_render(target, c)) for c in cams_j]
    rng = np.random.default_rng(5)
    n = 24
    init = dict(
        means=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        log_scales=np.full((n, 3), np.log(0.08), np.float32),
        quats=(np.array([[1, 0, 0, 0]], np.float32)
               + 0.01 * rng.normal(size=(n, 4))).astype(np.float32),
        logit_opacities=np.full((n,), -1.0, np.float32),
        colors=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32))
    return init, cams_j, cams_t, targets


def test_fit_matches_splatjax():
    init, cams_j, cams_t, targets = _fit_setup()
    kw = dict(steps=3, log_every=1, capacity=2048)
    pj, hj = j_fit(JTrainable(**{k: jnp.asarray(v) for k, v in init.items()}),
                   cams_j, [jnp.asarray(x) for x in targets],
                   JFitConfig(**kw))
    cfg = tt.FitConfig(**kw)
    assert cfg.feature_bytes == 16 and cfg == tt.FitConfig(
        **{f: getattr(JFitConfig(**kw), f) for f in
           tt.FitConfig.__dataclass_fields__})
    logged = []
    pt, ht = tt.fit(st.trainable_from_numpy(init, device="cpu"), cams_t,
                    [_t(x) for x in targets], cfg, log_fn=logged.append)
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == [0, 1, 2]
    assert logged == ht
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-3)
    np.testing.assert_allclose([h["psnr"] for h in ht],
                               [h["psnr"] for h in hj], rtol=1e-3)
    for k in LEAVES:
        a = np.asarray(getattr(pj, k))
        b = getattr(pt, k).detach().numpy()
        lr = getattr(cfg, LR[k])
        assert np.abs(a - b).max() <= 0.5 * lr, (k, np.abs(a - b).max())
        da, db = (a - init[k]).ravel(), (b - init[k]).ravel()
        cos = float(da @ db / (np.linalg.norm(da) * np.linalg.norm(db)))
        assert cos > 0.999, (k, cos)


def test_train_step_and_steps_per_call():
    """k steps per call run the same single steps in order."""
    init, _, cams_t, targets = _fit_setup()
    tg = [_t(x) for x in targets]
    one = st.trainable_from_numpy(init, device="cpu")
    cfg = tt.FitConfig(steps=2, log_every=0, capacity=2048)
    tt.fit(one, cams_t, tg, cfg)
    two = st.trainable_from_numpy(init, device="cpu")
    _, hist = tt.fit(two, cams_t, tg, tt.FitConfig(
        steps=2, log_every=1, capacity=2048, steps_per_call=2))
    assert [h["step"] for h in hist] == [1]
    for k in LEAVES:
        torch.testing.assert_close(getattr(one, k), getattr(two, k),
                                   rtol=0, atol=0)
    step = tt.make_train_step(cams_t, cfg, 2048)
    params = st.trainable_from_numpy(init, device="cpu")
    from splatjax_torch.train.fit import _optimizer
    opt = _optimizer(params, cfg)
    assert [g["lr"] for g in opt.param_groups] == [
        cfg.lr_means, cfg.lr_scales, cfg.lr_quats, cfg.lr_opacities,
        cfg.lr_colors]
    loss, p, gnorm = step(params, opt, cams_t[0].modelview,
                          cams_t[0].projection, tg[0])
    assert loss.dim() == 0 and p.dim() == 0 and gnorm.shape == (24,)
    assert torch.isfinite(gnorm).all()


def test_init_random_and_scene_start():
    init, _, cams_t, targets = _fit_setup()
    tg = [_t(x) for x in targets]
    g = torch.Generator().manual_seed(3)
    r = tt.init_random(64, g, extent=0.5, initial_scale=0.08, device="cpu")
    assert r.means.shape == (64, 3)
    assert float(r.means.detach().abs().max()) <= 0.5
    np.testing.assert_allclose(r.log_scales.detach().numpy(), np.log(0.08),
                               rtol=1e-6)
    assert float(r.logit_opacities.detach().max()) == -1.0
    r2 = tt.init_random(64, torch.Generator().manual_seed(3), extent=0.5,
                        device="cpu")
    torch.testing.assert_close(r.means, r2.means)
    # a GaussianScene start is converted to TrainableGaussians
    scene = JTrainable(**{k: jnp.asarray(v) for k, v in init.items()}
                       ).to_scene()
    assert isinstance(scene, JScene)
    ts_ = st.scene_from_numpy({f: np.asarray(getattr(scene, f)) for f in
                               ("means", "scales", "quats", "colors",
                                "opacities")}, device="cpu")
    out, _ = tt.fit(ts_, cams_t, tg, tt.FitConfig(steps=1, log_every=0,
                                                   capacity=2048))
    assert isinstance(out, st.TrainableGaussians)
