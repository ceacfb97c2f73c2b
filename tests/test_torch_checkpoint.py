"""Checkpoint / resume and export of the port (CPU).

* ``fit(checkpoint_dir=..., resume=True)``: a run stopped after step 3 and
  resumed from its checkpoint ends bit-identical to an uninterrupted run,
  with and without densify (whose slot mask, gradient sums and generator
  state the checkpoint carries), and logs the same losses from step 3 on.
* ``CheckpointManager``: the newest ``max_to_keep`` kept, no temporary file
  left, ``restore`` bit-equal to what was saved, with a grown row count.
* ``export_splat`` / ``export_ply``: bytes equal to splatjax's for the same
  scene, and to ``save_*`` of ``to_scene()`` for trainable parameters.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import splatjax.scene as jscene
import splatjax.train as jtrain
from splatjax.io import synthetic_scene

import splatjax_torch as st
import splatjax_torch.io as tio
from splatjax_torch import train as tt
from splatjax_torch.train.fit import _optimizer

LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    target = st.io.synthetic_scene(60, seed=41, extent=0.5,
                                   scale_range=(0.05, 0.12),
                                   opacity_range=(0.6, 1.0), device="cpu")
    cams = [st.make_camera(e, (0, 0, 0), width=48, height=32, device="cpu")
            for e in ((0, 0, 2.0), (0.6, 0.3, 1.9))]
    with torch.no_grad():
        targets = [st.render(target, c) for c in cams]
    rng = np.random.default_rng(5)
    n = 300
    logit = np.full((n,), -1.0, np.float32)
    logit[::10] = -6.0
    leaves = dict(
        means=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        log_scales=np.repeat(np.log(np.where(
            np.arange(n) % 2 == 0, 0.03, 0.12)).astype(np.float32)[:, None],
            3, axis=1),
        quats=(np.array([[1, 0, 0, 0]], np.float32)
               + 0.01 * rng.normal(size=(n, 4))).astype(np.float32),
        logit_opacities=logit,
        colors=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32))
    return leaves, cams, targets


DENSE = dict(start=0, every=2, grad_threshold=2.2e-5, split_scale=0.06)


@pytest.mark.parametrize("densify", [True, False],
                         ids=["densify", "plain"])
def test_resume_is_bit_identical(tmp_path, case, densify):
    leaves, cams, targets = case
    kw = dict(checkpoint_every=3,
              densify=tt.DensifyConfig(**DENSE) if densify else None,
              densify_seed=9)
    cfg = tt.FitConfig(steps=8, log_every=1, capacity=4096)
    events = []
    full, hist = tt.fit(st.trainable_from_numpy(leaves, device="cpu"),
                        cams, targets, cfg, checkpoint_dir=tmp_path / "a",
                        log_fn=events.append, **kw)
    grown = [e["densify"]["capacity"] for e in events if "densify" in e]
    if densify:  # passes after steps 1, 3, 5 and 7; the rows grow
        assert len(grown) == 4 and full.num_gaussians > 300
    # stop after step 3, then resume from its checkpoint
    first = tt.FitConfig(steps=3, log_every=1, capacity=4096)
    tt.fit(st.trainable_from_numpy(leaves, device="cpu"), cams, targets,
           first, checkpoint_dir=tmp_path / "b", **kw)
    assert tt.CheckpointManager(tmp_path / "b").latest_step() == 3
    resumed, rhist = tt.fit(
        st.trainable_from_numpy(leaves, device="cpu"), cams, targets, cfg,
        checkpoint_dir=tmp_path / "b", resume=True, **kw)
    assert [h["step"] for h in rhist] == list(range(3, 8))
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[3:]]
    assert resumed.num_gaussians == full.num_gaussians
    for k in LEAVES:
        assert torch.equal(getattr(resumed, k), getattr(full, k)), k
    # both directories end with the same final checkpoint
    a = torch.load(tmp_path / "a" / "step_8.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "step_8.pt", weights_only=True)
    for k in LEAVES:
        assert torch.equal(a["params"][k], b["params"][k])
    if densify:
        assert torch.equal(a["extra"]["alive"], b["extra"]["alive"])
        assert a["extra"]["rng"] == b["extra"]["rng"]


def test_manager_rotation_and_restore(tmp_path, case):
    leaves, _, _ = case
    params = st.trainable_from_numpy(leaves, device="cpu")
    opt = _optimizer(params, tt.FitConfig())
    for p in params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    mgr = tt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3, 10):
        mgr.save(step, params, opt, {"note": step})
    assert mgr.all_steps() == [3, 10] and mgr.latest_step() == 10
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_10.pt",
                                                   "step_3.pt"]
    got, got_opt, step, extra = mgr.restore(params, opt)
    assert step == 10 and extra == {"note": 10}
    assert got is not params and got_opt is not opt
    for k in LEAVES:
        assert torch.equal(getattr(got, k), getattr(params, k))
        a, b = got_opt.state[getattr(got, k)], opt.state[getattr(params, k)]
        assert set(a) == set(b) and all(torch.equal(a[s], b[s]) for s in a)
    assert [g["lr"] for g in got_opt.param_groups] == [
        g["lr"] for g in opt.param_groups]
    _, _, step, extra = mgr.restore(params, opt, step=3)
    assert step == 3 and extra == {"note": 3}
    with pytest.raises(FileNotFoundError):
        tt.CheckpointManager(tmp_path / "empty").restore(params, opt)
    with pytest.raises(ValueError):
        tt.CheckpointManager(tmp_path / "x", max_to_keep=0)


def test_restore_takes_the_saved_row_count(tmp_path, case):
    """A checkpoint of grown parameters restores with its own row count
    onto a smaller template, with the optimizer state it was saved with."""
    leaves, cams, targets = case
    params = st.trainable_from_numpy(leaves, device="cpu")
    opt = _optimizer(params, tt.FitConfig())
    for p in params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    grad = np.zeros((300,))
    grown, gopt, _, rep = tt.densify_and_prune(
        params, opt, grad + 1.0, grad.astype(np.int64) + 1,
        np.ones((300,), bool), tt.DensifyConfig(split_scale=0.06),
        np.random.default_rng(0))
    assert rep["capacity"] > 300
    mgr = tt.CheckpointManager(tmp_path)
    mgr.save(4, grown, gopt)
    got, got_opt, _, _ = mgr.restore(params, opt)
    assert got.num_gaussians == rep["capacity"]
    for k in LEAVES:
        assert torch.equal(getattr(got, k), getattr(grown, k))
        assert torch.equal(got_opt.state[getattr(got, k)]["exp_avg"],
                           gopt.state[getattr(grown, k)]["exp_avg"])


def test_export_bytes(tmp_path):
    s = synthetic_scene(97, seed=8)
    j_scene = jscene.GaussianScene(**{
        f: jnp.asarray(getattr(s, f)) for f in
        ("means", "scales", "quats", "colors", "opacities")})
    t_scene = st.scene_from_numpy(
        {f: np.asarray(getattr(s, f)) for f in
         ("means", "scales", "quats", "colors", "opacities")}, "cpu")
    for ext, t_fn, j_fn in (("splat", tt.export_splat, jtrain.export_splat),
                            ("ply", tt.export_ply, jtrain.export_ply)):
        t_path, j_path = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
        t_fn(str(t_path), t_scene)
        j_fn(str(j_path), j_scene)
        assert t_path.read_bytes() == j_path.read_bytes(), ext
    params = st.TrainableGaussians.from_scene(t_scene)
    tt.export_ply(str(tmp_path / "p.ply"), params)
    tio.save_ply(tmp_path / "q.ply", params.to_scene())
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "q.ply").read_bytes()
    tt.export_splat(str(tmp_path / "p.splat"), params)
    assert (tmp_path / "p.splat").read_bytes() == \
        tio.scene_to_splat_bytes(params.to_scene())
