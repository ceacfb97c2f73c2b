"""Port parity, multi-card rendering: ``splatjax_torch.parallel``'s meshes,
collectives and ``render_sharded`` on a 4-rank gloo group against
splatjax's ``shard_map`` on the same numpy inputs, over a JAX mesh of the
same size (the conftest's virtual CPU devices).

:class:`RankRun` spawns the 4 ranks once per module; they run every case
of the module's ``_CASES`` and hand numpy arrays back through ``.npz``
files while the splatjax references run in the test process. This module
imports no jax at its top, because each rank imports it (and
``test_torch_parallel_train`` imports its harness): the splatjax
references are imported inside the tests.

Tolerances (those of ``tests/test_distributed.py``): images within 1e-4
of splatjax's sharded render (1e-5 on the balanced scene, and 1e-4 at
32 px tiles, against the port's one-card render); all_to_all against
all_gather within 1e-6; overflow vectors and band bounds equal; gradients
within 2e-3 of the largest, relative 2e-3; every rank's outputs
bit-identical.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
W, H = 64, 48
SCENE_KW = dict(extent=0.6, scale_range=(0.02, 0.08))
EYE = (0, 0, 2.2)
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")
LR = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats",
      "logit_opacities": "lr_opacities", "colors": "lr_colors"}


# -- inputs shared by the ranks and the references ---------------------------

def _span_scene():
    """7 tiny splats and one at the view centre covering every band."""
    n = 8
    means = np.zeros((n, 3), np.float32)
    means[:7, 0] = np.linspace(-0.5, 0.5, 7)
    scales = np.full((n, 3), 0.01, np.float32)
    scales[7] = 5.0
    return dict(means=means, scales=scales,
                quats=np.tile(np.asarray([[1, 0, 0, 0]], np.float32),
                              (n, 1)),
                colors=np.full((n, 3), 0.5, np.float32),
                opacities=np.full((n,), 0.9, np.float32))


def _concentrated_scene(synth):
    """2048 splats, 85% of them in the lower half of a 128x512 view."""
    scene = synth(2048, seed=77, extent=0.6, scale_range=(0.02, 0.05))
    rng = np.random.default_rng(77)
    means = np.array(scene.means).copy()
    hot = rng.random(2048) < 0.85
    means[hot, 1] = -0.5 + 0.5 * rng.random(hot.sum())
    return scene, means


# -- the ranks ---------------------------------------------------------------

def _t_scene(n, seed, **kw):
    from splatjax_torch.io import synthetic_scene

    return synthetic_scene(n, seed=seed, device="cpu", **{**SCENE_KW, **kw})


def _t_cam(eye=EYE, w=W, h=H):
    import splatjax_torch as st

    return st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu")


def _leaves(params):
    return {k: getattr(params, k).detach().numpy().copy() for k in LEAVES}


def _render_case(mesh, scene, cam, **kw):
    from splatjax_torch.parallel import render_sharded

    if mesh.get_coordinate() is None:
        return {}
    img, ov = render_sharded(scene, cam, mesh, return_overflow=True, **kw)
    return {"img": img, "ov": ov}


def _case_render4(rank):
    from splatjax_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(4, device="cpu")
    scene, cam = _t_scene(256, 60), _t_cam()
    out = _render_case(mesh, scene, cam, early_stop=0.0)
    out["img_ag"] = render_sharded(scene, cam, mesh, early_stop=0.0,
                                   redistribute="all_gather")
    return out


def _case_render2(rank):
    from splatjax_torch.parallel import make_mesh

    return _render_case(make_mesh(2, device="cpu"), _t_scene(256, 61),
                        _t_cam(), early_stop=0.0)


def _case_render2d(rank):
    from splatjax_torch.parallel import make_mesh_2d
    from splatjax_torch.parallel.mesh import axis_group

    mesh = make_mesh_2d((2, 2), device="cpu")
    out = _render_case(mesh, _t_scene(256, 64), _t_cam(),
                       axis=("host", "chip"), early_stop=0.0)
    host, chip = mesh.get_coordinate()
    out["flat"] = [axis_group(mesh, ("host", "chip")).index,
                   host * 2 + chip, axis_group(mesh, "chip").index]
    return out


def _case_height40(rank):
    from splatjax_torch.parallel import make_mesh

    return _render_case(make_mesh(4, device="cpu"), _t_scene(256, 63),
                        _t_cam(h=40), early_stop=0.0)


def _case_tile32(rank):
    from splatjax_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(4, device="cpu")
    scene, cam = _t_scene(256, 65), _t_cam(h=96)
    out = {}
    for bal in ("load", "equal"):
        out[f"img_{bal}"], out[f"ov_{bal}"] = render_sharded(
            scene, cam, mesh, tile_size=32, balance=bal, early_stop=0.0,
            return_overflow=True)
    return out


def _case_sh(rank):
    from splatjax_torch.parallel import make_mesh

    scene = _t_scene(256, 141)
    sh = np.random.default_rng(4).normal(scale=0.2, size=(256, 3, 3))
    scene = dataclasses.replace(scene, sh=torch.from_numpy(
        sh.astype(np.float32)))
    return _render_case(make_mesh(4, device="cpu"), scene, _t_cam(),
                        early_stop=0.0)


def _case_pair_capacity(rank):
    from splatjax_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(4, device="cpu")
    scene, cam = _t_scene(256, 66), _t_cam()
    return {f"ov{pc}": render_sharded(scene, cam, mesh, pair_capacity=pc,
                                      return_overflow=True)[1]
            for pc in (128, 4)}


def _case_bin_capacity(rank):
    from splatjax_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(4, device="cpu")
    scene = _t_scene(64, 31, extent=0.05, scale_range=(0.1, 0.2))
    cam = _t_cam(eye=(0, 0, 1.2), h=64)
    return {f"ov{cap}": render_sharded(scene, cam, mesh, capacity=cap,
                                       return_overflow=True)[1]
            for cap in (1024, 64)}


def _case_span(rank):
    from splatjax_torch.parallel import dist_render, make_mesh
    from splatjax_torch.scene import scene_from_numpy

    prev = dist_render.MAX_BANDS
    dist_render.MAX_BANDS = 2       # 4 bands, so a full span is cut
    try:
        return _render_case(make_mesh(4, device="cpu"),
                            scene_from_numpy(_span_scene(), device="cpu"),
                            _t_cam(h=64), early_stop=0.0, balance="equal")
    finally:
        dist_render.MAX_BANDS = prev


def _band_inputs(scene, cam, n_rows, index, n_dev):
    """What _band_render_body feeds _balanced_boundaries, on the dealt
    shard ``index`` (early_stop=0: the exact support)."""
    from splatjax_torch.ops.projection import project_gaussians
    from splatjax_torch.scene import build_covariances

    def deal(x):
        return x[index::n_dev]

    proj = project_gaussians(
        deal(scene.means), build_covariances(deal(scene.quats),
                                             deal(scene.scales)),
        deal(scene.colors), deal(scene.opacities), cam.modelview,
        cam.projection, cam.width, cam.height,
        max_scales=deal(scene.scales).amax(dim=-1))
    my, by = proj.mean2d[:, 1], proj.bbox_half[:, 1]
    mx, bx = proj.mean2d[:, 0], proj.bbox_half[:, 0]
    r0 = torch.floor((my - by) / 16).to(torch.int32)
    r1 = torch.floor((my + by) / 16).to(torch.int32)
    tx = cam.width // 16
    tx0 = torch.floor((mx - bx) / 16).clamp(0, tx - 1)
    tx1 = torch.floor((mx + bx) / 16).clamp(0, tx - 1)
    on = proj.mask & (r1 >= 0) & (r0 <= n_rows - 1)
    return r0, r1, (tx1 - tx0).to(torch.int64) + 1, on


def _case_balanced(rank):
    import splatjax_torch as st
    from splatjax_torch.io import synthetic_scene
    from splatjax_torch.parallel import make_mesh, render_sharded
    from splatjax_torch.parallel.dist_render import (
        _balanced_boundaries, max_band_rows,
    )
    from splatjax_torch.parallel.mesh import axis_group

    scene, means = _concentrated_scene(
        lambda n, **kw: synthetic_scene(n, device="cpu", **kw))
    scene = dataclasses.replace(scene, means=torch.from_numpy(means))
    cam = st.make_camera(EYE, (0, 0, 0), width=128, height=512,
                         device="cpu")
    mesh = make_mesh(4, device="cpu")
    ag = axis_group(mesh, "dev")
    with torch.no_grad():
        bounds = _balanced_boundaries(
            *_band_inputs(scene, cam, 32, ag.index, 4), 32, 4,
            max_band_rows(512, 4, 16), ag.group)
    out = _render_case(mesh, scene, cam, early_stop=0.0, balance="load")
    out["img_eq"] = render_sharded(scene, cam, mesh, early_stop=0.0,
                                   balance="equal")
    out["bounds"] = bounds
    return out


def _case_grads(rank):
    from splatjax_torch.parallel import make_mesh, render_sharded
    from splatjax_torch.scene import TrainableGaussians

    mesh = make_mesh(4, device="cpu")
    params = TrainableGaussians.from_scene(_t_scene(128, 62))
    tgt = torch.from_numpy(np.random.default_rng(5).normal(
        size=(H, W, 4)).astype(np.float32))
    loss = (render_sharded(params.to_scene(), _t_cam(), mesh,
                           early_stop=0.0) * tgt).sum()
    loss.backward()
    return {k: getattr(params, k).grad for k in LEAVES}


def _case_collectives(rank):
    """Each collective's backward against its transpose written out."""
    from splatjax_torch.parallel import make_mesh
    from splatjax_torch.parallel.dist_render import (
        all_gather, all_reduce, all_to_all,
    )

    group = make_mesh(4, device="cpu").get_group("dev")
    x = torch.arange(8.0).reshape(4, 2).add(10 * rank).requires_grad_()
    wts = [torch.full((4, 2), 1.0 + r) for r in range(4)]
    out = {}
    (all_to_all(x, group) * wts[rank]).sum().backward()
    out["a2a"], x.grad = x.grad, None
    (all_gather(x, group) * (torch.cat(wts) + rank)).sum().backward()
    out["ag"], x.grad = x.grad, None
    (all_reduce(x, group) * wts[rank]).sum().backward()
    out["ar"] = x.grad
    out["fwd_a2a"] = all_to_all(x.detach(), group)
    return out


_CASES = {
    "render4": _case_render4,
    "render2": _case_render2,
    "render2d": _case_render2d,
    "height40": _case_height40,
    "tile32": _case_tile32,
    "sh": _case_sh,
    "pair": _case_pair_capacity,
    "bincap": _case_bin_capacity,
    "span": _case_span,
    "balanced": _case_balanced,
    "grads": _case_grads,
    "coll": _case_collectives,
}


def _rank_main(rank, module, store, out_dir):
    import importlib

    from splatjax_torch.parallel import init_distributed

    torch.set_num_threads(1)
    os.chdir(out_dir)
    assert init_distributed(f"file://{store}", WORLD, rank, device="cpu")
    out = {}
    for name, case in importlib.import_module(module)._CASES.items():
        for key, value in case(rank).items():
            if torch.is_tensor(value):
                value = value.detach().numpy()
            out[f"{name}/{key}"] = np.asarray(value)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


class RankRun:
    """Every case of ``module``'s ``_CASES``, run once on WORLD spawned
    gloo ranks started at construction, in ``directory`` (the splatjax
    references run in this process meanwhile); ``outputs()`` waits for the
    ranks and returns one dict of numpy arrays per rank."""

    def __init__(self, module: str, directory):
        self._dir = directory
        self._ctx = mp.spawn(_rank_main, args=(
            module, str(directory / "store"), str(directory)),
            nprocs=WORLD, join=False)
        self._out = None

    def outputs(self):
        if self._out is None:
            while not self._ctx.join():
                pass
            self._out = []
            for r in range(WORLD):
                with np.load(self._dir / f"rank{r}.npz") as f:
                    self._out.append({k: f[k] for k in f.files})
        return self._out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = RankRun(__name__, tmp_path_factory.mktemp("ranks"))
    yield run
    run.outputs()


def _get(ranks, case, key, members=range(WORLD)):
    """The case's output, after checking it is bit-identical on every
    member rank."""
    outs = ranks.outputs()
    vals = [outs[r][f"{case}/{key}"] for r in members]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0], err_msg=f"{case}/{key}")
    return vals[0]


# -- splatjax references -----------------------------------------------------

def _j_scene(n, seed, **kw):
    from splatjax.io import synthetic_scene

    return synthetic_scene(n, seed=seed, **{**SCENE_KW, **kw})


def _j_cam(eye=EYE, w=W, h=H):
    from splatjax.camera import make_camera

    return make_camera(eye, (0, 0, 0), width=w, height=h)


def _j_sharded(scene, cam, mesh, **kw):
    import jax
    from splatjax.parallel import render_sharded

    img, ov = jax.jit(lambda s, c: render_sharded(
        s, c, mesh, return_overflow=True, **kw))(scene, cam)
    return np.asarray(img), np.asarray(ov)


def _check_render(ranks, case, want, members=range(WORLD), tol=1e-4):
    img = _get(ranks, case, "img", members)
    ov = _get(ranks, case, "ov", members)
    assert img.shape == want[0].shape
    np.testing.assert_allclose(img, want[0], atol=tol)
    np.testing.assert_array_equal(ov, want[1])
    return img


# -- tests -------------------------------------------------------------------

def test_render_sharded_four_ranks(ranks):
    from splatjax.parallel import make_mesh

    want = _j_sharded(_j_scene(256, 60), _j_cam(), make_mesh(4),
                      early_stop=0.0)
    img = _check_render(ranks, "render4", want)
    np.testing.assert_allclose(_get(ranks, "render4", "img_ag"), img,
                               atol=1e-6)


def test_render_sharded_two_ranks(ranks):
    from splatjax.parallel import make_mesh

    want = _j_sharded(_j_scene(256, 61), _j_cam(), make_mesh(2),
                      early_stop=0.0)
    _check_render(ranks, "render2", want, members=(0, 1))
    outs = ranks.outputs()
    assert "render2/img" not in outs[2] and "render2/img" not in outs[3]


def test_render_sharded_2d_mesh(ranks):
    from splatjax.parallel import make_mesh_2d

    want = _j_sharded(_j_scene(256, 64), _j_cam(), make_mesh_2d((2, 2)),
                      axis=("host", "chip"), early_stop=0.0)
    _check_render(ranks, "render2d", want)
    for r in range(WORLD):
        flat, host_chip, chip = ranks.outputs()[r]["render2d/flat"]
        assert flat == host_chip == r and chip == r % 2


def test_render_sharded_uneven_height(ranks):
    from splatjax.parallel import make_mesh

    want = _j_sharded(_j_scene(256, 63), _j_cam(h=40), make_mesh(4),
                      early_stop=0.0)
    assert want[0].shape == (40, W, 4)
    _check_render(ranks, "height40", want)


def test_render_sharded_tile32_four_ranks(ranks):
    """32 px tiles (3 tile rows over 4 bands): both band layouts within
    1e-4 of the port's one-card render at that edge, nothing dropped."""
    import splatjax_torch as st

    want = st.render(_t_scene(256, 65), _t_cam(h=96), tile_size=32,
                     early_stop=0.0).numpy()
    for bal in ("load", "equal"):
        np.testing.assert_allclose(_get(ranks, "tile32", f"img_{bal}"),
                                   want, atol=1e-4)
        np.testing.assert_array_equal(_get(ranks, "tile32", f"ov_{bal}"),
                                      np.zeros(WORLD))


def test_render_sharded_with_sh(ranks):
    import jax.numpy as jnp
    from splatjax.parallel import make_mesh

    sh = np.random.default_rng(4).normal(scale=0.2, size=(256, 3, 3))
    scene = dataclasses.replace(_j_scene(256, 141),
                                sh=jnp.asarray(sh.astype(np.float32)))
    _check_render(ranks, "sh", _j_sharded(scene, _j_cam(), make_mesh(4),
                                          early_stop=0.0))


def test_pair_capacity_drops_counted(ranks):
    from splatjax.parallel import make_mesh

    assert _get(ranks, "pair", "ov128").sum() == 0
    _, want = _j_sharded(_j_scene(256, 66), _j_cam(), make_mesh(4),
                         pair_capacity=4)
    got = _get(ranks, "pair", "ov4")
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_binning_overflow_counted(ranks):
    from splatjax.parallel import make_mesh

    assert _get(ranks, "bincap", "ov1024").shape == (WORLD,)
    _, want = _j_sharded(
        _j_scene(64, 31, extent=0.05, scale_range=(0.1, 0.2)),
        _j_cam(eye=(0, 0, 1.2), h=64), make_mesh(4), capacity=64)
    got = _get(ranks, "bincap", "ov64")
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_span_cut_exact_per_band_accounting(ranks, monkeypatch):
    """A splat spanning all 4 bands with a 2-band window keeps the window
    centred on its mean's band (2) and bands 0 and 1 each lose exactly
    this instance."""
    import jax.numpy as jnp
    from splatjax.parallel import dist_render, make_mesh
    from splatjax.scene import GaussianScene

    monkeypatch.setattr(dist_render, "MAX_BANDS", 2)
    scene = GaussianScene(**{k: jnp.asarray(v)
                             for k, v in _span_scene().items()}, sh=None)
    img, ov = _j_sharded(scene, _j_cam(h=64), make_mesh(4),
                         early_stop=0.0, balance="equal")
    np.testing.assert_array_equal(ov, [1, 1, 0, 0])
    got = _check_render(ranks, "span", (img, ov))
    assert got[32, 32, 3] > 0.1


def test_balanced_bounds_match_splatjax(ranks):
    """Load-balanced bounds on a concentrated scene equal splatjax's, and
    both layouts render the one-card image with no drops."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    import splatjax_torch as st
    from splatjax.io import synthetic_scene
    from splatjax.ops.binning import TileConfig, gaussian_tile_span
    from splatjax.ops.projection import project_gaussians
    from splatjax.parallel import make_mesh
    from splatjax.parallel.dist_render import (
        _balanced_boundaries, max_band_rows,
    )
    from splatjax.scene import build_covariances

    scene, means = _concentrated_scene(synthetic_scene)
    scene = dataclasses.replace(scene, means=jnp.asarray(means))
    cam = _j_cam(w=128, h=512)
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection,
        128, 512, max_scales=jnp.max(jnp.asarray(scene.scales), axis=-1))
    x0, x1, _, _, _ = gaussian_tile_span(proj, TileConfig(128, 512, 16, 16))
    my, by = proj.mean2d[:, 1], proj.bbox_half[:, 1]
    r0 = jnp.floor((my - by) / 16).astype(jnp.int32)
    r1 = jnp.floor((my + by) / 16).astype(jnp.int32)
    on = proj.mask & (r1 >= 0) & (r0 <= 31)
    deal = np.arange(2048).reshape(512, 4).T.reshape(-1)
    args = [jnp.take(a, deal, axis=0) for a in
            (r0, r1, (x1 - x0 + 1).astype(jnp.float32), on)]
    want = np.asarray(jax.jit(shard_map(
        partial(_balanced_boundaries, n_rows=32, n_dev=4,
                max_rows=max_band_rows(512, 4, 16), axis="dev"),
        mesh=make_mesh(4), in_specs=(P("dev"),) * 4, out_specs=P(),
        check_vma=False))(*args))
    bounds = _get(ranks, "balanced", "bounds")
    np.testing.assert_array_equal(bounds, want)
    assert not np.array_equal(bounds, np.arange(5) * 8)

    t_scene = st.scene_from_numpy(
        {f: np.asarray(getattr(scene, f)) for f in
         ("means", "scales", "quats", "colors", "opacities")},
        device="cpu")
    ref = st.render(t_scene, st.make_camera(EYE, (0, 0, 0), width=128,
                                            height=512, device="cpu"),
                    early_stop=0.0, capacity=65536).numpy()
    assert _get(ranks, "balanced", "ov").sum() == 0
    for key in ("img", "img_eq"):
        np.testing.assert_allclose(_get(ranks, "balanced", key), ref,
                                   atol=1e-5)


def test_sharded_gradients_match_splatjax(ranks):
    """Each rank's gradient sits on its dealt rows; summed over ranks and
    divided by D (every rank took the same loss) it is splatjax's."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from splatjax.parallel import make_mesh, render_sharded
    from splatjax.scene import TrainableGaussians

    mesh = make_mesh(4)
    cam = _j_cam()
    tgt = jnp.asarray(np.random.default_rng(5).normal(
        size=(H, W, 4)).astype(np.float32))
    params = TrainableGaussians.from_scene(_j_scene(128, 62))
    g = jax.jit(jax.grad(lambda p: jnp.sum(render_sharded(
        p.to_scene(), cam, mesh, early_stop=0.0) * tgt)))(params)
    outs = ranks.outputs()
    for r in range(WORLD):
        rows = np.zeros(128, bool)
        rows[r::WORLD] = True
        assert not outs[r]["grads/means"][~rows].any()
    for k in LEAVES:
        want = np.asarray(getattr(g, k))
        got = sum(outs[r][f"grads/{k}"] for r in range(WORLD)) / WORLD
        scale = np.abs(ravel_pytree(g)[0]).max()
        np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3,
                                   err_msg=k)


def test_public_names_match_splatjax():
    import splatjax.parallel as jp
    import splatjax_torch.parallel as tp
    from splatjax_torch import train

    assert tp.__all__ == jp.__all__
    assert all(callable(getattr(tp, name)) for name in tp.__all__)
    assert "make_dp_train_step" in train.__all__


def test_band_sizes_match_splatjax():
    from splatjax.parallel import dist_render as jd
    from splatjax_torch.parallel import dist_render as td

    for height in (1, 16, 40, 48, 512, 1080):
        for n_dev in (1, 2, 3, 4, 8, 16):
            for fn in ("padded_band_height", "max_band_rows"):
                assert getattr(td, fn)(height, n_dev, 16) == \
                    getattr(jd, fn)(height, n_dev, 16), (fn, height, n_dev)


def _projected_numpy(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        mean2d=rng.normal(size=(n, 2)).astype(np.float32) * 40,
        conic=rng.random((n, 3)).astype(np.float32),
        color=rng.random((n, 3)).astype(np.float32),
        opacity=rng.random(n).astype(np.float32),
        depth=-rng.random(n).astype(np.float32) * 5,
        bbox_half=rng.random((n, 2)).astype(np.float32) * 20,
        mask=rng.random(n) < 0.7)


def test_pack_unpack_projected_match_splatjax():
    import jax.numpy as jnp
    from splatjax.ops.projection import ProjectedGaussians as JProj
    from splatjax.parallel.dist_render import (
        _pack_projected as j_pack, _unpack_projected as j_unpack,
    )
    from splatjax_torch.ops.projection import ProjectedGaussians as TProj
    from splatjax_torch.parallel.dist_render import (
        _pack_projected, _unpack_projected,
    )

    fields = _projected_numpy(37, 3)
    want = np.asarray(j_pack(JProj(**{k: jnp.asarray(v)
                                      for k, v in fields.items()})))
    got = _pack_projected(TProj(**{k: torch.from_numpy(v)
                                   for k, v in fields.items()}))
    np.testing.assert_array_equal(got.numpy(), want)
    back = _unpack_projected(got)
    j_back = j_unpack(jnp.asarray(want))
    for k in fields:
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(j_back, k)), k)
        np.testing.assert_array_equal(getattr(back, k).numpy(), fields[k],
                                      k)


def test_band_of_and_assembly_match_splatjax():
    """Band lookup with an empty band, and the assembly of unequal bands
    (each rank's block holding its rows first, padding after)."""
    import jax.numpy as jnp
    from splatjax.ops.binning import TileConfig as JTileConfig
    from splatjax.parallel.dist_render import (
        _assemble_band_tiles as j_assemble, _band_of as j_band_of,
    )
    from splatjax_torch.ops.binning import TileConfig
    from splatjax_torch.parallel.dist_render import (
        _assemble_band_tiles, _band_of,
    )

    bounds = np.asarray([0, 3, 3, 5, 8], np.int32)
    rows = np.arange(8, dtype=np.int32)
    want = np.asarray(j_band_of(jnp.asarray(bounds), jnp.asarray(rows)))
    got = _band_of(torch.from_numpy(bounds), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want) == [0, 0, 0, 2, 2, 3, 3, 3]

    n_rows, band_rows, width, height = 8, 4, 40, 120
    tiles = np.random.default_rng(8).random(
        (4 * band_rows * 3, 8, 256)).astype(np.float32)
    want = np.asarray(j_assemble(
        jnp.asarray(tiles), jnp.asarray(bounds),
        JTileConfig(width, band_rows * 16, 16, 16), n_rows, height))
    got = _assemble_band_tiles(
        torch.from_numpy(tiles), torch.from_numpy(bounds),
        TileConfig(width, band_rows * 16), n_rows, height)
    assert got.shape == (height, width, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_collectives_transpose(ranks):
    """all_to_all's backward is the reverse all_to_all, all_gather's the
    reduce_scatter of the cotangents, all_reduce's their all_reduce."""
    wts = [np.full((4, 2), 1.0 + r, np.float32) for r in range(WORLD)]
    xs = [np.arange(8.0, dtype=np.float32).reshape(4, 2) + 10 * r
          for r in range(WORLD)]
    for r in range(WORLD):
        out = ranks.outputs()[r]
        np.testing.assert_array_equal(
            out["coll/fwd_a2a"], np.stack([xs[s][r] for s in range(WORLD)]))
        np.testing.assert_array_equal(
            out["coll/a2a"], np.stack([wts[s][r] for s in range(WORLD)]))
        cot = [np.concatenate(wts) + s for s in range(WORLD)]
        np.testing.assert_array_equal(
            out["coll/ag"], sum(c[4 * r:4 * r + 4] for c in cot))
        np.testing.assert_array_equal(out["coll/ar"], sum(wts))


def test_init_distributed_and_meshes_need_a_group(monkeypatch):
    from splatjax_torch.parallel import (
        init_distributed, make_mesh, make_mesh_2d,
    )

    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert init_distributed(device="cpu") is False
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh_2d((1, 1), device="cpu")
