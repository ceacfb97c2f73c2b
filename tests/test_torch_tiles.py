"""Port parity, the tile edge: ``render``, ``render_binned``, the gradient
and every entry point that takes ``tile_size``, at square tiles of 8, 32
and 64 px, against splatjax (CPU, Pallas in interpret mode) on the same
numpy scene; the plain versions of K2, K3 and K4 carry the port here.

300 splats at 96x64 for 8 and 32 px, 48x32 (one tile) at 64 px, where
splatjax's own error against ``render_reference`` grows to 2e-4.

Tolerances: the 32-byte render within 1e-4 of splatjax's (both composite
the same rows in f32, in other summation orders); the 16-byte render and
the 16-byte cached redraw (K3's plain version) within 1e-2 (splatjax's
16-byte mode runs its scans and color sums as single bf16 MXU passes); the
32-byte gradients of every ``TrainableGaussians`` leaf within atol 2e-3 x
the largest |gradient|, rtol 2e-3 (splatjax's own gradient contract); the
port's entry points against each other bit-equal, and the one-rank
``render_sharded`` within 1e-4 of ``render``.
"""
import dataclasses
import importlib
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.render import bin_scene as j_bin_scene
from splatjax.render import render as j_render
from splatjax.render import render_binned as j_render_binned
from splatjax.scene import GaussianScene as JScene
from splatjax.scene import TrainableGaussians as JTrainable

import splatjax_torch as st
from splatjax_torch.ops.binning import TileConfig

EDGES = (8, 32, 64)
VIEW = {8: (96, 64), 32: (96, 64), 64: (48, 32)}
EYE = (0, 0, 2.2)
TOL = 1e-4
TOL_16 = 1e-2
GRAD_TOL = 2e-3
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")

_render_mod = importlib.import_module("splatjax_torch.render")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves():
    s = synthetic_scene(300, seed=21, extent=0.6, scale_range=(0.02, 0.08))
    return {k: np.asarray(getattr(JTrainable.from_scene(s), k))
            for k in LEAVES}


def _t_cam(w, h, eye=EYE):
    return st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu")


def _t_scene(leaves):
    """The activated scene of ``leaves``, detached from them."""
    s = st.trainable_from_numpy(leaves, device="cpu").to_scene()
    return st.GaussianScene(**{
        f.name: None if getattr(s, f.name) is None
        else getattr(s, f.name).detach() for f in dataclasses.fields(s)})


@pytest.fixture(scope="module", params=EDGES, ids=lambda e: f"tile{e}")
def jref(request):
    """splatjax at one tile edge: the 32-byte image and the gradient of
    sum(image * target) w.r.t. every leaf (one vjp), the 16-byte image,
    and the 16-byte redraw on ``bin_scene(cache_params=True)``."""
    edge = request.param
    w, h = VIEW[edge]
    leaves = _leaves()
    tgt = np.random.default_rng(edge).normal(size=(h, w, 4)).astype(
        np.float32)
    cam = j_make_camera(EYE, (0, 0, 0), width=w, height=h)
    params = JTrainable(**{k: jnp.asarray(v) for k, v in leaves.items()})
    img32, vjp = jax.vjp(
        lambda p: j_render(p.to_scene(), cam, tile_size=edge), params)
    (grads,) = vjp(jnp.asarray(tgt))
    scene = params.to_scene()
    bins = j_bin_scene(scene, cam, tile_size=edge, cache_params=True)
    return dict(
        edge=edge, leaves=leaves, tgt=tgt,
        img32=np.asarray(img32),
        grads={k: np.asarray(getattr(grads, k)) for k in LEAVES},
        img16=np.asarray(j_render(scene, cam, tile_size=edge,
                                  feature_bytes=16)),
        cached16=np.asarray(j_render_binned(scene, cam, bins,
                                            tile_size=edge,
                                            feature_bytes=16)),
    )


@pytest.mark.parametrize("feature_bytes", (32, 16))
def test_render_matches_splatjax(jref, feature_bytes):
    edge = jref["edge"]
    img, overflow = st.render(_t_scene(jref["leaves"]), _t_cam(*VIEW[edge]),
                              tile_size=edge, feature_bytes=feature_bytes,
                              return_overflow=True)
    want = jref["img32" if feature_bytes == 32 else "img16"]
    assert int(overflow) == 0 and want[..., 3].mean() > 0.1
    np.testing.assert_allclose(img.numpy(), want,
                               atol=TOL if feature_bytes == 32 else TOL_16)


def test_cached_redraw_matches_splatjax(jref):
    edge = jref["edge"]
    scene, cam = _t_scene(jref["leaves"]), _t_cam(*VIEW[edge])
    bins = st.bin_scene(scene, cam, tile_size=edge, cache_params=True)
    assert bins.bins.starts.numel() == TileConfig(
        *VIEW[edge], edge, edge).num_tiles
    img = st.render_binned(scene, cam, bins, tile_size=edge,
                           feature_bytes=16)
    np.testing.assert_allclose(img.numpy(), jref["cached16"], atol=TOL_16)


def test_gradients_match_splatjax(jref):
    edge = jref["edge"]
    params = st.trainable_from_numpy(jref["leaves"], device="cpu")
    img = st.render(params.to_scene(), _t_cam(*VIEW[edge]), tile_size=edge)
    (img * torch.from_numpy(jref["tgt"])).sum().backward()
    got = np.concatenate([getattr(params, k).grad.numpy().ravel()
                          for k in LEAVES])
    want = np.concatenate([jref["grads"][k].ravel() for k in LEAVES])
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("feature_bytes", (32, 16))
def test_stale_order_renderer_equals_render_binned(feature_bytes):
    """SplatRenderer(tile_size=32, resort_interval=3) over five eyes: each
    frame is render_binned on the bins of the frame that last rebuilt
    them (frames 0 and 3)."""
    scene = _t_scene(_leaves())
    cams = [_t_cam(96, 64, (0.02 * i, -0.01 * i, 2.2)) for i in range(5)]
    r = st.SplatRenderer(scene=scene, tile_size=32, resort_interval=3,
                         feature_bytes=feature_bytes, device="cpu")
    for i, cam in enumerate(cams):
        got = r.render(cam)
        bins = st.bin_scene(scene, cams[i // 3 * 3], tile_size=32,
                            cache_params=True)
        want = st.render_binned(scene, cam, bins, tile_size=32,
                                feature_bytes=feature_bytes)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert r._bins.bins.starts.numel() == TileConfig(96, 64, 32, 32
                                                     ).num_tiles


def _compose(scene, cam):
    return st.compose_scene([(scene, None)], [], cam, tile_size=32)


def _instances(scene, cam):
    return st.render_instances([(scene, None)], cam, tile_size=32)


def _stereo(scene, cam, shared=False):
    right = _t_cam(96, 64, (0.03, 0, 2.2))
    return torch.cat(st.render_stereo(scene, cam, right, tile_size=32,
                                      xr_pixel_ratio=1.0,
                                      shared_bins=shared))


def _renderer(scene, cam):
    return st.SplatRenderer(scene=scene, tile_size=32, device="cpu"
                            ).render(cam)


# entry point -> (call at tile_size=32, the same frame by render())
PASS_ON = {
    "compose_scene": (_compose, lambda s, c: st.render(s, c, tile_size=32)),
    "render_instances": (_instances,
                         lambda s, c: st.render(s, c, tile_size=32)),
    "render_stereo": (_stereo, lambda s, c: torch.cat([
        st.render(s, c, tile_size=32),
        st.render(s, _t_cam(96, 64, (0.03, 0, 2.2)), tile_size=32)])),
    "render_stereo_shared": (lambda s, c: _stereo(s, c, True), None),
    "SplatRenderer": (_renderer, lambda s, c: st.render(s, c, tile_size=32)),
}


@pytest.mark.parametrize("entry", sorted(PASS_ON))
def test_entry_points_pass_tile_size_on(monkeypatch, entry):
    """Every binning under the entry point runs at the edge it was given,
    and the frame is render()'s at that edge."""
    edges = []
    bin_gaussians = _render_mod.bin_gaussians

    def spy(proj, cfg, capacity):
        edges.append((cfg.tile_w, cfg.tile_h))
        return bin_gaussians(proj, cfg, capacity)

    call, same = PASS_ON[entry]
    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    with monkeypatch.context() as m:
        m.setattr(_render_mod, "bin_gaussians", spy)
        got = call(scene, cam)
    assert edges and set(edges) == {(32, 32)}
    if same is not None:
        np.testing.assert_array_equal(got.numpy(), same(scene, cam).numpy())


@pytest.mark.parametrize("edge", (4, 12, 24, 0, (16, 32)))
def test_other_tile_edges_raise(edge):
    tw, th = edge if isinstance(edge, tuple) else (edge, edge)
    with pytest.raises(ValueError, match="8, 16, 32, 64"):
        TileConfig(96, 64, tw, th)
    if tw == th:
        with pytest.raises(ValueError, match="8, 16, 32, 64"):
            st.render(_t_scene(_leaves()), _t_cam(96, 64), tile_size=tw)


@pytest.mark.parametrize("cache_params", (False, True))
def test_render_binned_refuses_bins_of_another_edge(cache_params):
    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    bins = st.bin_scene(scene, cam, tile_size=32, cache_params=cache_params)
    with pytest.raises(ValueError, match="tile_size"):
        st.render_binned(scene, cam, bins)
    with pytest.raises(ValueError, match="tile_size"):
        st.render_binned(scene, _t_cam(160, 64), bins, tile_size=32)
    st.render_binned(scene, cam, bins, tile_size=32)


def test_render_sharded_one_rank(tmp_path):
    """A one-rank gloo group: render_sharded at each edge, both band
    layouts, within 1e-4 of render() at that edge, no instance dropped."""
    from splatjax_torch.parallel import (
        init_distributed, make_mesh, render_sharded,
    )

    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    assert init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cpu")
    try:
        mesh = make_mesh(1, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            for edge in EDGES:
                want = st.render(scene, cam, tile_size=edge)
                for balance in ("load", "equal"):
                    img, overflow = render_sharded(
                        scene, cam, mesh, tile_size=edge, balance=balance,
                        return_overflow=True)
                    assert overflow.tolist() == [0]
                    np.testing.assert_allclose(img.numpy(), want.numpy(),
                                               atol=TOL)
            with pytest.raises(ValueError, match="8, 16, 32, 64"):
                render_sharded(scene, cam, mesh, tile_size=24)
    finally:
        dist.destroy_process_group()
