"""Port parity, stereo, multi-instance frames and composition:
``render_stereo``, ``render_instances``, ``composite_over``,
``merge_opaque_layers``, ``compose_scene`` and ``importance`` /
``select_important`` against splatjax (CPU, Pallas in interpret mode) on
the same numpy inputs.

Tolerances: 1e-4 for the rendered frames (both packages composite the same
32-byte rows in f32, in different summation orders); the shared-bins right
eye also stays >= 30 dB from its exact render; the merge, the
under-composite and the LOD selection are exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.compose import OpaqueLayer as JOpaqueLayer
from splatjax.compose import compose_scene as j_compose_scene
from splatjax.compose import merge_opaque_layers as j_merge
from splatjax.io import synthetic_scene
from splatjax.render import composite_over as j_composite_over
from splatjax.render import render_instances as j_render_instances
from splatjax.render import render_stereo as j_render_stereo
from splatjax.scene import GaussianScene as JScene
from splatjax.scene import importance as j_importance
from splatjax.scene import select_important as j_select_important

import splatjax_torch as st

W, H = 64, 48
TOL = 1e-4
FIELDS = ("means", "scales", "quats", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(n, seed, extent=0.6):
    s = synthetic_scene(n, seed=seed, extent=extent,
                        scale_range=(0.02, 0.08))
    return {k: np.asarray(getattr(s, k)) for k in FIELDS}


def _scenes(p):
    return (JScene(**{k: jnp.asarray(v) for k, v in p.items()}),
            st.scene_from_numpy(p, device="cpu"))


def _cams(eye, w=W, h=H):
    return (j_make_camera(eye, (0, 0, 0), width=w, height=h),
            st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def _psnr(x, ref):
    mse = float(np.mean((np.asarray(x) - np.asarray(ref)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("shared_bins", [False, True])
def test_render_stereo_matches_splatjax(shared_bins):
    js, ts = _scenes(_params(250, 61))
    # a 6 cm baseline at full resolution 128x96, rendered at ratio 0.5
    (jl, tl), (jr_, tr_) = (_cams((x, 0.0, 2.2), 128, 96)
                            for x in (-0.03, 0.03))
    want = j_render_stereo(js, jl, jr_, shared_bins=shared_bins)
    got = st.render_stereo(ts, tl, tr_, shared_bins=shared_bins)
    for g, w in zip(got, want):
        assert g.shape == (48, 64, 4) and np.asarray(w)[..., 3].max() > 0.5
        _close(g, w)
    if shared_bins:
        exact = st.render_stereo(ts, tl, tr_)[1]
        assert _psnr(got[1], exact) >= 30.0


def _model(angle, shift):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[:3, 3] = shift
    return m


def _cutout():
    box = np.eye(4, dtype=np.float32)
    box[:3, :3] *= 0.8
    box[:3, 3] = [0.2, 0.0, 0.1]
    return np.linalg.inv(box).astype(np.float32)


def _instances():
    """Two entities: one with a model transform and a cutout, one with
    another model; each as (splatjax, port) instance tuples."""
    ja, ta = _scenes(_params(200, 62))
    jb, tb = _scenes(_params(150, 63, extent=0.4))
    ma, mb = _model(0.3, [0.1, -0.05, 0.0]), _model(-0.5, [-0.2, 0.1, 0.3])
    cut = _cutout()
    return ([(ja, jnp.asarray(ma), jnp.asarray(cut)), (jb, jnp.asarray(mb))],
            [(ta, ma, cut), (tb, mb)])


def test_render_instances_matches_splatjax():
    jinst, tinst = _instances()
    cj, ct = _cams((0.0, 0.0, 2.2))
    want = j_render_instances(jinst, cj, return_depth=True,
                              return_overflow=True)
    got = st.render_instances(tinst, ct, return_depth=True,
                              return_overflow=True)
    assert np.asarray(want[0])[..., 3].max() > 0.5
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert int(got[2]) == int(want[2]) == 0


def test_composite_over_exact():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(H, W, 4)).astype(np.float32)
    under = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) > 0.5
    for m in (None, mask):
        want = np.asarray(j_composite_over(
            jnp.asarray(img), jnp.asarray(under),
            None if m is None else jnp.asarray(m)))
        got = st.composite_over(torch.from_numpy(img), under, m)
        np.testing.assert_array_equal(got.numpy(), want)


def _layers():
    rng = np.random.default_rng(5)
    z1 = rng.uniform(-4.0, -1.8, (H, W)).astype(np.float32)
    z2 = rng.uniform(-4.0, -1.8, (H, W)).astype(np.float32)
    z2[:, : W // 3] = -np.inf                 # layer 2 covers the middle
    z2[:, 2 * W // 3:] = -np.inf
    z1[:, 2 * W // 3:] = -np.inf              # nothing opaque on the right
    c1 = rng.random((H, W, 3)).astype(np.float32)
    c2 = rng.random((H, W, 3)).astype(np.float32)
    return [(c1, z1), (c2, z2)]


def test_merge_opaque_layers_exact():
    layers = _layers()
    want = j_merge([JOpaqueLayer(*map(jnp.asarray, lz)) for lz in layers])
    got = st.merge_opaque_layers([st.OpaqueLayer(*lz) for lz in layers])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compose_scene_matches_splatjax():
    jinst, tinst = _instances()
    layers = _layers()
    cj, ct = _cams((0.0, 0.0, 2.2))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = j_compose_scene(
        jinst, [JOpaqueLayer(*map(jnp.asarray, lz)) for lz in layers], cj,
        background=jnp.asarray(bg), early_stop=0.0)
    got = st.compose_scene(tinst, [st.OpaqueLayer(*lz) for lz in layers],
                           ct, background=bg, early_stop=0.0)
    want = np.asarray(want)
    assert got.shape == want.shape == (H, W, 4)
    assert (want[..., 3] == 1.0).any() and (want[..., 3] < 1.0).any()
    _close(got, want)


def test_select_important_matches_splatjax():
    p = _params(300, 64)
    p["opacities"][::7] = p["opacities"][1]   # ties keep index order
    p["scales"][::7] = p["scales"][1]
    js, ts = _scenes(p)
    np.testing.assert_allclose(st.importance(ts).numpy(),
                               np.asarray(j_importance(js)), rtol=1e-6)
    for fraction in (0.25, 0.5, 1.0):
        want = j_select_important(js, fraction)
        got = st.select_important(ts, fraction)
        assert got.num_gaussians == want.num_gaussians
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
    with pytest.raises(ValueError, match="fraction"):
        st.select_important(ts, 0.0)
