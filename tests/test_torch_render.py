"""Port parity, end to end: splatjax_torch.render against splatjax.render
(CPU, Pallas in interpret mode) on the same numpy scene, the port's render
against its own O(N x P) reference, and the SplatRenderer surface.

Tolerances: 1e-4 absolute against splatjax (both composite the same
32-byte rows in f32, in different summation orders); 1e-3 against the
reference (the viewer-parity budget: the rows quantize color and opacity
to 1/65535).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.render import render as j_render
from splatjax.scene import GaussianScene as JScene

import splatjax_torch as st
from splatjax_torch.io import load_splat
from splatjax_torch.reference import render_reference

W, H = 80, 64
TOL = 1e-4
REF_TOL = 1e-3
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_scene.splat")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(n=300, seed=21, sh_bands=0):
    s = synthetic_scene(n, seed=seed, extent=0.6, scale_range=(0.02, 0.08))
    d = {k: np.asarray(getattr(s, k)) for k in
         ("means", "scales", "quats", "colors", "opacities")}
    if sh_bands:
        rng = np.random.default_rng(seed + 1)
        d["sh"] = (rng.normal(size=(n, sh_bands, 3)) * 0.2).astype(np.float32)
    return d


def _cams(w=W, h=H, eye=(0, 0, 2.2)):
    return (j_make_camera(eye, (0, 0, 0), width=w, height=h),
            st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu"))


def _cutout():
    box = np.eye(4, dtype=np.float32)
    box[:3, 3] = [0.2, 0.0, 0.1]
    return np.linalg.inv(box).astype(np.float32)


def _model():
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[:3, 3] = [0.05, -0.1, 0.0]
    return m


def _zbuf(w=W, h=H):
    z = np.full((h, w), -2.2, np.float32)
    z[:, : w // 2] = -np.inf
    return z


# name -> (scene kwargs, camera size, render kwargs)
RENDER_CASES = {
    "default": ({}, (W, H), {}),
    "background": ({}, (W, H), dict(background=np.array(
        [0.1, 0.9, 0.2], np.float32))),
    "depth": ({}, (W, H), dict(return_depth=True, alpha_clip=None)),
    "nonsquare_72x40": ({"seed": 23}, (72, 40), dict(early_stop=0.0)),
    "overflow": ({"seed": 29}, (W, H), dict(capacity=256,
                                           return_overflow=True)),
    "viewer_exact": ({"seed": 24}, (W, H), dict(viewer_exact=True,
                                               early_stop=0.0)),
    "cutout_model": ({"seed": 25}, (W, H), dict(cutout=_cutout(),
                                               model=_model())),
    "zbuf_sh": ({"seed": 26, "sh_bands": 8}, (W, H), dict(zbuf=_zbuf())),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_splatjax(case):
    scene_kw, (w, h), kw = RENDER_CASES[case]
    p = _params(**scene_kw)
    cj, ct = _cams(w, h)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = j_render(JScene(**{k: jnp.asarray(v) for k, v in p.items()}),
                    cj, **jkw)
    got = st.render(st.scene_from_numpy(p, device="cpu"), ct, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    img_t, img_j = got[0].numpy(), np.asarray(want[0])
    assert img_t.shape == img_j.shape == (h, w, 4)
    assert img_j[..., 3].max() > 0.5
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=TOL)
    if kw.get("return_depth"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=TOL)
    if kw.get("return_overflow"):
        assert int(got[-1]) == int(want[-1]) > 0


def test_render_empty_scene():
    p = {k: v[:0] for k, v in _params(n=4).items()}
    _, ct = _cams(32, 32)
    img, depth, ov = st.render(st.scene_from_numpy(p, device="cpu"), ct,
                               return_depth=True, return_overflow=True)
    assert img.shape == (32, 32, 4) and depth.shape == (32, 32)
    assert (img == 0).all() and (depth == 0).all() and int(ov) == 0


@pytest.mark.parametrize("case", ["plain", "viewer_exact"])
def test_render_matches_port_reference(case):
    exact = case == "viewer_exact"
    scene = st.scene_from_numpy(_params(seed=22), device="cpu")
    _, ct = _cams(eye=(0.1, -0.2, 2.0))
    ours = st.render(scene, ct, early_stop=0.0, viewer_exact=exact)
    ref = render_reference(scene, ct, viewer_exact=exact, pixel_chunk=512)
    assert float(ref[..., 3].max()) > 0.5
    assert float((ours - ref).abs().max()) < REF_TOL


def test_splat_renderer_surface():
    cam = st.make_camera((0, 0, 2.8), (0, 0, 0), width=64, height=48,
                         device="cpu")
    scene = load_splat(FIXTURE, device="cpu")
    want = st.render(scene, cam)
    r = st.SplatRenderer(src=FIXTURE, device="cpu")
    assert r.scene.num_gaussians == scene.num_gaussians
    torch.testing.assert_close(r.render(cam), want, rtol=0, atol=0)
    # progressive feed in odd-sized chunks gives the same scene
    fed = st.SplatRenderer(device="cpu")
    data = open(FIXTURE, "rb").read()
    for i in range(0, len(data), 1000):
        fed.feed(data[i:i + 1000])
    torch.testing.assert_close(fed.render(cam), want, rtol=0, atol=0)
    half = r.render(cam, xr=True)
    assert half.shape == (24, 32, 4)
    capped = st.SplatRenderer(src=FIXTURE, max_splats=100, device="cpu")
    assert capped.scene.num_gaussians == 100


def test_unported_paths_raise():
    # 16-byte training rows render now: the image against splatjax's
    # 16-byte image, within 1e-2 (splatjax's 16-byte mode runs its scans
    # as single bf16 MXU passes; the port stays in f32), and through
    # SplatRenderer too
    p = _params(n=300, seed=33)
    scene = st.scene_from_numpy(p, device="cpu")
    cj, ct = _cams(W, H)
    want = np.asarray(j_render(JScene(**{k: jnp.asarray(v)
                                          for k, v in p.items()}),
                               cj, feature_bytes=16))
    got = st.render(scene, ct, feature_bytes=16)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    r = st.SplatRenderer(scene=scene, feature_bytes=16, device="cpu")
    torch.testing.assert_close(r.render(ct), got, rtol=0, atol=0)
    # the cached stale-order redraw renders now: at the camera its index
    # was built with, a 16-byte redraw (K3's plain version) projects in f32
    # without the rows' quantization, so it stays within 1e-3 of the
    # 32-byte render
    exact = st.render(scene, ct)
    stale = st.SplatRenderer(scene=scene, resort_interval=4,
                             feature_bytes=16, device="cpu")
    for _ in range(2):
        torch.testing.assert_close(stale.render(ct), exact, rtol=0,
                                   atol=1e-3)
    assert stale._frames_since_sort == 2
    # .ply assets load now (held to splatjax in test_torch_stream.py): the
    # renderer's scene is load_ply's
    ply = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_scene.ply")
    loaded = st.SplatRenderer(src=ply, device="cpu").scene
    want_scene = st.io.load_ply(ply, backend="numpy", device="cpu")
    for f in ("means", "scales", "quats", "colors", "opacities"):
        assert torch.equal(getattr(loaded, f), getattr(want_scene, f))
