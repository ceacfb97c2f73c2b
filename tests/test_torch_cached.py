"""Port parity, the cached stale-order redraw: ``bin_scene`` /
``render_binned`` with plain bins and with ``CachedBins``, the plain
version of the port's K3 (``rasterize_cached_fwd`` on CPU tensors) against
splatjax's Pallas ``rasterize_cached_fwd`` (interpret mode), and
``SplatRenderer(resort_interval > 1)``, on the same numpy scene.

Tolerances:
* ``pack_cached_rows`` and the tile index are bit- and integer-equal; the
  cached covariances agree to f32 rounding (1e-5).
* K3's projection against splatjax's ``_project_rows`` through jax.numpy:
  1e-5 of each row's largest |value| (f32 ops in another association by
  XLA), masked opacity equal.
* K3 against splatjax: 1e-2 on r, g, b, T and depth (splatjax's K3 runs
  its power as two bf16 MXU passes and its color sum as a bf16 matmul; the
  port stays in f32); ``chunks_done`` equal without early stop.
* The fused 16-byte redraw against the port's 32-byte cached redraw: 1e-4
  (the same f32 projection; 32-byte rows quantize color and opacity to
  1/65535).
* ``render_binned`` against splatjax: 1e-4 for plain bins and for
  ``CachedBins`` at 32 bytes; 1e-2 at 16 bytes, and PSNR >= 40 dB against
  the exact 32-byte redraw on the same bins.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.io.splat_format import scene_to_splat_bytes
from splatjax.ops import rasterize as jr
from splatjax.ops.binning import TileConfig as JTileConfig
from splatjax.render import bin_scene as j_bin_scene
from splatjax.render import render_binned as j_render_binned
from splatjax.scene import GaussianScene as JScene
from splatjax.viewer import SplatRenderer as JSplatRenderer

import splatjax_torch as st
from splatjax_torch.ops import rasterize as tr
from splatjax_torch.ops.binning import TileConfig

W, H = 96, 64
BIN_EYE = (0.1, -0.1, 2.4)
EYES = {
    "bin_camera": BIN_EYE,
    "moved": (0.12, -0.1, 2.4),
    # inside the scene: instances of the stale bins lie behind the eye
    "behind": (0.05, -0.05, 0.2),
}
TOL = 1e-4
TOL_16 = 1e-2
FIELDS = ("means", "scales", "quats", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(n=400, seed=31):
    s = synthetic_scene(n, seed=seed, extent=0.7, scale_range=(0.02, 0.07))
    return {k: np.asarray(getattr(s, k)) for k in FIELDS}


def _cams(eye, w=W, h=H):
    return (j_make_camera(eye, (0, 0, 0), width=w, height=h),
            st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    """Both packages' scene, plain bins and CachedBins at the bin camera."""
    p = _params()
    jscene = JScene(**{k: jnp.asarray(v) for k, v in p.items()})
    tscene = st.scene_from_numpy(p, device="cpu")
    cj, ct = _cams(BIN_EYE)
    return dict(
        p=p, jscene=jscene, tscene=tscene,
        jplain=j_bin_scene(jscene, cj),
        jcached=j_bin_scene(jscene, cj, cache_params=True),
        tplain=st.bin_scene(tscene, ct),
        tcached=st.bin_scene(tscene, ct, cache_params=True),
    )


def _cached_params_np(cb):
    return [np.asarray(x) for x in (cb.means, cb.cov6, cb.colors,
                                    cb.opacities, cb.max_scales)]


def test_bin_scene_and_cache_match_splatjax(setup):
    jb, tb = setup["jplain"], setup["tplain"]
    for name in ("gauss_id", "starts", "ends"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert int(tb.overflow) == 0 and int(tb.num_instances) > 500
    # tiles that span several 128-instance chunks
    assert int(((tb.ends - tb.starts // 128 * 128 + 127) // 128).max()) > 1
    tc = setup["tcached"]
    assert isinstance(tc, st.CachedBins) and tc.sh is None
    np.testing.assert_array_equal(tc.bins.gauss_id.numpy(),
                                  np.asarray(jb.gauss_id))
    for name, got, want in zip(
            ("means", "cov6", "colors", "opacities", "max_scales"),
            _cached_params_np(tc), _cached_params_np(setup["jcached"])):
        if name == "cov6":
            # R diag(s^2) R^T summed in another order: f32 ulps
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


def test_pack_cached_rows_bit_equal(setup):
    params = _cached_params_np(setup["jcached"])
    want = np.asarray(jr.pack_cached_rows(*map(jnp.asarray, params)))
    got = tr.pack_cached_rows(*(torch.from_numpy(x.copy()) for x in params))
    assert got.shape == (params[0].shape[0], tr.CACHED_ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eye", sorted(EYES))
def test_project_cached_rows_matches_splatjax(setup, eye):
    prm = setup["tcached"].prm
    cj, ct = _cams(EYES[eye])
    want = np.asarray(jr._project_rows(
        jnp.asarray(prm.numpy().T),
        jr.make_camera_table(cj.modelview, cj.projection),
        width=W, height=H))                                  # (10, K)
    got = np.stack([r.numpy() for r in tr.project_cached_rows(
        prm, ct.modelview, ct.projection, W, H)])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[8], want[8])           # masked opacity
    kept = want[8] > 0
    assert kept.any()
    if eye == "behind":
        assert (want[9] >= 0).any() and not kept.all()
    for r in range(10):
        scale = np.abs(want[r][kept]).max()
        np.testing.assert_allclose(got[r][kept], want[r][kept], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"row {r}")


# (alpha_clip, early_stop)
K3_CASES = {"clip999_es1e-4": (0.999, 1e-4), "noclip_exact": (None, 0.0)}


@pytest.mark.parametrize("eye", ["bin_camera", "moved"])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_rasterize_cached_plain_matches_splatjax(setup, case, eye):
    clip, es = K3_CASES[case]
    jc, tc = setup["jcached"], setup["tcached"]
    cj, ct = _cams(EYES[eye])
    want, _ = jr.rasterize_cached_fwd(
        jc.prm_cm, jr.make_camera_table(cj.modelview, cj.projection),
        jc.bins.starts, jc.bins.ends, JTileConfig(W, H),
        alpha_clip=clip, early_stop=es)
    want = np.asarray(want)
    got = tr.rasterize_cached_fwd(
        tc.prm, tr.cached_camera(ct.modelview, ct.projection, W, H),
        tc.bins.starts, tc.bins.ends, TileConfig(W, H), clip, es).numpy()
    assert got.shape == want.shape == (24, 8, 256)
    if es == 0.0:
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
    rows = [0, 1, 2, 3, 5]
    err = np.abs(got[:, rows] - want[:, rows]).max()
    assert err <= TOL_16, (case, eye, err)
    assert (1.0 - got[:, 3]).max() > 0.5


@pytest.mark.parametrize("eye", ["bin_camera", "moved"])
def test_fused_redraw_matches_32byte_cached_redraw(setup, eye):
    _, ct = _cams(EYES[eye])
    tc = setup["tcached"]
    fused = st.render_binned(None, ct, tc, feature_bytes=16)
    full = st.render_binned(None, ct, tc, feature_bytes=32)
    assert float(full[..., 3].max()) > 0.5
    assert float((fused - full).abs().max()) <= TOL


def _psnr(x, ref):
    mse = float(np.mean((x - ref) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("eye", ["bin_camera", "moved"])
@pytest.mark.parametrize("kind", ["plain", "cached32", "cached16"])
def test_render_binned_matches_splatjax(setup, kind, eye):
    cj, ct = _cams(EYES[eye])
    fb = 16 if kind == "cached16" else 32
    key = "plain" if kind == "plain" else "cached"
    want = np.asarray(j_render_binned(setup["jscene"], cj, setup["j" + key],
                                      feature_bytes=fb))
    got = st.render_binned(setup["tscene"], ct, setup["t" + key],
                           feature_bytes=fb).numpy()
    assert got.shape == want.shape == (H, W, 4)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_16 if fb == 16 else TOL)
    if kind == "cached16":
        exact = st.render_binned(setup["tscene"], ct, setup["tplain"],
                                 feature_bytes=32).numpy()
        assert _psnr(got, exact) >= 40.0
    if kind == "plain" and eye == "bin_camera":
        # the binned redraw at its own camera is the full render
        full = st.render(setup["tscene"], ct).numpy()
        np.testing.assert_allclose(got, full, rtol=0, atol=TOL)


def _cutout():
    box = np.eye(4, dtype=np.float32)
    box[:3, 3] = [0.2, 0.0, 0.1]
    return np.linalg.inv(box).astype(np.float32)


# the cached branches past K3: name -> (SH bands, bin_scene and
# render_binned keyword arguments)
CACHED_BRANCHES = {
    "sh": (3, {}),
    "cutout": (0, dict(cutout=_cutout())),
    "viewer_exact": (0, dict(viewer_exact=True)),
}


@pytest.mark.parametrize("eye", ["bin_camera", "moved"])
@pytest.mark.parametrize("branch", sorted(CACHED_BRANCHES))
def test_render_binned_cached_branches_match_splatjax(branch, eye):
    """CachedBins drawn through the projection, pack and K2 (no K3): with
    SH bands, a cutout or viewer_exact, at 32-byte rows, against
    splatjax's render_binned on its own CachedBins."""
    bands, kw = CACHED_BRANCHES[branch]
    p = _params()
    if bands:
        rng = np.random.default_rng(32)
        p["sh"] = (rng.normal(size=(len(p["means"]), bands, 3))
                   * 0.2).astype(np.float32)
    jscene = JScene(**{k: jnp.asarray(v) for k, v in p.items()})
    tscene = st.scene_from_numpy(p, device="cpu")
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    cj, ct = _cams(BIN_EYE)
    jbins = j_bin_scene(jscene, cj, cache_params=True, **jkw)
    tbins = st.bin_scene(tscene, ct, cache_params=True, **kw)
    assert (tbins.sh is None) == (bands == 0)
    cj, ct = _cams(EYES[eye])
    want = np.asarray(j_render_binned(jscene, cj, jbins, **jkw))
    got = st.render_binned(tscene, ct, tbins, **kw).numpy()
    assert got.shape == want.shape == (H, W, 4)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_cached_bins_fields_are_views_of_prm(setup):
    """CachedBins stores its parameters once: the five fields share
    ``prm``'s storage and are its ``pack_cached_rows`` columns."""
    tc = setup["tcached"]
    fields = (tc.means, tc.cov6, tc.colors, tc.opacities, tc.max_scales)
    for f in fields:
        assert f.untyped_storage().data_ptr() == \
            tc.prm.untyped_storage().data_ptr()
    assert torch.equal(tr.pack_cached_rows(*fields), tc.prm)


def test_stale_bins_behind_the_eye_stay_finite(setup):
    _, ct = _cams(EYES["behind"])
    tc = setup["tcached"]
    imgs = {
        "fused": st.render_binned(None, ct, tc, feature_bytes=16),
        "cached32": st.render_binned(None, ct, tc, feature_bytes=32),
        "plain": st.render_binned(setup["tscene"], ct, setup["tplain"]),
    }
    for name, img in imgs.items():
        assert bool(torch.isfinite(img).all()), name
        assert float(img[..., 3].max()) > 0.1, name
    assert float((imgs["fused"] - imgs["cached32"]).abs().max()) <= TOL


def test_render_binned_gradient_matches_render(setup):
    p = setup["p"]
    _, ct = _cams(BIN_EYE)
    rng = np.random.default_rng(3)
    tgt = torch.from_numpy(rng.normal(size=(H, W, 4)).astype(np.float32))
    bins = setup["tplain"]
    grads = []
    for binned in (False, True):
        params = st.TrainableGaussians.from_scene(
            st.scene_from_numpy(p, device="cpu"))
        scene = params.to_scene()
        img = (st.render_binned(scene, ct, bins) if binned
               else st.render(scene, ct))
        (img * tgt).sum().backward()
        grads.append({k: getattr(params, k).grad.clone()
                      for k in ("means", "log_scales", "quats",
                                "logit_opacities", "colors")})
    for k, want in grads[0].items():
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((grads[1][k] - want).abs().max()) <= 1e-5 * scale, k


def _renderer_setup(n=150, seed=9):
    p = _params(n, seed)
    return p, _cams((0.1, -0.2, 2.4), 64, 48)


def test_splat_renderer_resort_interval_static_camera():
    p, (cj, ct) = _renderer_setup()
    scene = st.scene_from_numpy(p, device="cpu")
    ref = st.SplatRenderer(scene=scene, device="cpu").render(ct)
    r = st.SplatRenderer(scene=scene, resort_interval=3, device="cpu")
    jr_ = JSplatRenderer(scene=JScene(**{k: jnp.asarray(v)
                                         for k, v in p.items()}),
                         resort_interval=3)
    for i in range(5):  # crosses a resort boundary
        frame = r.render(ct)
        assert r._frames_since_sort == i % 3 + 1
        torch.testing.assert_close(frame, ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(frame.numpy(), np.asarray(jr_.render(cj)),
                               rtol=0, atol=TOL)


def test_splat_renderer_resort_cache_rebuilds():
    p, (_, ct) = _renderer_setup()
    scene = st.scene_from_numpy(p, device="cpu")
    r = st.SplatRenderer(scene=scene, resort_interval=10, device="cpu")
    before = r.render(ct)
    bins = r._bins
    # a viewport change rebuilds the index
    small = st.make_camera((0.1, -0.2, 2.4), (0, 0, 0), width=32, height=24,
                           device="cpu")
    assert r.render(small).shape == (24, 32, 4) and r._bins is not bins
    # feed() makes a new scene object: the index is rebuilt at once
    r.render(ct)
    extra = synthetic_scene(40, seed=10, extent=0.4,
                            scale_range=(0.05, 0.12))
    r.feed(scene_to_splat_bytes(extra))
    after = r.render(ct)
    assert r._frames_since_sort == 1
    fresh = st.SplatRenderer(scene=r.scene, device="cpu").render(ct)
    torch.testing.assert_close(after, fresh, rtol=0, atol=5e-5)
    assert float((after - before).abs().max()) > 1e-3


def test_splat_renderer_overrides_take_the_exact_path():
    p, (_, ct) = _renderer_setup()
    scene = st.scene_from_numpy(p, device="cpu")
    r = st.SplatRenderer(scene=scene, resort_interval=4, device="cpu")
    with pytest.warns(UserWarning, match="resort_interval ignored"):
        img = r.render(ct, early_stop=0.0)
    assert r._bins is None
    torch.testing.assert_close(img, st.render(scene, ct, early_stop=0.0),
                               rtol=0, atol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.render(ct)
    assert r._bins is not None


def test_rasterize_cached_wrapper_rejects_bad_inputs(setup):
    tc = setup["tcached"]
    _, ct = _cams(BIN_EYE)
    cam = tr.cached_camera(ct.modelview, ct.projection, W, H)
    cfg = TileConfig(W, H)
    starts, ends = tc.bins.starts, tc.bins.ends
    with pytest.raises(ValueError, match="prm"):
        tr.rasterize_cached_fwd(tc.prm[:, :8].contiguous(), cam, starts,
                                ends, cfg)
    with pytest.raises(ValueError, match="prm"):
        tr.rasterize_cached_fwd(tc.prm.double(), cam, starts, ends, cfg)
    with pytest.raises(ValueError, match="starts"):
        tr.rasterize_cached_fwd(tc.prm, cam, starts.long(), ends, cfg)
    with pytest.raises(ValueError, match="camera is 48x32"):
        tr.rasterize_cached_fwd(tc.prm, cam._replace(width=48, height=32),
                                starts, ends, cfg)
