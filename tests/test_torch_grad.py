"""Port parity, gradient of the render: the 16-byte rows and K2's 16-byte
decode, the plain version of the port's K4 (``rasterize_bwd`` on CPU
tensors) against splatjax's ``_bwd_pallas`` (interpret mode), and the
port's ``render(...).backward()`` against ``jax.grad`` of splatjax's
``render`` on the same numpy parameters; then the edge cases splatjax
tests for its gradient.

Tolerances:
* ``pack_feature_table16`` is bit-equal.
* K2, 16-byte rows, against splatjax: 1e-2 absolute on r, g, b, T and
  depth; ``chunks_done`` equal. splatjax's 16-byte mode runs its scans and
  color sums as single bf16 MXU passes (2^-9 relative per term); the port
  stays in f32.
* K2 and K4 on 16-byte rows against the same rows re-expressed exactly in
  the 32-byte layout: 1e-5 (K2; the colors decode one f32 ulp apart) and
  2^-8 relative plus 1e-5 of the channel's largest |gradient| (K4: the
  bf16 rounding of its packed output, and those ulps).
* K4, 32-byte rows, against splatjax: 2e-4 of each channel's largest
  |gradient| (f32 in another summation order; measured <= 4e-5).
  16-byte rows: 5e-2 of the channel's largest |gradient| (splatjax's
  single-pass bf16 scans; measured <= 2e-2).
* End-to-end gradients w.r.t. every ``TrainableGaussians`` leaf: atol
  2e-3 x the largest |gradient|, rtol 2e-3, for 32-byte rows (the bound of
  splatjax's own gradient test, tests/test_tiled_pipeline.py:106); cosine
  > 0.999 per leaf for 16-byte rows (splatjax's 16-byte contract).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.ops import rasterize as jr
from splatjax.ops import rasterize_vjp as jv
from splatjax.ops.binning import TileConfig as JTileConfig
from splatjax.ops.binning import bin_gaussians as j_bin
from splatjax.ops.binning import features_from_projection
from splatjax.ops.projection import project_gaussians
from splatjax.render import render as j_render
from splatjax.scene import TrainableGaussians as JTrainable
from splatjax.scene import build_covariances

import splatjax_torch as st
from splatjax_torch.ops import rasterize as tr
from splatjax_torch.ops import rasterize_vjp as tv
from splatjax_torch.ops.binning import TileConfig
from splatjax_torch.ops.segreduce import unpack_bf16_pairs

W, H = 48, 32
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")
K2_16_TOL = 1e-2
K4_TOL = {False: 2e-4, True: 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def binned():
    """A dense 6-tile frame (several chunks per tile, unaligned starts,
    early-stopping tiles) and a z-buffer covering two thirds of it."""
    scene = synthetic_scene(1200, seed=41, extent=0.35,
                            scale_range=(0.04, 0.1),
                            opacity_range=(0.6, 1.0))
    cam = j_make_camera((0, 0, 0.9), (0, 0, 0), width=W, height=H)
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, W, H,
        max_scales=jnp.max(jnp.asarray(scene.scales), axis=-1),
    )
    b = j_bin(proj, JTileConfig(W, H), 16384, with_features=False)
    assert int(b.overflow) == 0
    depth = np.asarray(proj.depth)
    zbuf = np.full((H, W), float(np.median(depth)), np.float32)
    zbuf[:, : W // 3] = -np.inf
    return dict(feat_n=np.asarray(features_from_projection(proj)),
                gid=np.asarray(b.gauss_id), starts=np.asarray(b.starts),
                ends=np.asarray(b.ends), zbuf=zbuf)


def test_pack_feature_table16_bit_equal(binned):
    feat = binned["feat_n"].copy()
    rng = np.random.default_rng(2)
    # means off the fixed-point range, colors and opacity out of [0, 1]
    feat[:8, 0] = [-3000.0, 7000.0, -2048.0, 6143.9, 0.0625, 0.1875,
                   -0.0625, 1e9]
    feat[8:16, 5] = rng.uniform(-0.5, 1.5, 8)
    feat[16:24, 8] = rng.uniform(-0.5, 1.5, 8)
    want = np.asarray(jr.pack_feature_table16(jnp.asarray(feat)))
    got = tr.pack_feature_table16(_t(feat))
    assert got.dtype == torch.int32 and got.shape == (feat.shape[0], 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tr.pack_feature_rows(_t(feat.T), packed16=True).numpy(), want)
    np.testing.assert_array_equal(
        tr.pack_feature_rows(_t(feat.T)).numpy(),
        np.asarray(jr.pack_feature_table(jnp.asarray(feat))))
    # the decode is splatjax's unpack_chunk16
    rows = jnp.asarray(want[:300].T)
    for a, b in zip(tr.decode_rows(got[:300], packed16=True),
                    jr.unpack_chunk16(rows)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[0])


def _rows(d, packed16):
    pack = tr.pack_feature_table16 if packed16 else tr.pack_feature_table
    return tr.gather_rows(pack(_t(d["feat_n"])), _t(d["gid"]))


def _as_rows32(rows16):
    """16-byte rows re-expressed in the 32-byte layout: every decoded value
    is exact there (255 divides 65535: r8 / 255 == 257 r8 / 65535)."""
    f = tr.decode_rows(rows16, packed16=True)
    l3 = rows16[:, 3]
    c16 = [((l3 >> s) & 255) * 257 for s in (24, 16, 8)]
    opa16 = rows16[:, 2] & 0xFFFF
    return torch.stack(
        [f[0].view(torch.int32), f[1].view(torch.int32),
         f[2].view(torch.int32), f[3].view(torch.int32),
         f[4].view(torch.int32), (c16[0] << 16) | c16[1],
         (c16[2] << 16) | opa16, f[9].view(torch.int32)], dim=1)


def _splatjax_fwd(d, packed16, clip, zbuf):
    cfg = JTileConfig(W, H)
    pack = jr.pack_feature_table16 if packed16 else jr.pack_feature_table
    feat_cm = jr.gather_chunk_major(pack(jnp.asarray(d["feat_n"])),
                                    jnp.asarray(d["gid"]))
    zb = None if zbuf is None else jr.zbuffer_to_tiles(jnp.asarray(zbuf),
                                                       cfg)
    out, chunks = jr.rasterize_cm_fwd(
        feat_cm, jnp.asarray(d["starts"]), jnp.asarray(d["ends"]), cfg,
        alpha_clip=clip, early_stop=1e-4, zbuf=zb, packed16=packed16)
    return feat_cm, zb, out, chunks


def test_rasterize16_plain_matches_splatjax(binned):
    cfg = TileConfig(W, H)
    for clip, use_zb in ((0.999, False), (None, True)):
        zbuf = binned["zbuf"] if use_zb else None
        _, _, want, _ = _splatjax_fwd(binned, True, clip, zbuf)
        want = np.asarray(want)
        rows16 = _rows(binned, True)
        zb = None if zbuf is None else tr.zbuffer_to_tiles(_t(zbuf), cfg)
        got = tr.rasterize_fwd(rows16, _t(binned["starts"]),
                               _t(binned["ends"]), cfg, clip, 1e-4, zb,
                               packed16=True).numpy()
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        ch = [0, 1, 2, 3, 5]
        assert np.abs(got[:, ch] - want[:, ch]).max() <= K2_16_TOL
        # the same rows in the 32-byte layout render the same tiles
        got32 = tr.rasterize_fwd(_as_rows32(rows16), _t(binned["starts"]),
                                 _t(binned["ends"]), cfg, clip, 1e-4,
                                 zb).numpy()
        np.testing.assert_array_equal(got[:, 4], got32[:, 4])
        assert np.abs(got[:, ch] - got32[:, ch]).max() <= 1e-5


# (packed16, alpha_clip, zbuf, cotangent channels)
K4_CASES = {
    "32_clip999_img": (False, 0.999, False, 4),
    "32_noclip_depth": (False, None, False, 8),
    "32_clip999_zbuf": (False, 0.999, True, 8),
    "32_clip_rounds_to_1": (False, 1.0 - 1e-8, False, 4),
    "16_clip999_img": (True, 0.999, False, 4),
    "16_noclip_zbuf": (True, None, True, 8),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_rasterize_bwd_plain_matches_splatjax(binned, case):
    packed16, clip, use_zb, gch = K4_CASES[case]
    cfg = TileConfig(W, H)
    zbuf = binned["zbuf"] if use_zb else None
    feat_cm, zb_j, out_j, chunks = _splatjax_fwd(binned, packed16, clip,
                                                 zbuf)
    g_out = np.random.default_rng(3).normal(
        size=(cfg.num_tiles, gch, 256)).astype(np.float32)
    want = np.asarray(jv._bwd_pallas(
        feat_cm, jnp.asarray(binned["starts"]), jnp.asarray(binned["ends"]),
        chunks, out_j, jnp.asarray(g_out), JTileConfig(W, H), clip,
        zbuf=zb_j, packed16=packed16))
    rows = _rows(binned, packed16)
    k = rows.shape[0]
    zb = None if zbuf is None else tr.zbuffer_to_tiles(_t(zbuf), cfg)
    args = (_t(binned["starts"]), _t(binned["ends"]), _t(np.asarray(out_j)),
            _t(g_out), cfg, clip, zb)
    got = tv.rasterize_bwd(rows, *args, packed16=packed16)
    if packed16:
        assert got.dtype == torch.int32 and got.shape == (k, 8)
        want = unpack_bf16_pairs(_t(want.T[:k].copy())).numpy()
        # against the same rows in the 32-byte layout: only the bf16
        # rounding of the packed output differs
        g32 = tv.rasterize_bwd(_as_rows32(rows), *args).numpy()
        got = unpack_bf16_pairs(got).numpy()
        tol = 2.0 ** -8 * np.abs(g32) + 1e-5 * np.abs(g32).max(axis=0)
        assert (np.abs(got - g32) <= tol).all()
    else:
        assert got.dtype == torch.float32 and got.shape == (k, 16)
        want = want.T[:k]
        got = got.numpy()
    scale = np.abs(want).max(axis=0) + 1e-30
    assert (np.abs(got - want) <= K4_TOL[packed16] * scale).all(), \
        (np.abs(got - want) / scale).max(axis=0)
    assert np.abs(want[:, :9]).max() > 0 and np.isfinite(got).all()


def _loss_case(n, seed, w, h, kw):
    scene = synthetic_scene(n, seed=seed, extent=0.6,
                            scale_range=(0.02, 0.08))
    leaves = {k: np.asarray(getattr(JTrainable.from_scene(scene), k))
              for k in LEAVES}
    tgt = np.random.default_rng(seed).normal(size=(h, w, 4)).astype(
        np.float32)
    return leaves, tgt, (j_make_camera((0, 0, 2.2), (0, 0, 0), width=w,
                                       height=h),
                         st.make_camera((0, 0, 2.2), (0, 0, 0), width=w,
                                        height=h, device="cpu"))


def _weighted(out, tgt, xp_sum):
    if isinstance(out, tuple):   # image and depth
        return xp_sum(out[0] * tgt) + xp_sum(out[1] * tgt[..., 0])
    return xp_sum(out * tgt)


# name -> (SPLATJAX_GRAD_GATHER, scene (n, seed, w, h), render kwargs)
GRAD_CASES = {
    "32_f32": ("f32", (120, 27, W, H), {}),
    "32_i16_default": ("i16", (120, 27, W, H), {}),
    "32_f32_depth_zbuf": ("f32", (120, 28, W, H), dict(
        return_depth=True, zbuf=np.full((H, W), -2.3, np.float32))),
    "16_i16": ("i16", (300, 33, 80, 64), dict(feature_bytes=16)),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_render_gradients_match_jax_grad(monkeypatch, case):
    mode, scene_args, kw = GRAD_CASES[case]
    monkeypatch.setenv("SPLATJAX_GRAD_GATHER", mode)
    jax.clear_caches()        # splatjax reads the mode at trace time
    leaves, tgt, (cj, ct) = _loss_case(*scene_args, kw)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jax.grad(lambda p: _weighted(j_render(p.to_scene(), cj, **jkw),
                                        tgt, jnp.sum))(
        JTrainable(**{k: jnp.asarray(v) for k, v in leaves.items()}))
    params = st.trainable_from_numpy(leaves, device="cpu")
    _weighted(st.render(params.to_scene(), ct, **kw), _t(tgt),
              torch.sum).backward()
    jax.clear_caches()
    got = {k: getattr(params, k).grad.numpy() for k in LEAVES}
    want = {k: np.asarray(getattr(want, k)) for k in LEAVES}
    if kw.get("feature_bytes") == 16:
        for k in LEAVES:
            a, b = got[k].ravel(), want[k].ravel()
            assert np.isfinite(a).all(), k
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.999, (k, cos)
        return
    f1 = np.concatenate([got[k].ravel() for k in LEAVES])
    f2 = np.concatenate([want[k].ravel() for k in LEAVES])
    assert np.isfinite(f1).all()
    scale = np.abs(f2).max()
    assert scale > 0
    np.testing.assert_allclose(f1, f2, atol=2e-3 * scale, rtol=2e-3)


def test_background_gradient():
    """The background is differentiable: d/d bg_c = sum_pixels g_c T."""
    leaves, tgt, (_, ct) = _loss_case(80, 29, W, H, {})
    scene = st.trainable_from_numpy(leaves, device="cpu").to_scene()
    bg = torch.tensor([0.1, 0.9, 0.2], requires_grad=True)
    _weighted(st.render(scene, ct, background=bg), _t(tgt),
              torch.sum).backward()
    t_final = 1.0 - st.render(scene, ct)[..., 3].detach()
    want = (_t(tgt)[..., :3] * t_final[..., None]).sum(dim=(0, 1))
    torch.testing.assert_close(bg.grad, want, rtol=1e-5, atol=1e-5)


def _scalar_grads(scene_fn, leaves, cam, loss_fn, **kw):
    params = st.trainable_from_numpy(leaves, device="cpu")
    loss_fn(st.render(scene_fn(params), cam, **kw)).backward()
    return [getattr(params, k).grad for k in LEAVES]


def _one_tile_feats(k, conic, opacity):
    feat = np.zeros((16, k), np.float32)
    feat[0] = feat[1] = 8.5      # mean on a pixel center: power == 0 there
    feat[2] = feat[4] = conic
    feat[5:8] = 0.5
    feat[8] = opacity
    feat[9] = -2.0
    return feat


def test_deep_stack_front_gradient_survives():
    """A pixel behind 16 clipped near-opaque splats has T_final ~ 1e-48,
    below the f32 range of T; the backward recovers T from log T and the
    front splat keeps its O(1) color gradient."""
    cfg = TileConfig(16, 16)
    feat = _t(_one_tile_feats(16, 0.02, 1.0)).requires_grad_()
    starts = torch.zeros((1,), dtype=torch.int32)
    ends = torch.full((1,), 16, dtype=torch.int32)
    out, _ = tv.rasterize_tiles(feat, starts, ends, cfg, 0.999, 0.0)
    assert float(out.detach()[0, 3, 8 * 16 + 8]) < 1e-38
    out[:, :3, :].sum().backward()
    assert torch.isfinite(feat.grad).all()
    assert abs(float(feat.grad[5, 0])) > 100.0


def test_alpha_clip_rounding_to_one_stays_finite():
    """A clip whose f32 rounding is 1.0 does not bound alpha: the alpha == 1
    guards (log1p floor, 1e-6 floor on 1 - alpha) must stay on."""
    assert not tr.clip_bounds_alpha(1.0 - 1e-8)
    assert tr.clip_bounds_alpha(1.0 - 2e-7)
    cfg = TileConfig(16, 16)
    starts = torch.zeros((1,), dtype=torch.int32)
    ends = torch.full((1,), 4, dtype=torch.int32)
    for clip in (1.0 - 1e-8, 1.0 - 2e-7):
        feat = _t(_one_tile_feats(4, 1.0, 1.0)).requires_grad_()
        out, _ = tv.rasterize_tiles(feat, starts, ends, cfg, clip, 0.0)
        out[:, :4, :].sum().backward()
        assert torch.isfinite(out).all() and torch.isfinite(feat.grad).all()
        assert float(out.detach()[0, 3, 8 * 16 + 8]) <= 1e-6


def test_saturated_alpha_one_gradients_finite():
    """Opacity exactly 1 with no clip: fragments saturate to alpha == 1
    and the gradient stays finite (zero behind the saturation)."""
    rng = np.random.default_rng(4)
    leaves = dict(
        means=rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32),
        log_scales=np.full((40, 3), np.log(0.08), np.float32),
        quats=rng.normal(size=(40, 4)).astype(np.float32),
        logit_opacities=np.zeros(40, np.float32),
        colors=rng.normal(size=(40, 3)).astype(np.float32))
    cam = st.make_camera((0, 0, 2.0), (0, 0, 0), width=48, height=48,
                         device="cpu")

    def opaque(p):
        s = p.to_scene()
        return st.GaussianScene(means=s.means, scales=s.scales,
                                quats=s.quats, colors=s.colors,
                                opacities=torch.ones_like(s.opacities))

    for g in _scalar_grads(opaque, leaves, cam, torch.sum, alpha_clip=None,
                           early_stop=0.0):
        assert g is None or torch.isfinite(g).all()


def test_tiny_capacity_gradients_finite():
    """Capacity overflow cuts runs mid-gaussian; the segment sum's
    truncation-aware run ends keep the gradient finite."""
    scene = synthetic_scene(100, seed=6, extent=0.5, scale_range=(0.03, 0.08))
    leaves = {k: np.asarray(getattr(JTrainable.from_scene(scene), k))
              for k in LEAVES}
    cam = st.make_camera((0, 0, 2.0), (0, 0, 0), width=48, height=32,
                         device="cpu")
    params = st.trainable_from_numpy(leaves, device="cpu")
    _, ov = st.render(params.to_scene(), cam, capacity=128,
                      return_overflow=True)
    assert int(ov) > 0
    grads = _scalar_grads(lambda p: p.to_scene(), leaves, cam,
                          lambda img: (img ** 2).sum(), capacity=128)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().max()) > 0


def test_degenerate_isotropic_splat_gradients_finite():
    """An isotropic splat seen head-on has a 2D covariance with a == c and
    b == 0, so r2 == 0 in the projection's eigen-decomposition; its sqrt
    must not feed 0/0 into the backward."""
    leaves = dict(
        means=np.array([[0.0, 0.0, 0.0], [0.2, 0.1, 0.1]], np.float32),
        log_scales=np.log(np.array([[0.1, 0.1, 0.1], [0.05, 0.08, 0.1]],
                                   np.float32)),
        quats=np.array([[1, 0, 0, 0], [0.9, 0.1, 0.3, 0.2]], np.float32),
        logit_opacities=np.array([1.0, 0.5], np.float32),
        colors=np.array([[0.5, -0.5, 1.0], [0.0, 0.3, -0.2]], np.float32))
    cam = st.make_camera((0, 0, 2.0), (0, 0, 0), width=32, height=32,
                         device="cpu")
    from splatjax_torch.ops.projection import project_gaussians
    from splatjax_torch.scene import build_covariances
    s = st.trainable_from_numpy(leaves, device="cpu").to_scene()
    proj = project_gaussians(s.means, build_covariances(s.quats, s.scales),
                             s.colors, s.opacities, cam.modelview,
                             cam.projection, 32, 32)
    a, b, c = proj.conic[0].detach()
    assert float(b) == 0.0 and float(a) == float(c)   # r2 == 0
    grads = _scalar_grads(lambda p: p.to_scene(), leaves, cam,
                          lambda img: (img ** 2).sum(), early_stop=0.0)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0][0].abs().sum()) > 0


def test_packed16_training_rows_quality_and_grads():
    """16-byte rows: >= 40 dB against the 32-byte render, gradients at
    cosine > 0.999 against the 32-byte gradients, expected depth within 5%
    of the 32-byte depth; viewer_exact refuses 16-byte rows."""
    scene = synthetic_scene(300, seed=33, extent=0.6,
                            scale_range=(0.02, 0.08))
    leaves = {k: np.asarray(getattr(JTrainable.from_scene(scene), k))
              for k in LEAVES}
    cam = st.make_camera((0, 0, 2.2), (0, 0, 0), width=80, height=64,
                         device="cpu")
    s = st.trainable_from_numpy(leaves, device="cpu").to_scene()
    with torch.no_grad():
        i32, d32 = st.render(s, cam, feature_bytes=32, alpha_clip=0.999,
                             return_depth=True)
        i16, d16 = st.render(s, cam, feature_bytes=16, alpha_clip=0.999,
                             return_depth=True)
    mse = float(((i16 - i32) ** 2).mean())
    assert 10.0 * np.log10(1.0 / max(mse, 1e-12)) >= 40.0
    covered = d32.abs() > 1e-3
    assert float((d16 - d32).abs()[covered].max()) \
        < 0.05 * float(d32.abs()[covered].max())
    g = {fb: _scalar_grads(lambda p: p.to_scene(), leaves, cam,
                           lambda img: (img ** 2).mean(), feature_bytes=fb,
                           alpha_clip=0.999) for fb in (16, 32)}
    for name, a, b in zip(LEAVES, g[16], g[32]):
        a, b = a.ravel(), b.ravel()
        assert torch.isfinite(a).all(), name
        cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
        assert cos > 0.999, (name, cos)
    with pytest.raises(ValueError, match="feature_bytes=16"):
        st.render(s, cam, feature_bytes=16, viewer_exact=True)


def test_bwd_wrapper_rejects_bad_inputs(binned):
    cfg = TileConfig(W, H)
    rows = _rows(binned, False)
    starts, ends = _t(binned["starts"]), _t(binned["ends"])
    out = tr.rasterize_fwd(rows, starts, ends, cfg)
    g = torch.zeros((cfg.num_tiles, 4, 256))
    with pytest.raises(ValueError, match="out_saved"):
        tv.rasterize_bwd(rows, starts, ends, out[:, :4].contiguous(), g, cfg)
    with pytest.raises(ValueError, match="g_out"):
        tv.rasterize_bwd(rows, starts, ends, out,
                         torch.zeros((cfg.num_tiles, 3, 256)), cfg)
    with pytest.raises(ValueError, match="g_out"):
        tv.rasterize_bwd(rows, starts, ends, out, g.double(), cfg)
    assert os.environ.get("SPLATJAX_GRAD_GATHER", "i16") == "i16"
