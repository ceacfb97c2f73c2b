"""Port parity, scene + camera + projection: splatjax_torch against
splatjax on the same numpy inputs (CPU; the port runs with device="cpu").

Tolerances: covariances, camera matrices and every projected float field
are held to f32 rounding (rtol 1e-5, atol 1e-6: the same elementwise f32
formulas, summed in possibly different order); the cull mask and the int16
quantization must be equal.

``project_params`` (the renderer's projection entry, whose plain version
runs here) is held to the plain composition it replaced: its forward equal
to ``project_gaussians`` on ``build_covariances``, its hand-written
backward to torch autograd through that composition, within three times
what autograd itself moves when the covariances are rounded once more
(f32 rounding, amplified where a gaussian's 2D eigenvalues nearly meet;
counted up to 1e-4 of the leaf's largest gradient, since a clamp can
take the other branch), plus 2e-6 of the leaf's largest gradient.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import splatjax.camera as jcam
import splatjax.ops.projection as jproj
import splatjax.scene as jscene
from splatjax.io import synthetic_scene

import splatjax_torch.camera as tcam
import splatjax_torch.ops.projection as tproj
import splatjax_torch.scene as tscene

W, H = 80, 64
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(n=300, seed=21):
    s = synthetic_scene(n, seed=seed, extent=0.6, scale_range=(0.02, 0.08))
    return {k: np.asarray(getattr(s, k)) for k in
            ("means", "scales", "quats", "colors", "opacities")}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_covariances_match():
    p = _params(seed=3)
    rng = np.random.default_rng(3)
    # un-normalized quaternions too, as .splat u8 round trips produce
    quats = p["quats"] * rng.uniform(0.9, 1.1, (300, 1)).astype(np.float32)
    cov_j = np.asarray(jscene.build_covariances(quats, p["scales"]))
    cov_t = tscene.build_covariances(_t(quats), _t(p["scales"])).numpy()
    np.testing.assert_allclose(cov_t, cov_j, rtol=RTOL, atol=1e-9)
    np.testing.assert_array_equal(
        tscene.quat_to_rotmat(_t(quats)).numpy(),
        np.asarray(jscene.quat_to_rotmat(quats)),
    )
    up_j = np.asarray(jscene.covariance_upper(cov_j))
    up_t = tscene.covariance_upper(_t(cov_j)).numpy()
    np.testing.assert_array_equal(up_t, up_j)
    np.testing.assert_array_equal(
        tscene.cov6_to_mat(_t(up_j)).numpy(),
        np.asarray(jscene.cov6_to_mat(up_j)),
    )


def test_int16_roundtrip_matches():
    p = _params(seed=4)
    cov6 = np.asarray(jscene.covariance_upper(
        jscene.build_covariances(p["quats"], p["scales"])))
    q_j, s_j = jscene.quantize_covariances_int16(jnp.asarray(cov6))
    q_t, s_t = tscene.quantize_covariances_int16(_t(cov6))
    assert q_t.dtype == torch.int16
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        tscene.dequantize_covariances_int16(q_t, s_t).numpy(),
        np.asarray(jscene.dequantize_covariances_int16(q_j, s_j)),
    )


def test_camera_matches():
    cj = jcam.make_camera((0.3, -0.2, 2.5), (0, 0.1, 0), width=W, height=H,
                          fov_y_deg=50.0)
    ct = tcam.make_camera((0.3, -0.2, 2.5), (0, 0.1, 0), width=W, height=H,
                          fov_y_deg=50.0, device="cpu")
    assert ct.modelview.dtype == torch.float32
    np.testing.assert_array_equal(ct.modelview.numpy(),
                                  np.asarray(cj.modelview))
    np.testing.assert_array_equal(ct.projection.numpy(),
                                  np.asarray(cj.projection))
    assert float(ct.focal) == float(cj.focal)
    assert (ct.width, ct.height) == (W, H)


def test_scene_from_numpy_and_device_rule():
    p = _params(n=8)
    s = tscene.scene_from_numpy(p, device="cpu")
    assert s.num_gaussians == 8 and s.sh is None
    assert all(getattr(s, k).dtype == torch.float32 for k in p)
    np.testing.assert_array_equal(s.means.numpy(), p["means"])
    if not torch.cuda.is_available():
        # the default device is the card: no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tscene.scene_from_numpy(p)
        with pytest.raises(RuntimeError, match="CUDA"):
            tcam.make_camera((0, 0, 2), (0, 0, 0), width=8, height=8)


def _cutout():
    box = np.eye(4, dtype=np.float32)
    box[:3, 3] = [0.2, 0.0, 0.1]
    box[0, 0] = 0.9
    return np.linalg.inv(box).astype(np.float32)


# name -> (sh bands K or 0, cutout, support_eps, viewer_exact cov, eye)
PROJ_CASES = {
    "plain": (0, False, None, False, (0, 0, 2.2)),
    "sh_band1": (3, False, None, False, (0.4, 0.3, 2.0)),
    "sh_band2": (8, False, None, False, (0.4, 0.3, 2.0)),
    "sh_band3": (15, False, None, False, (-0.3, 0.2, 2.1)),
    "cutout": (0, True, None, False, (0, 0, 2.2)),
    "support_eps": (0, False, 1e-4, False, (0, 0, 2.2)),
    "viewer_exact": (0, False, None, True, (0.1, -0.2, 1.6)),
}


@pytest.mark.parametrize("case", sorted(PROJ_CASES))
def test_projection_fields_match(case):
    k_sh, use_cut, eps, exact, eye = PROJ_CASES[case]
    p = _params(seed=11)
    rng = np.random.default_rng(12)
    sh = (rng.normal(size=(300, k_sh, 3)).astype(np.float32) * 0.2
          if k_sh else None)
    cov = np.asarray(jscene.build_covariances(p["quats"], p["scales"]))
    if exact:
        q, s = jscene.quantize_covariances_int16(
            jscene.covariance_upper(jnp.asarray(cov)))
        cov = np.asarray(jscene.cov6_to_mat(
            jscene.dequantize_covariances_int16(q, s)))
    cut = _cutout() if use_cut else None
    cj = jcam.make_camera(eye, (0, 0, 0), width=W, height=H)
    max_scales = p["scales"].max(axis=-1)
    pj = jproj.project_gaussians(
        p["means"], cov, p["colors"], p["opacities"], cj.modelview,
        cj.projection, W, H, max_scales=max_scales,
        cutout=None if cut is None else jnp.asarray(cut),
        sh=None if sh is None else jnp.asarray(sh), support_eps=eps,
    )
    pt = tproj.project_gaussians(
        _t(p["means"]), _t(cov), _t(p["colors"]), _t(p["opacities"]),
        _t(np.asarray(cj.modelview)), _t(np.asarray(cj.projection)), W, H,
        max_scales=_t(max_scales),
        cutout=None if cut is None else _t(cut),
        sh=None if sh is None else _t(sh), support_eps=eps,
    )
    mask_j = np.asarray(pj.mask)
    mask_t = pt.mask.numpy()
    flipped = np.nonzero(mask_j != mask_t)[0]
    assert flipped.size == 0, f"cull mask differs at gaussians {flipped}"
    assert mask_t.any()
    for field in ("mean2d", "conic", "depth", "bbox_half", "color",
                  "opacity"):
        np.testing.assert_allclose(
            getattr(pt, field).numpy(), np.asarray(getattr(pj, field)),
            rtol=RTOL, atol=ATOL, err_msg=f"{case}: {field}",
        )


def test_camera_from_three_matches_splatjax():
    """THREE-style matrices with the viewer's Y flips: the same float64
    host math, then f32 (bit-equal)."""
    rng = np.random.default_rng(12)
    cam_world = np.linalg.inv(jcam.look_at((0.4, -0.3, 2.2), (0, 0, 0)))
    proj = jcam.perspective(55.0, W / H, 0.2, 50.0)
    obj = np.eye(4, dtype=np.float32)
    obj[:3, 3] = rng.normal(size=3)
    for ow in (None, obj):
        j = jcam.Camera.from_three(cam_world, proj, ow, width=W, height=H)
        t = tcam.Camera.from_three(cam_world, proj, ow, width=W, height=H,
                                   device="cpu")
        assert (t.width, t.height) == (W, H)
        np.testing.assert_array_equal(t.modelview.numpy(),
                                      np.asarray(j.modelview))
        np.testing.assert_array_equal(t.projection.numpy(),
                                      np.asarray(j.projection))
        assert float(t.focal) == pytest.approx(float(j.focal), rel=1e-7)


def test_scene_normalized_matches_splatjax():
    p = _params(64, seed=3)
    p["quats"] = p["quats"] * np.random.default_rng(4).uniform(
        0.5, 2.0, (64, 1)).astype(np.float32)
    j = jscene.GaussianScene(**{k: jnp.asarray(v) for k, v in p.items()})
    t = tscene.scene_from_numpy(p, "cpu")
    tn, jn = t.normalized(), j.normalized()
    np.testing.assert_allclose(tn.quats.numpy(), np.asarray(jn.quats),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(tn.quats.numpy(), axis=-1),
                               1.0, rtol=1e-6)
    assert tn.means is t.means and t.quats is not tn.quats


# -- project_params: the plain version of the projection kernel pair -------

LEAVES = ("means", "quats", "scales", "colors", "sh")
GRAD_FIELDS = ("mean2d", "conic", "depth", "color")


def _composition(lv, opacities, cam, cut, eps, exact, cov_dtype=None):
    """The composition the renderer projected with before project_params,
    differentiable through every leaf of ``lv``; ``cov_dtype`` builds the
    covariances in that precision, then rounds them to f32."""
    quats, scales = lv["quats"], lv["scales"]
    if cov_dtype is not None:
        quats, scales = quats.to(cov_dtype), scales.to(cov_dtype)
    cov = tscene.build_covariances(quats, scales).to(torch.float32)
    if exact:
        cov = tscene.cov6_to_mat(tscene.dequantize_covariances_int16(
            *tscene.quantize_covariances_int16(
                tscene.covariance_upper(cov))))
    return tproj.project_gaussians(
        lv["means"], cov, lv["colors"], opacities, cam.modelview,
        cam.projection, cam.width, cam.height,
        max_scales=lv["scales"].amax(dim=-1), cutout=cut, sh=lv["sh"],
        support_eps=eps)


def _proj_case(case):
    """(leaves, opacities, camera, cutout, support_eps, viewer_exact) of a
    PROJ_CASES entry: the 300 gaussians of test_projection_fields_match."""
    k_sh, use_cut, eps, exact, eye = PROJ_CASES[case]
    p = _params(seed=11)
    rng = np.random.default_rng(12)
    sh = (rng.normal(size=(300, k_sh, 3)).astype(np.float32) * 0.2
          if k_sh else None)
    lv = {k: _t(p[k]) for k in ("means", "quats", "scales", "colors")}
    lv["sh"] = None if sh is None else _t(sh)
    cam = tcam.make_camera(eye, (0, 0, 0), width=W, height=H, device="cpu")
    return (lv, _t(p["opacities"]), cam, _t(_cutout()) if use_cut else None,
            eps, exact)


# The edge cases' special gaussian: (mean, quat, scales, color, sh band 1
# or None), seen from (0, 0, 2.2) beside 16 plain gaussians; and the
# check, on the composition's projection of it, that its guard is taken.
def _conic_eigs(c):
    return torch.linalg.eigvalsh(torch.stack(
        [torch.stack([c[0], c[1]]), torch.stack([c[1], c[2]])]))


EDGE_CASES = {
    # the 2D covariance is isotropic at the image center: r2 == 0
    "isotropic": (((0.0, 0.0, 0.0), (1, 0, 0, 0), (0.05, 0.05, 0.05),
                   (0.6, 0.4, 0.2), None),
                  lambda p: p.conic[1] == 0 and p.conic[0] == p.conic[2]),
    # 1 cm before the eye, 1 unit long: the +0.3 dilation is lost to f32
    # beside lambda1 ~ 3e7 px^2, so lambda2 clamps at 0.1 (the major axis
    # clamps too: f32 cannot lose 0.2 below lambda ~ 1.7e6)
    "lambda2_clamp": (((0.0, 0.0, 2.19), (0.9, 0.1, 0.3, 0.2),
                       (1.0, 1e-4, 1e-4), (0.6, 0.4, 0.2), None),
                      lambda p: abs(float(_conic_eigs(p.conic)[1]) - 10.0)
                      < 1e-3),
    # both axes past 1024 px
    "axis_clamp": (((0.0, 0.0, 2.19), (0.9, 0.1, 0.3, 0.2),
                    (0.5, 0.3, 0.4), (0.6, 0.4, 0.2), None),
                   lambda p: torch.allclose(_conic_eigs(p.conic),
                                            torch.tensor(1.0 / 524288.0),
                                            rtol=1e-5)),
    # the mean on the eye's plane, on the axis: z and w clamp to 1e-8 (off
    # the axis the 2D covariance overflows f32 there, to NaN in both)
    "z_at_eye": (((0.0, 0.0, 2.2), (0.9, 0.1, 0.3, 0.2), (0.05, 0.03, 0.04),
                  (0.6, 0.4, 0.2), None),
                 lambda p: abs(float(p.depth)) < 1e-8),
    # a black splat whose band-1 SH darkens it below 0 toward the eye
    "sh_clamp": (((0.3, 0.2, 0.0), (0.9, 0.1, 0.3, 0.2), (0.05, 0.03, 0.04),
                  (0.0, 0.0, 0.0), ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                    (0.0, 0.0, 0.0))),
                 lambda p: bool((p.color == 0).all())),
    # behind the eye: culled, gradients still taken
    "culled": (((0.1, 0.1, 3.0), (0.9, 0.1, 0.3, 0.2), (0.05, 0.03, 0.04),
                (0.6, 0.4, 0.2), None),
               lambda p: not bool(p.mask)),
}


def _edge_case(case):
    (mean, quat, scale, color, sh1), _ = EDGE_CASES[case]
    p = _params(n=16, seed=5)
    lv = {k: _t(p[k]) for k in ("means", "quats", "scales", "colors")}
    lv["means"] = torch.cat([lv["means"], torch.tensor([mean])])
    q = torch.tensor([quat], dtype=torch.float32)
    lv["quats"] = torch.cat([lv["quats"], q / q.norm(dim=-1, keepdim=True)])
    lv["scales"] = torch.cat([lv["scales"], torch.tensor([scale])])
    lv["colors"] = torch.cat([lv["colors"], torch.tensor([color])])
    lv["sh"] = None
    if sh1 is not None:
        sh = np.random.default_rng(6).normal(size=(17, 3, 3)) * 0.1
        sh[-1] = sh1
        lv["sh"] = _t(sh.astype(np.float32))
    opac = torch.cat([_t(p["opacities"]), torch.tensor([0.8])])
    cam = tcam.make_camera((0, 0, 2.2), (0, 0, 0), width=W, height=H,
                           device="cpu")
    return lv, opac, cam, None, None, False


def _grads(proj, cot, leaves):
    loss = sum((getattr(proj, f) * cot[f]).sum() for f in GRAD_FIELDS)
    return dict(zip(leaves, torch.autograd.grad(
        loss, [leaves[k] for k in leaves])))


@pytest.mark.parametrize("case", sorted(PROJ_CASES) + sorted(EDGE_CASES))
def test_project_params_matches_composition(case):
    lv, opac, cam, cut, eps, exact = (
        _edge_case(case) if case in EDGE_CASES else _proj_case(case))
    leaves = {k: v.clone().requires_grad_() for k, v in lv.items()
              if v is not None}
    full = dict(lv, **leaves)
    comp = _composition(full, opac, cam, cut, eps, exact)
    new = tproj.project_params(
        full["means"], full["colors"], opac, cam.modelview, cam.projection,
        W, H, quats=full["quats"], scales=full["scales"], cutout=cut,
        sh=full["sh"], support_eps=eps, viewer_exact=exact)
    for field in ("mean2d", "conic", "depth", "mask", "bbox_half", "color",
                  "opacity"):
        assert torch.equal(getattr(new, field), getattr(comp, field)), field
    if case in EDGE_CASES:
        one = tproj.ProjectedGaussians(**{
            f: getattr(comp, f)[-1].detach() for f in (
                "mean2d", "conic", "depth", "mask", "bbox_half", "color",
                "opacity")})
        assert EDGE_CASES[case][1](one), f"{case}: the guard is not taken"
    gen = torch.Generator().manual_seed(7)
    cot = {f: torch.randn(getattr(comp, f).shape, generator=gen)
           for f in GRAD_FIELDS}
    want = _grads(comp, cot, leaves)
    got = _grads(new, cot, leaves)
    again = _grads(_composition(full, opac, cam, cut, eps, exact,
                                torch.float64), cot, leaves)
    for k in leaves:
        assert torch.isfinite(got[k]).all(), f"{case}: {k} not finite"
        scale = float(want[k].abs().max())
        spread = min(float((again[k] - want[k]).abs().max()),
                     1e-4 * scale)
        err = float((got[k] - want[k]).abs().max())
        assert err <= 3.0 * spread + 2e-6 * scale, (
            f"{case}: d{k} differs by {err:.3g} from autograd's (its own "
            f"spread {spread:.3g}, largest {scale:.3g})")


def test_project_params_cov6_form():
    """The cached form reads covariance triangles as given: equal to
    project_gaussians on them; it takes no gradient, and refuses one."""
    p = _params(seed=13)
    cov = tscene.build_covariances(_t(p["quats"]), _t(p["scales"]))
    cov6 = tscene.covariance_upper(cov)
    cam = tcam.make_camera((0.2, 0.1, 2.0), (0, 0, 0), width=W, height=H,
                           device="cpu")
    rng = np.random.default_rng(14)
    sh = _t(rng.normal(size=(300, 8, 3)).astype(np.float32) * 0.2)
    args = (_t(p["means"]), _t(p["colors"]), _t(p["opacities"]),
            cam.modelview, cam.projection, W, H)
    max_scales = _t(p["scales"]).amax(-1)
    want = tproj.project_gaussians(
        args[0], tscene.cov6_to_mat(cov6), *args[1:], max_scales=max_scales,
        cutout=_t(_cutout()), sh=sh)
    got = tproj.project_params(*args, cov6=cov6, max_scales=max_scales,
                               cutout=_t(_cutout()), sh=sh)
    for field in ("mean2d", "conic", "depth", "mask", "bbox_half", "color",
                  "opacity"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    with pytest.raises(ValueError, match="not differentiable"):
        tproj.project_params(*args, cov6=cov6.requires_grad_(),
                             max_scales=max_scales)
    with pytest.raises(ValueError, match="max_scales"):
        tproj.project_params(*args, cov6=cov6.detach())
    with pytest.raises(ValueError, match="quats and scales, or cov6"):
        tproj.project_params(*args, cov6=cov6.detach(),
                             quats=_t(p["quats"]), max_scales=max_scales)
