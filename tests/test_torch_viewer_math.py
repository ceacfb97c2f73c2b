"""Port parity against the scalar WebGL-viewer oracle.

1. splatjax_torch.reference.viewer_math is splatjax's transcription of the
   viewer (pushDataBuffer, vertex and fragment shaders, the worker's cull
   and counting sort): equal outputs on the same raw .splat rows.
2. The port's projection passes tests/test_projection.py's viewer cases at
   that file's tolerances: covariance, int16 quantization (+-1 lsb), vertex
   shader, frustum and size culls, depth metric and cutout.
3. The port's render_reference(viewer_exact=True) and the tiled
   render(viewer_exact=True, early_stop=0.0) on the CPU are within 1e-3
   (the north-star parity budget) of the scalar back-to-front viewer
   pipeline (viewer_math.viewer_render): 40 splats at 48x32, and a cutout
   case that the worker's cull must agree with.
"""
import numpy as np
import pytest
import torch

import splatjax.reference.viewer_math as jvm
from splatjax.camera import make_camera as j_make_camera
from splatjax.io import parse_splat_bytes as j_parse_splat_bytes
from splatjax.reference import render_reference as j_render_reference

from splatjax_torch import make_camera, render
from splatjax_torch.io import (
    parse_splat_bytes,
    scene_to_splat_bytes,
    synthetic_scene,
)
from splatjax_torch.ops import project_gaussians
from splatjax_torch.reference import render_reference
from splatjax_torch.reference import viewer_math as vm
from splatjax_torch.scene import (
    build_covariances,
    cov6_to_mat,
    covariance_upper,
    dequantize_covariances_int16,
    quantize_covariances_int16,
)

W, H = 64, 48
PARITY = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _raw_scene(n, seed, **kw):
    """(quantized scene, raw (n, 32) rows): the scene as the viewer sees
    it, parsed back from its own .splat bytes."""
    scene = synthetic_scene(n, seed=seed, device="cpu", **kw)
    raw = np.frombuffer(scene_to_splat_bytes(scene), np.uint8).reshape(n, 32)
    return parse_splat_bytes(raw.tobytes(), device="cpu"), raw


def _setup(n=64, seed=0):
    scene, raw = _raw_scene(n, seed, extent=0.8)
    cam = make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), width=W, height=H,
                      device="cpu")
    return scene, raw, cam


def _np(t):
    return t.detach().cpu().numpy()


def _mats(cam, height=H):
    mv = _np(cam.modelview).astype(np.float64)
    pr = _np(cam.projection).astype(np.float64)
    return mv, pr, (height / 2.0) * abs(pr[1, 1])


def _viewer_quantized_cov(scene):
    cov3d = build_covariances(scene.quats, scene.scales)
    q, qs = quantize_covariances_int16(covariance_upper(cov3d))
    return cov6_to_mat(dequantize_covariances_int16(q, qs)), q, qs


def _project(scene, cam, cov3d, **kw):
    return project_gaussians(
        scene.means, cov3d, scene.colors, scene.opacities,
        cam.modelview, cam.projection, W, H, **kw,
    )


def _box_cutout(scale, offset):
    box_world = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    box_world[:3, 3] = offset
    return np.linalg.inv(box_world).astype(np.float32)


# -- 1. the port's oracle is splatjax's -------------------------------------

def test_viewer_math_equals_splatjax():
    _, raw, cam = _setup(128, seed=6)
    mv, pr, focal = _mats(cam)
    t_buf, j_buf = vm.push_data_buffer_math(raw), jvm.push_data_buffer_math(raw)
    assert sorted(t_buf) == sorted(j_buf)
    for k in t_buf:
        np.testing.assert_array_equal(t_buf[k], j_buf[k], err_msg=k)
    rng = np.random.default_rng(2)
    for q in rng.normal(size=(8, 4)):
        np.testing.assert_array_equal(vm.three_quat_to_rotmat(*q),
                                      jvm.three_quat_to_rotmat(*q))
    shaded = 0
    for i in range(128):
        cov6 = t_buf["cov6_q"][i].astype(np.float64) * t_buf["quant_scale"][i]
        a = vm.vertex_shader_math(t_buf["centers"][i], cov6, mv, pr, (W, H),
                                  focal)
        b = jvm.vertex_shader_math(t_buf["centers"][i], cov6, mv, pr, (W, H),
                                   focal)
        assert (a is None) == (b is None), i
        if a is None:
            continue
        shaded += 1
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for px in ((3.5, 7.5), (31.5, 23.5), (50.5, 40.5)):
            assert vm.splat_alpha_at_pixel(
                a[0], a[1], a[2], px, (W, H), t_buf["opacities"][i]
            ) == jvm.splat_alpha_at_pixel(
                a[0], a[1], a[2], px, (W, H), t_buf["opacities"][i])
    assert shaded >= 20
    for u, v in rng.uniform(-2.5, 2.5, (16, 2)):
        assert vm.fragment_alpha(u, v, 0.7) == jvm.fragment_alpha(u, v, 0.7)
    for cutout in (None, _box_cutout(1.2, [0.2, -0.1, 0.3])):
        np.testing.assert_array_equal(
            vm.worker_sort_cull(t_buf["centers"], t_buf["sort_metric"], mv,
                                cutout=cutout),
            jvm.worker_sort_cull(j_buf["centers"], j_buf["sort_metric"], mv,
                                 cutout=cutout),
        )


# -- 2. the port's projection against the oracle ----------------------------

def test_covariance_matches_three_construction():
    """Sigma = R S^2 R^T under the loader mapping == the viewer's
    R_three^T S^2 R_three from raw bytes (index.js:361-367)."""
    scene, raw, _ = _setup(128, seed=4)
    cov3d = _np(build_covariances(scene.quats, scene.scales))
    for i in range(0, 128, 17):
        b = raw[i]
        qx = (float(b[29]) - 128) / 128
        qy = (float(b[30]) - 128) / 128
        qz = -(float(b[31]) - 128) / 128
        qw = (float(b[28]) - 128) / 128
        rot = vm.three_quat_to_rotmat(qx, qy, qz, qw)
        floats = b[:24].copy().view("<f4")
        m = rot.T @ np.diag(floats[3:6].astype(np.float64))
        np.testing.assert_allclose(cov3d[i], m @ m.T, atol=1e-5)


def test_int16_quantization_matches_viewer():
    scene, raw, _ = _setup(96, seed=5)
    _, q, qs = _viewer_quantized_cov(scene)
    viewer = vm.push_data_buffer_math(raw)
    np.testing.assert_allclose(
        _np(qs), viewer["quant_scale"].astype(np.float32), rtol=1e-5)
    # +-1 lsb from float32-vs-float64 rounding at the trunc boundary
    dq = np.abs(_np(q).astype(np.int32) - viewer["cov6_q"].astype(np.int32))
    assert dq.max() <= 1


def test_projection_matches_vertex_shader():
    scene, raw, cam = _setup(128, seed=6)
    cov3d, q, qs = _viewer_quantized_cov(scene)
    proj = _project(scene, cam, cov3d, max_scales=scene.scales.amax(-1))
    mv, pr, focal = _mats(cam)
    viewer = vm.push_data_buffer_math(raw)
    cov6_all = _np(dequantize_covariances_int16(q, qs)).astype(np.float64)
    mean2d, conic, bbox = (_np(proj.mean2d), _np(proj.conic),
                           _np(proj.bbox_half))
    n_checked = 0
    for i in range(128):
        cov6_i = viewer["cov6_q"][i].astype(np.float64) * viewer["quant_scale"][i]
        np.testing.assert_allclose(cov6_all[i], cov6_i, rtol=2e-4, atol=1e-9)
        out = vm.vertex_shader_math(viewer["centers"][i], cov6_all[i], mv, pr,
                                    (W, H), focal)
        if out is None:
            continue
        ndc_center, v1, v2, _ = out
        n_checked += 1
        cx = (ndc_center[0] + 1) * W / 2
        cy = (ndc_center[1] + 1) * H / 2
        np.testing.assert_allclose(mean2d[i], [cx, cy], rtol=1e-4, atol=1e-3)
        a, b, c = conic[i].astype(np.float64)
        m = np.array([[v2[0], v1[0]], [v2[1], v1[1]]])
        for d in ([1.5, 0.3], [-0.7, 0.9], [0.2, -1.1]):
            d = np.array(d)
            power = -0.5 * (a * d[0] ** 2 + 2 * b * d[0] * d[1]
                            + c * d[1] ** 2)
            uv = np.linalg.solve(m, d)
            np.testing.assert_allclose(power, -(uv[0] ** 2 + uv[1] ** 2),
                                       rtol=1e-3, atol=1e-5)
        # every quad point with alpha > 0 (power >= -4, index.js:172) lies
        # inside the bbox
        for su in np.linspace(-2, 2, 9):
            for sv in np.linspace(-2, 2, 9):
                if su * su + sv * sv <= 4.0:
                    d = su * v2 + sv * v1
                    assert abs(d[0]) <= bbox[i, 0] + 1e-3
                    assert abs(d[1]) <= bbox[i, 1] + 1e-3
    assert n_checked >= 20


@pytest.mark.parametrize("cutout", [None, (1.2, [0.2, -0.1, 0.3])],
                         ids=["culls", "cutout"])
def test_culls_match_worker_and_shader(cutout):
    """The projection's mask == the worker's keep (depth, size x opacity
    and, with a cutout, the box with its Y-negation) and the vertex
    shader's frustum test."""
    n, seed = (256, 7) if cutout is None else (200, 9)
    scene, raw, cam = _setup(n, seed=seed)
    cov3d, _, _ = _viewer_quantized_cov(scene)
    box = None if cutout is None else _box_cutout(*cutout)
    proj = _project(scene, cam, cov3d, max_scales=scene.scales.amax(-1),
                    cutout=None if box is None else torch.from_numpy(box))
    viewer = vm.push_data_buffer_math(raw)
    mv, pr, focal = _mats(cam)
    order = vm.worker_sort_cull(viewer["centers"], viewer["sort_metric"], mv,
                                cutout=box)
    keep = np.zeros(n, bool)
    keep[np.asarray(order, np.int64)] = True
    mask = _np(proj.mask)
    for i in range(n):
        cov6_i = viewer["cov6_q"][i].astype(np.float64) * viewer["quant_scale"][i]
        shader_keep = vm.vertex_shader_math(
            viewer["centers"][i], cov6_i, mv, pr, (W, H), focal) is not None
        assert bool(mask[i]) == (keep[i] and shader_keep), i
    if cutout is not None:
        assert 0 < keep.sum() < n


def test_depth_matches_worker_metric():
    scene, raw, cam = _setup(64, seed=8)
    cov3d, _, _ = _viewer_quantized_cov(scene)
    proj = _project(scene, cam, cov3d)
    mv, _, _ = _mats(cam)
    viewer = vm.push_data_buffer_math(raw)
    expected = viewer["centers"] @ mv[2, :3] + mv[2, 3]
    np.testing.assert_allclose(_np(proj.depth), expected, rtol=1e-5,
                               atol=1e-6)


# -- 3. whole renders against the scalar viewer pipeline --------------------

GW, GH = 48, 32
CASES = {
    # test_reference_rasterizer.py's scenes
    "plain": dict(n=40, seed=12, scale_range=(0.03, 0.12), cutout=None),
    "cutout": dict(n=60, seed=13, scale_range=(0.03, 0.1),
                   cutout=(1.0, [0.1, 0.0, 0.0])),
}


@pytest.fixture(scope="module")
def oracle():
    """Per case: the quantized scene, camera, cutout and the viewer
    pipeline's image; for the cutout case also the worker's kept count and
    the full image."""
    out = {}
    for name, c in CASES.items():
        scene, raw = _raw_scene(c["n"], c["seed"], extent=0.6,
                                scale_range=c["scale_range"])
        cam = make_camera((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), width=GW,
                          height=GH, device="cpu")
        box = None if c["cutout"] is None else _box_cutout(*c["cutout"])
        mv, pr, _ = _mats(cam, GH)
        rec = dict(scene=scene, raw=raw, cam=cam, cutout=box,
                   image=vm.viewer_render(raw, mv, pr, GW, GH, cutout=box))
        if box is not None:
            buf = vm.push_data_buffer_math(raw)
            rec["kept"] = len(vm.worker_sort_cull(
                buf["centers"], buf["sort_metric"], mv, cutout=box))
            rec["full"] = vm.viewer_render(raw, mv, pr, GW, GH)
        out[name] = rec
    return out


def test_oracle_scenes_are_nontrivial(oracle):
    assert oracle["plain"]["image"][..., 3].max() > 0.2
    cut = oracle["cutout"]
    assert cut["kept"] < CASES["cutout"]["n"]
    assert np.abs(cut["image"] - cut["full"]).max() > PARITY


def test_splatjax_reference_matches_port_oracle(oracle):
    """splatjax's own reference render agrees with the port's composed
    oracle (ties viewer_render to splatjax's test oracle)."""
    rec = oracle["plain"]
    j_scene = j_parse_splat_bytes(rec["raw"].tobytes())
    j_cam = j_make_camera((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), width=GW,
                          height=GH)
    img = np.asarray(j_render_reference(j_scene, j_cam, viewer_exact=True,
                                        pixel_chunk=256))
    assert np.abs(img - rec["image"]).max() < PARITY


@pytest.mark.parametrize("path", ["reference", "tiled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_viewer_pipeline(oracle, case, path):
    rec = oracle[case]
    cutout = None if rec["cutout"] is None else torch.from_numpy(
        rec["cutout"])
    if path == "reference":
        img = render_reference(rec["scene"], rec["cam"], viewer_exact=True,
                               cutout=cutout, pixel_chunk=256)
    else:
        img = render(rec["scene"], rec["cam"], viewer_exact=True,
                     early_stop=0.0, cutout=cutout)
    assert img.device.type == "cpu"
    assert np.abs(_np(img) - rec["image"]).max() < PARITY
