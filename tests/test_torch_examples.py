"""The port's examples (splatjax_torch.examples.*) on the CPU at tiny
sizes: every PNG an example writes is the port's encode_png of the frame
its main() returns; demo_render's and demo_cutout's frames are within 1e-3
of splatjax's SplatRenderer at the same camera; demo_depth_interaction's
sphere layer is splatjax's bit for bit; demo_train's loss falls; and
fit_trained_fixture writes its record and PNGs, by default under the build
directory (splatjax's committed examples/artifacts stay untouched)."""
import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from splatjax.camera import Camera as JCamera
from splatjax.viewer import SplatRenderer as JSplatRenderer

from splatjax_torch.io import load_splat, save_splat, synthetic_scene
from splatjax_torch.utils import encode_png
from splatjax_torch.examples import (
    demo_cutout,
    demo_depth_interaction,
    demo_orbit,
    demo_render,
    demo_stereo,
    demo_train,
    fit_trained_fixture,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def splat_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "scene.splat"
    save_splat(path, synthetic_scene(600, seed=4, extent=0.6,
                                     scale_range=(0.02, 0.06), device="cpu"))
    return str(path)


def _png_is_frame(path, frame):
    with open(path, "rb") as f:
        assert f.read() == encode_png(frame)


def _j_camera(cam):
    return JCamera(modelview=jnp.asarray(cam.modelview.numpy()),
                   projection=jnp.asarray(cam.projection.numpy()),
                   width=cam.width, height=cam.height)


def test_demo_render(splat_file, tmp_path):
    out = demo_render.main([splat_file, "--frames", "2", "--width", "64",
                            "--height", "48", "--out", str(tmp_path),
                            "--device", "cpu"])
    assert out["gaussians"] == 600 and len(out["frames"]) == 2
    ref = JSplatRenderer(src=splat_file)
    for frame, path, cam in zip(out["frames"], out["paths"], out["cameras"]):
        assert frame.shape == (48, 64, 4) and frame.dtype == np.float32
        assert frame[..., 3].max() > 0.5
        _png_is_frame(path, frame)
        want = np.asarray(ref.render(_j_camera(cam)))
        assert np.abs(frame - want).max() < PARITY


def test_demo_cutout(splat_file, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = demo_cutout.main([splat_file, "--device", "cpu"])
    assert out["path"] == str(tmp_path / "splatjax_cutout_demo.png")
    _png_is_frame(out["path"], out["side"])
    np.testing.assert_array_equal(
        out["side"], np.concatenate([out["full"], out["clipped"]], axis=1))
    assert 0.0 < out["kept"] < 1.0
    assert np.abs(out["full"] - out["clipped"]).max() > PARITY
    cam = _j_camera(out["camera"])
    box_world = np.diag([0.8, 0.8, 0.8, 1.0]).astype(np.float32)
    box_world[:3, 3] = [0.3, 0.0, 0.0]
    cutout = jnp.asarray(np.linalg.inv(box_world))
    for got, kw in ((out["full"], {}), (out["clipped"], {"cutout": cutout})):
        want = np.asarray(JSplatRenderer(src=splat_file, **kw).render(cam))
        assert np.abs(got - want).max() < PARITY


def test_demo_orbit(splat_file, tmp_path):
    path = str(tmp_path / "orbit.png")
    out = demo_orbit.main([splat_file, "--frames", "6", "--res", "64x48",
                           "--resort-interval", "3", "--out", path,
                           "--device", "cpu"])
    assert out["path"] == path and len(out["frames"]) == 6
    _png_is_frame(path, out["strip"])
    np.testing.assert_array_equal(out["strip"],
                                  np.concatenate(out["frames"], axis=1))
    assert len(out["frame_ms"]) == 6 and out["fps"] > 0
    assert all(np.isfinite(f).all() for f in out["frames"])


def test_demo_stereo(splat_file, tmp_path):
    path = str(tmp_path / "stereo.png")
    out = demo_stereo.main([splat_file, "--out", path, "--device", "cpu"])
    assert out["left"].shape == out["right"].shape == (240, 320, 4)
    _png_is_frame(path, out["pair"])
    np.testing.assert_array_equal(
        out["pair"], np.concatenate([out["left"], out["right"]], axis=1))
    # the eyes are 0.06 apart: the images differ, but not by much
    diff = np.abs(out["left"] - out["right"])
    assert 0.0 < diff.mean() < 0.05


def _splatjax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"splatjax_example_{name}", os.path.join(ROOT, "examples",
                                                 f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_depth_interaction(tmp_path):
    out = demo_depth_interaction.main(
        ["--frames", "2", "--width", "64", "--height", "48",
         "--out", str(tmp_path), "--device", "cpu"])
    assert len(out["frames"]) == 2
    for frame, path in zip(out["frames"], out["paths"]):
        assert frame.shape == (48, 64, 4)
        _png_is_frame(path, frame)
    # the sphere layer is splatjax's, bit for bit
    import splatjax.camera as jcam
    from splatjax_torch import make_camera

    j_demo = _splatjax_example("demo_depth_interaction")
    eye, center = (0, 0, 2.4), (0.45, 0.0, 0.0)
    got = demo_depth_interaction.sphere_layer(
        make_camera(eye, (0, 0, 0), width=64, height=48, device="cpu"),
        center, 0.25, 64, 48)
    want = j_demo.sphere_layer(
        jcam.make_camera(eye, (0, 0, 0), width=64, height=48),
        center, 0.25, 64, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].any()


def test_demo_train(tmp_path):
    path = str(tmp_path / "fit.splat")
    out = demo_train.main(["--steps", "30", "--n", "200", "--views", "3",
                           "--res", "48x32", "--out", path,
                           "--device", "cpu"])
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert losses[-1] < losses[0]
    assert np.isfinite(out["held_psnr"])
    assert out["held"].shape == out["held_target"].shape == (32, 48, 4)
    assert load_splat(path, device="cpu").num_gaussians == 200


def test_fit_trained_fixture(tmp_path):
    out = fit_trained_fixture.main(
        ["--steps", "12", "--views", "3", "--res", "32x32", "--init-n",
         "256", "--out-dir", str(tmp_path), "--device", "cpu"])
    with open(out["path"]) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and rec["steps"] == 12
    assert rec["value"] == round(min(out["held_psnrs"]), 2)
    assert 0 < rec["final_live_gaussians"] <= 256
    losses = [h["loss"] for h in rec["history"]]
    assert losses[-1] < losses[0]
    assert len(out["png_paths"]) == 2
    for (tp, rp), tgt, img in zip(out["png_paths"], out["held_targets"],
                                  out["held_images"]):
        _png_is_frame(tp, tgt[..., :3])
        _png_is_frame(rp, img[..., :3])


def test_fit_trained_fixture_defaults_stay_under_build():
    out_dir = os.path.abspath(fit_trained_fixture.DEFAULT_OUT_DIR)
    assert out_dir.startswith(os.path.join(ROOT, "build") + os.sep)
    assert os.path.samefile(
        fit_trained_fixture.FIXTURE,
        os.path.join(ROOT, "tests", "fixtures", "trained_scene.splat"))
