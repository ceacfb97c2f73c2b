"""Port parity, fixture tool: splatjax_torch.tools.make_fixture's analytic
target is splatjax's bit for bit at the same pose, a tiny run writes .ply
and .splat files that both packages load to equal arrays, and the default
output lies under the build directory (never the committed
tests/fixtures)."""
import math
import os

import numpy as np
import pytest
import torch

import splatjax.camera as jcam
import splatjax.io as jio
from splatjax.io.ply_format import load_ply as j_load_ply
from splatjax.tools import make_fixture as jmf

import splatjax_torch.camera as tcam
import splatjax_torch.io as tio
from splatjax_torch.tools import make_fixture as tmf

FIELDS = ("means", "scales", "quats", "colors", "opacities")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("view", [0, 4, 7])
def test_analytic_target_bit_equal(view):
    ang = 2 * math.pi * view / 10
    el = 0.25 + 0.25 * (view % 3)
    pos = (1.9 * math.cos(ang) * math.cos(el), 1.9 * math.sin(el),
           1.9 * math.sin(ang) * math.cos(el))
    jc = jcam.make_camera(pos, (0, 0, 0), width=40, height=32)
    tc = tcam.make_camera(pos, (0, 0, 0), width=40, height=32, device="cpu")
    img_t = tmf.analytic_target(tc, 40, 32)
    img_j = jmf.analytic_target(jc, 40, 32)
    assert img_t.dtype == np.float32
    np.testing.assert_array_equal(img_t, img_j)
    assert 0.05 < img_t[..., 3].mean() < 0.95


@pytest.fixture(scope="module")
def tiny_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixture")
    res = tmf.main(["--steps", "30", "--res", "32", "--views", "3",
                    "--out", str(out), "--device", "cpu"])
    return out, res


def test_tiny_run_writes_files_both_packages_load(tiny_fixture):
    out, res = tiny_fixture
    assert res["ply"] == os.path.join(str(out), "trained_scene.ply")
    assert res["splat"] == os.path.join(str(out), "trained_scene.splat")
    assert np.isfinite(res["psnr"]) and res["psnr"] > 10.0
    losses = [h["loss"] for h in res["history"]]
    assert losses[-1] < losses[0]
    t_ply = tio.load_ply(res["ply"], device="cpu")
    t_splat = tio.load_splat(res["splat"], device="cpu")
    assert t_ply.num_gaussians == t_splat.num_gaussians == res["rows"] > 0
    # frozen: every kept row is alive
    assert float(t_ply.opacities.min()) > 0.01 - 1e-6
    j_ply = j_load_ply(res["ply"], backend="numpy")   # the semantics of record
    j_splat = jio.load_splat(res["splat"])
    for t_scene, j_scene in ((t_ply, j_ply), (t_splat, j_splat)):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(t_scene, f).numpy(), np.asarray(getattr(j_scene, f)),
                err_msg=f)


def test_default_out_is_under_build():
    out = os.path.abspath(tmf.DEFAULT_OUT)
    assert out.startswith(os.path.join(ROOT, "build") + os.sep)
    assert not out.startswith(os.path.join(ROOT, "tests"))
