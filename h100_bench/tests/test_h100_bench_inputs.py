"""The inputs are fixed by the seed."""
import math

import pytest
import torch

import inputs
from conftest import BENCH, SEED, TINY


@pytest.mark.parametrize("spec", [
    {"kind": "cap", "count": 16, "radius": 2.8, "half_angle_deg": 30.0},
    {"kind": "orbit", "count": 16, "radius": 0.02, "center": [0, 0, 2.8]},
    {"kind": "arc", "count": 16, "radius": 2.8, "azimuth_deg": 45.0,
     "elevation_deg": 15.0},
])
def test_eyes_fixed_by_seed(spec):
    a, b = inputs.eyes(spec, SEED), inputs.eyes(spec, SEED)
    c = inputs.eyes(spec, SEED + 1)
    assert a == b and a != c and len(a) == spec["count"]
    if spec["kind"] == "cap":
        for e in a:
            assert math.isclose(math.dist(e, (0, 0, 0)), 2.8, rel_tol=1e-9)
            assert math.degrees(math.acos(e[2] / 2.8)) <= 30.0 + 1e-9
    if spec["kind"] == "orbit":
        for e in a:
            assert math.isclose(math.dist(e, (0, 0, 2.8)), 0.02,
                                rel_tol=1e-9)


def test_scene_fixed_by_seed():
    base = inputs.parse_splat(BENCH / "data" / "trained_scene.splat")
    assert base["means"].shape == (5700, 3)
    cfg = dict(TINY, tile_scale=0.25, tile_jitter=0.9, sh_degree=3,
               sh_std=0.1)
    a = inputs.tiled_scene(base, cfg, SEED, "cpu")
    b = inputs.tiled_scene(base, cfg, SEED, "cpu")
    c = inputs.tiled_scene(base, cfg, SEED + 1, "cpu")
    assert a["means"].shape == (TINY["splats"], 3)
    assert a["sh"].shape == (TINY["splats"], 15, 3)
    for k in ("means", "sh"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    raw = inputs.raw_leaves(a)
    n1 = inputs.noisy(raw, {"colors": 0.5}, SEED)
    n2 = inputs.noisy(raw, {"colors": 0.5}, SEED)
    assert torch.equal(n1["colors"], n2["colors"])
    assert torch.equal(n1["means"], raw["means"])


def test_capacity_margin_and_alignment():
    assert inputs.capacity([1000, 2000], 0.03) == 3072
    assert inputs.capacity([10], 0.03) == 1024
