"""Port parity, binning + expansion: splatjax_torch against splatjax
(CPU, Pallas in interpret mode; the port runs its plain versions).

Both packages bin THE SAME projected arrays (splatjax's projection, as
numpy), so projection ulps cannot make a false mismatch. Every output is
integer data and must be equal, including under capacity overflow.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera
from splatjax.io import synthetic_scene
from splatjax.ops import expand as jexpand
from splatjax.ops.binning import TileConfig as JTileConfig
from splatjax.ops.binning import _searchsorted_right_blocked
from splatjax.ops.binning import bin_gaussians as j_bin
from splatjax.ops.projection import ProjectedGaussians as JProj
from splatjax.ops.projection import project_gaussians
from splatjax.scene import build_covariances

from splatjax_torch.ops.binning import (
    TileConfig, bin_gaussians, depth_order, tile_order,
)
from splatjax_torch.ops.expand import expand_instances
from splatjax_torch.ops.projection import ProjectedGaussians as TProj

W, H = 80, 64
FIELDS = ("mean2d", "conic", "depth", "mask", "bbox_half", "color",
          "opacity")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def projected():
    """splatjax's projection of a 300-splat scene, as numpy arrays."""
    scene = synthetic_scene(300, seed=33, extent=0.6,
                            scale_range=(0.02, 0.08))
    cam = make_camera((0, 0, 2.2), (0, 0, 0), width=W, height=H)
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, W, H,
        max_scales=jnp.max(jnp.asarray(scene.scales), axis=-1),
        support_eps=1e-4,
    )
    return {f: np.asarray(getattr(proj, f)) for f in FIELDS}


def _both(arrays):
    jp = JProj(**{f: jnp.asarray(a) for f, a in arrays.items()})
    tp = TProj(**{f: torch.from_numpy(np.array(a))
                  for f, a in arrays.items()})
    return jp, tp


@pytest.mark.parametrize("capacity", [4096, 512, 384])
def test_bin_gaussians_matches(projected, capacity):
    jp, tp = _both(projected)
    bj = j_bin(jp, JTileConfig(W, H), capacity, with_features=False)
    bt = bin_gaussians(tp, TileConfig(W, H), capacity)
    total = int(bj.num_instances)
    assert (total > capacity) == (capacity < 4096)  # overflow cases
    for name in ("gauss_id", "tile_id", "starts", "ends", "num_instances",
                 "overflow", "cum", "count", "perm", "cum_d", "count_d"):
        want = np.asarray(getattr(bj, name)).astype(np.int64)
        got = getattr(bt, name).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_bin_gaussians_empty_scene():
    empty = {f: a[:0] for f, a in
             {"mean2d": np.zeros((1, 2), np.float32),
              "conic": np.zeros((1, 3), np.float32),
              "depth": np.zeros((1,), np.float32),
              "mask": np.zeros((1,), bool),
              "bbox_half": np.zeros((1, 2), np.float32),
              "color": np.zeros((1, 3), np.float32),
              "opacity": np.zeros((1,), np.float32)}.items()}
    jp, tp = _both(empty)
    bj = j_bin(jp, JTileConfig(32, 32), 1024, with_features=False)
    bt = bin_gaussians(tp, TileConfig(32, 32), 1024)
    for name in ("gauss_id", "tile_id", "starts", "ends", "num_instances",
                 "overflow"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)))
    assert bt.order.tolist() == list(range(TileConfig(32, 32).num_tiles))
    assert bt.by_tile.tolist() == list(range(1024))


def test_bin_gaussians_tile_order(projected):
    """The rasterizers' block order is built with the bounds: every tile
    once, longest list first, ties (the empty tiles among them) in index
    order."""
    _, tp = _both(projected)
    cfg = TileConfig(W, H)
    bt = bin_gaussians(tp, cfg, 4096)
    order = bt.order
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(cfg.num_tiles))
    assert torch.equal(order, tile_order(bt.ends - bt.starts))
    n = (bt.ends - bt.starts)[order.long()]
    assert int(n[0]) > 0 and int(n[-1]) == 0
    assert bool((n[:-1] >= n[1:]).all())
    tie = n[:-1] == n[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())


def _splatjax_expand(d, capacity, cfg):
    """splatjax's expansion kernel fed a table built, as
    splatjax.ops.binning.bin_gaussians builds it, from the SAME
    depth-ordered arrays the port's expansion takes."""
    n = d["cum_d"].shape[0]
    cum_d = d["cum_d"].astype(np.int64)
    count_d = d["count_d"].astype(np.int64)
    cum_ex = cum_d - count_d
    f32 = np.float32

    def limbs(v):
        return [(v & 255).astype(f32), ((v >> 8) & 255).astype(f32),
                (v >> 16).astype(f32)]

    zero = np.zeros((n,), f32)
    tbl = np.stack(
        [d["x0_d"].astype(f32), d["y0_d"].astype(f32),
         d["spanw_d"].astype(f32), cum_d.astype(f32), cum_ex.astype(f32)]
        + limbs(d["perm"].astype(np.int64)) + limbs(cum_ex)
        + [zero] * 5,
        axis=-1,
    )
    vpad = -(-(n + jexpand.PAD_G) // 128) * 128
    pad_row = np.zeros((jexpand.TBL_ROWS,), f32)
    pad_row[jexpand.COL_SPANW] = 1.0
    pad_row[jexpand.COL_CUM_INCL] = float(1 << 24)
    pad_row[jexpand.COL_CUM_EXCL] = float(1 << 24)
    tbl_t = np.concatenate(
        [tbl, np.broadcast_to(pad_row, (vpad - n, jexpand.TBL_ROWS))]
    ).T
    cap_pad = -(-capacity // jexpand.CHUNK) * jexpand.CHUNK
    j_bounds = jnp.arange(0, cap_pad, jexpand.CHUNK).astype(jnp.float32)
    sub_g0 = _searchsorted_right_blocked(jnp.asarray(cum_d.astype(f32)),
                                         j_bounds)
    sub_g0 = jnp.minimum(sub_g0, int((count_d > 0).sum()))
    total = jnp.minimum(jnp.int32(cum_d[-1]), capacity)
    tile, gid = jexpand.expand_instances(
        jnp.asarray(tbl_t), sub_g0, total, cap_pad, cfg.tiles_x,
        cfg.num_tiles, n,
    )
    return np.asarray(tile)[:capacity], np.asarray(gid)[:capacity]


@pytest.mark.parametrize("capacity", [3000, 500])
def test_expand_plain_matches_splatjax_kernel(projected, capacity):
    _, tp = _both(projected)
    cfg = TileConfig(W, H)
    d = depth_order(tp, cfg)
    tile_t, gid_t = expand_instances(d.x0_d, d.y0_d, d.spanw_d, d.cum_d,
                                     d.perm, capacity, cfg.tiles_x,
                                     cfg.num_tiles)
    tile_j, gid_j = _splatjax_expand(
        {k: getattr(d, k).numpy() for k in d._fields}, capacity, cfg)
    total = int(d.cum_d[-1])
    if capacity == 500:
        assert total > capacity        # overflow: the farthest drop
    else:
        assert total < capacity        # sentinel tail present
    np.testing.assert_array_equal(tile_t.numpy(), tile_j)
    np.testing.assert_array_equal(gid_t.numpy(), gid_j)
    n = d.cum_d.shape[0]
    assert (gid_t.numpy()[min(total, capacity):] == n - 1).all()
    assert (tile_t.numpy()[min(total, capacity):] == cfg.num_tiles).all()


def _wide_viewport_bins(capacity):
    """300 gaussians that each cover all 8,388,608 tiles of a 65536x32768
    viewport: 2,516,582,400 instances, past 2^31 with N small."""
    n = 300
    cfg = TileConfig(65536, 32768)
    rng = np.random.default_rng(8)
    proj = TProj(
        mean2d=torch.tensor([[32768.0, 16384.0]]).repeat(n, 1),
        conic=torch.ones((n, 3)),
        depth=torch.from_numpy(-rng.permutation(n).astype(np.float32) - 1),
        mask=torch.ones((n,), dtype=torch.bool),
        bbox_half=torch.tensor([[40000.0, 20000.0]]).repeat(n, 1),
        color=torch.ones((n, 3)),
        opacity=torch.ones((n,)),
    )
    return proj, cfg, n * cfg.num_tiles


def test_instance_counts_past_int32():
    """The count sum passes 2^31: num_instances and overflow are the true
    int64 values, the int32 cumsums saturate instead of wrapping, and K1's
    plain version fills exactly the capacity's slots with the nearest
    gaussian's tiles."""
    capacity = 4096
    proj, cfg, total = _wide_viewport_bins(capacity)
    assert total > 2 ** 31
    d = depth_order(proj, cfg)
    assert int(d.cum_d.min()) > 0 and int(d.cum.min()) > 0
    assert int(d.cum_d[-1]) == int(d.cum[-1]) == 2 ** 31 - 1
    assert bool((d.cum_d[1:] >= d.cum_d[:-1]).all())
    assert int(d.total) == total
    b = bin_gaussians(proj, cfg, capacity)
    assert b.num_instances.dtype == b.overflow.dtype == torch.int64
    assert int(b.num_instances) == total
    assert int(b.overflow) == total - capacity
    front = int(torch.argmax(proj.depth))    # nearest: depth closest to 0
    assert (b.gauss_id == front).all()
    assert torch.equal(b.tile_id, torch.arange(capacity, dtype=torch.int32))
    assert int(b.ends[capacity - 1]) == capacity
    assert int(b.ends[-1]) == capacity


@pytest.mark.parametrize("mode", ["f32", "i16"])
def test_backward_runs_past_int32(monkeypatch, mode):
    """On those bins the slot path's runs (the CUDA path, through its plain
    versions) and the gid-sort path both put every kept row on the nearest
    gaussian and none on the rest: the f32 gather to the sum of the rows,
    the i16 gather bit-equal between the two paths."""
    from splatjax_torch.ops import binning as tb

    monkeypatch.setenv("SPLATJAX_GRAD_GATHER", mode)
    capacity = 4096
    proj, cfg, _ = _wide_viewport_bins(capacity)
    b = bin_gaussians(proj, cfg, capacity)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(capacity, 16)).astype(np.float32))
    res = (b.gauss_id, b.cum, b.count, b.perm, b.cum_d, b.count_d,
           b.overflow)
    slots = tb._segment_sum_slots(g, tb.tile_slot_positions(b.by_tile),
                                  b.cum_d, b.perm)
    by_gid = tb.segment_sum_by_gid(g, *res)
    front = int(torch.argmax(proj.depth))
    want = torch.zeros_like(by_gid)
    want[front] = g.double().sum(0).float()
    if mode == "i16":
        assert torch.equal(slots, by_gid)
        assert not slots[torch.arange(slots.shape[0]) != front].any()
    else:
        for got in (slots, by_gid):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
