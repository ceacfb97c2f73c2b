"""Port parity, the gather transpose through the tile sort's inverse.

On CUDA tensors the port sums each gaussian's gradient rows where the
backward wrote them, in tile order, reading gaussian g's rows at
``slot_pos[s]`` for its depth-major expansion slots s (``slot_pos`` the
inverse of ``BinnedInstances.by_tile``), instead of sorting the rows by gid
as splatjax does. These tests hold that path, through the plain versions of
its kernels (``_segment_reduce_slots_*`` on CPU tensors), to splatjax's
``segment_sum_by_gid*`` on bins that the port's ``bin_gaussians`` built
over a 3000-splat scene at 192x128, at full capacity and with 40% of the
instances cut.

Tolerances, as ``test_torch_segreduce.py``: the i16 gather (K6) is
bit-equal; f32, bf16 and packed bf16 rows (K5, K7) are within rtol 1e-5 of
the value plus the channel's largest |sum| (the port's plain versions sum
in float64, splatjax's one-hot matmuls in f32).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatjax.ops import binning as jb

from splatjax_torch import make_camera
from splatjax_torch.io import synthetic_scene
from splatjax_torch.ops import binning as tb
from splatjax_torch.ops.projection import project_gaussians
from splatjax_torch.ops.rasterize_vjp import _pack_grad_bf16
from splatjax_torch.scene import build_covariances

W, H = 192, 128
RTOL = 1e-5
RES = ("gauss_id", "cum", "count", "perm", "cum_d", "count_d", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bins():
    """The port's bins of one scene: full capacity, and 40% cut."""
    scene = synthetic_scene(3000, seed=1, device="cpu")
    cam = make_camera((0.0, 0.0, 2.5), (0, 0, 0), width=W, height=H,
                      device="cpu")
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, W, H,
        max_scales=scene.scales.amax(dim=-1), support_eps=1e-4)
    cfg = tb.TileConfig(W, H)
    total = int(tb.bin_gaussians(proj, cfg, 1 << 16).num_instances)
    out = {}
    for name, cap in (("full", total), ("cut", total - int(0.4 * total))):
        b = tb.bin_gaussians(proj, cfg, cap)
        assert (int(b.overflow) > 0) == (name == "cut")
        out[name] = b
    return out


def _rows(k, seed):
    """(k, 16) tile-order gradient rows, channels of mixed magnitude."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, 16))
            * 10.0 ** rng.integers(-2, 3, size=(1, 16))).astype(np.float32)


def _close(got, want):
    scale = np.abs(want).max(axis=0, keepdims=True)
    err = np.abs(got - want)
    assert (err <= RTOL * (np.abs(want) + scale)).all(), \
        (err / np.maximum(RTOL * (np.abs(want) + scale), 1e-30)).max()


def _splatjax(fn, rows_fm, b):
    """``fn`` jitted as splatjax runs it, traced anew: splatjax reads
    SPLATJAX_GRAD_GATHER at trace time."""
    jax.clear_caches()
    return np.asarray(jax.jit(fn)(
        jnp.asarray(rows_fm), *(jnp.asarray(getattr(b, f).numpy())
                                for f in RES)))


@pytest.mark.parametrize("cut", ["full", "cut"])
def test_slot_runs_equal_gid_sort_runs(bins, cut):
    """Each gaussian's rows in slot order (slot_pos over its depth-major
    slots) are exactly its rows in the stable gid sort's order."""
    b = bins[cut]
    k = b.gauss_id.shape[0]
    assert torch.equal(torch.sort(b.by_tile).values, torch.arange(k))
    slot_pos = tb.tile_slot_positions(b.by_tile)
    assert slot_pos.dtype == torch.int32
    assert torch.equal(slot_pos[b.by_tile], torch.arange(k, dtype=torch.int32))
    order = tb._gid_order(b.gauss_id).numpy()
    eff = tb._effective_cum(b.cum, b.count, b.perm, b.cum_d, b.count_d,
                            b.overflow, k).numpy()
    cum_d = b.cum_d.numpy().astype(np.int64)
    a_d = np.minimum(cum_d - b.count_d.numpy(), k)
    e_d = np.minimum(cum_d, k)
    rank = np.argsort(b.perm.numpy())
    sp = slot_pos.numpy()
    for g in range(eff.shape[0]):
        r = rank[g]
        by_gid = order[(eff[g - 1] if g else 0):eff[g]]
        np.testing.assert_array_equal(sp[a_d[r]:e_d[r]], by_gid)


@pytest.fixture(scope="module")
def splatjax_sums(bins):
    """splatjax's gid-sort sums of the same rows, for every mode."""
    out = {}
    prev = os.environ.get("SPLATJAX_GRAD_GATHER")
    try:
        for cut, b in bins.items():
            g = _rows(b.gauss_id.shape[0], seed=2)
            for mode in ("f32", "i16", "bf16"):
                os.environ["SPLATJAX_GRAD_GATHER"] = mode
                out[cut, mode] = _splatjax(jb.segment_sum_by_gid, g.T, b)
            gp = _pack_grad_bf16(torch.from_numpy(g)).numpy()
            out[cut, "packed_bf16"] = _splatjax(
                jb.segment_sum_by_gid_packed_bf16, gp.T, b)
    finally:
        if prev is None:
            os.environ.pop("SPLATJAX_GRAD_GATHER", None)
        else:
            os.environ["SPLATJAX_GRAD_GATHER"] = prev
    return out


@pytest.mark.parametrize("cut", ["full", "cut"])
@pytest.mark.parametrize("mode", ["f32", "i16", "bf16", "packed_bf16"])
def test_slot_sums_match_splatjax(monkeypatch, bins, splatjax_sums, mode,
                                  cut):
    b = bins[cut]
    g = torch.from_numpy(_rows(b.gauss_id.shape[0], seed=2))
    slot_pos = tb.tile_slot_positions(b.by_tile)
    if mode == "packed_bf16":
        from splatjax_torch.ops.segreduce import (
            _segment_reduce_slots_packed_bf16,
        )
        got = _segment_reduce_slots_packed_bf16(_pack_grad_bf16(g),
                                                slot_pos, b.cum_d, b.perm)
    else:
        monkeypatch.setenv("SPLATJAX_GRAD_GATHER", mode)
        got = tb._segment_sum_slots(g, slot_pos, b.cum_d, b.perm)
    want = splatjax_sums[cut, mode]
    assert got.shape == want.shape == (b.cum.shape[0], 16)
    if mode == "i16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.numpy(), want)


@pytest.mark.parametrize("cut", ["full", "cut"])
def test_cpu_sums_do_not_need_by_tile(bins, cut):
    """On CPU tensors the gather transpose stays splatjax's gid-sort path:
    the same sums whether or not the bins carry by_tile."""
    b = bins[cut]
    g = torch.from_numpy(_rows(b.gauss_id.shape[0], seed=3))
    res = [getattr(b, f) for f in RES]
    gp = _pack_grad_bf16(g)
    for fn, rows in ((tb.segment_sum_by_gid, g),
                     (tb.segment_sum_by_gid_packed_bf16, gp)):
        assert torch.equal(fn(rows, *res), fn(rows, *res, by_tile=b.by_tile))


def test_device_call_without_by_tile_raises(bins):
    """Off the CPU there is no gid-sort fallback: bins without by_tile are
    refused before any kernel runs (meta tensors stand in for the card)."""
    b = bins["full"]
    k = b.gauss_id.shape[0]
    res = [torch.empty(t.shape, dtype=t.dtype, device="meta")
           for t in (getattr(b, f) for f in RES)]
    with pytest.raises(ValueError, match="by_tile"):
        tb.segment_sum_by_gid(torch.empty((k, 16), device="meta"), *res)
    with pytest.raises(ValueError, match="by_tile"):
        tb.segment_sum_by_gid_packed_bf16(
            torch.empty((k, 8), dtype=torch.int32, device="meta"), *res)


def test_slot_wrappers_reject_bad_inputs(bins):
    from splatjax_torch.ops import segreduce as ts

    b = bins["full"]
    k = b.gauss_id.shape[0]
    slot_pos = tb.tile_slot_positions(b.by_tile)
    rows = torch.zeros((k, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_pos"):
        ts._segment_reduce_slots_packed_bf16(rows, slot_pos[:-1], b.cum_d,
                                             b.perm)
    with pytest.raises(ValueError, match="slot_pos"):
        ts._segment_reduce_slots_packed_u16(rows, b.by_tile, b.cum_d,
                                            b.perm)
    with pytest.raises(ValueError, match="perm"):
        ts._segment_reduce_slots_packed_u16(rows, slot_pos, b.cum_d,
                                            b.perm[:-1])
    with pytest.raises(ValueError, match="dividing 32"):
        ts._segment_reduce_slots_rows(torch.zeros((k, 12)), slot_pos,
                                      b.cum_d, b.perm)
    # C < 4 is summed like any other width
    g = torch.from_numpy(_rows(k, seed=4))[:, :2].contiguous()
    got = ts._segment_reduce_slots_rows(g, slot_pos, b.cum_d, b.perm)
    want = ts._segment_reduce_slots_rows(
        torch.nn.functional.pad(g, (0, 2)), slot_pos, b.cum_d, b.perm)[:, :2]
    assert torch.equal(got, want)


def test_slot_entries_are_library_internal():
    """The slot entries trust slot_pos, cum_d and perm as device indices,
    so only bin_gaussians' own outputs reach them: ops.segreduce shows no
    public slot entry."""
    from splatjax_torch.ops import segreduce as ts

    assert [n for n in dir(ts) if "slots" in n and not n.startswith("_")
            ] == []
    for kind in ("rows", "packed_u16", "packed_bf16"):
        assert callable(getattr(ts, f"_segment_reduce_slots_{kind}"))
