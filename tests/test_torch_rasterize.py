"""Port parity, forward rasterizer: the plain version of the port's K2
(``rasterize_fwd`` on CPU tensors) against splatjax's Pallas
``rasterize_cm_fwd`` (interpret mode) on the same packed rows.

Tolerance: 1e-4 absolute on r, g, b, T_final and expected depth (f32
compositing in another summation order; splatjax's within-chunk scans run
as bf16-split matmuls); chunks_done (row 4) must be equal, since the
backward re-walks exactly those chunks. Row packing and image assembly are
bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.camera import make_camera
from splatjax.io import synthetic_scene
from splatjax.ops import rasterize as jr
from splatjax.ops.binning import TileConfig as JTileConfig
from splatjax.ops.binning import bin_gaussians as j_bin
from splatjax.ops.binning import features_from_projection
from splatjax.ops.projection import project_gaussians
from splatjax.scene import build_covariances

from splatjax_torch.ops import rasterize as tr
from splatjax_torch.ops.binning import TileConfig, tile_order

W, H = 48, 32
TOL = 1e-4
CHUNK = 128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def binned():
    """A dense 6-tile frame: several 128-instance chunks per tile with
    unaligned tile starts, and tiles that stop early at 1e-4."""
    scene = synthetic_scene(1200, seed=41, extent=0.35,
                            scale_range=(0.04, 0.1),
                            opacity_range=(0.6, 1.0))
    cam = make_camera((0, 0, 0.9), (0, 0, 0), width=W, height=H)
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, W, H,
        max_scales=jnp.max(jnp.asarray(scene.scales), axis=-1),
    )
    b = j_bin(proj, JTileConfig(W, H), 16384, with_features=False)
    assert int(b.overflow) == 0
    feat_n = np.asarray(features_from_projection(proj))
    depth = np.asarray(proj.depth)
    zbuf = np.full((H, W), float(np.median(depth)), np.float32)
    zbuf[:, : W // 3] = -np.inf           # a third of the frame unoccluded
    return dict(feat_n=feat_n, gid=np.asarray(b.gauss_id),
                starts=np.asarray(b.starts), ends=np.asarray(b.ends),
                zbuf=zbuf)


def _t(a):
    return torch.from_numpy(np.array(a))


def _splatjax_tiles(d, alpha_clip, early_stop, zbuf):
    cfg = JTileConfig(W, H)
    feat_cm = jr.gather_chunk_major(
        jr.pack_feature_table(jnp.asarray(d["feat_n"])), jnp.asarray(d["gid"])
    )
    zb = None if zbuf is None else jr.zbuffer_to_tiles(jnp.asarray(zbuf), cfg)
    out, _ = jr.rasterize_cm_fwd(
        feat_cm, jnp.asarray(d["starts"]), jnp.asarray(d["ends"]), cfg,
        alpha_clip=alpha_clip, early_stop=early_stop, zbuf=zb,
    )
    return np.asarray(out)


def _port_tiles(d, alpha_clip, early_stop, zbuf):
    cfg = TileConfig(W, H)
    rows = tr.gather_rows(tr.pack_feature_table(_t(d["feat_n"])),
                          _t(d["gid"]))
    zb = None if zbuf is None else tr.zbuffer_to_tiles(_t(zbuf), cfg)
    return tr.rasterize_fwd(rows, _t(d["starts"]), _t(d["ends"]), cfg,
                            alpha_clip=alpha_clip, early_stop=early_stop,
                            zbuf=zb).numpy()


def test_pack_and_gather_bit_equal(binned):
    want = np.asarray(jr.pack_feature_table(jnp.asarray(binned["feat_n"])))
    got = tr.pack_feature_table(_t(binned["feat_n"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = tr.gather_rows(got, _t(binned["gid"])).numpy()
    np.testing.assert_array_equal(rows, want[binned["gid"]])


def _special_features(feat_n, nan_lanes, nan=(np.nan, -np.nan), seed=4):
    """The frame's features with lanes 0-9 of half the gaussians drawn from
    values the quantizers clamp, saturate or round at a half step, and the
    NaNs ``nan`` in ``nan_lanes``; the rest keep the frame's values."""
    feat = feat_n.copy()
    rng = np.random.default_rng(seed)
    specials = np.array([np.inf, -np.inf, -0.3, 1.7, 1e9, -1e9, -0.0,
                         0.5 / 65535.0, 1.5 / 255.0, -2048.0 + 0.0625,
                         6143.9375, 1e-40], np.float32)
    half = feat.shape[0] // 2
    feat[:half, :10] = rng.choice(specials, size=(half, 10))
    nan = np.array(nan, np.float32)
    for lane in nan_lanes:
        rows = rng.choice(half, size=half // 8, replace=False)
        feat[rows, lane] = rng.choice(nan, size=rows.size)
    return feat


def _gid_with_padding(gid, pad=300):
    """The frame's ids with a zero-filled tail, as the binning's unused
    slots hold."""
    return np.concatenate([gid, np.zeros(pad, np.int32)])


@pytest.mark.parametrize("packed16", [False, True])
def test_pack_gather_rows_equals_table_pack_and_gather(binned, packed16):
    """On CPU tensors the wrapper is the plain composition, bit for bit,
    NaN in every lane included."""
    feat = _t(_special_features(binned["feat_n"], range(10)))
    gid = _t(_gid_with_padding(binned["gid"]))
    got = tr.pack_gather_rows(feat, gid, packed16)
    assert got.dtype == torch.int32 and got.shape == (gid.shape[0], 8)
    want = tr.gather_rows(tr.pack_table(feat, packed16), gid)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("packed16", [False, True])
def test_pack_gather_rows_matches_splatjax(binned, packed16):
    """The rows of splatjax's table pack through ``gather_chunk_major``, in
    instance-major order. NaN sits only in the lanes no int32 conversion
    reads (conic, depth), where torch's CPU cast gives INT_MIN and XLA's 0,
    and only with its sign clear, which XLA's bf16 rounding keeps and
    torch's CPU one does not."""
    feat = _special_features(binned["feat_n"], (2, 3, 4, 9), nan=(np.nan,))
    gid = _gid_with_padding(binned["gid"])
    pack = jr.pack_feature_table16 if packed16 else jr.pack_feature_table
    cm = np.asarray(jr.gather_chunk_major(pack(jnp.asarray(feat)),
                                          jnp.asarray(gid)))
    want = cm.transpose(0, 2, 1).reshape(-1, 8)[: gid.shape[0]]
    got = tr.pack_gather_rows(_t(feat), _t(gid), packed16).numpy()
    np.testing.assert_array_equal(got, want)


PACK_REJECTS = {
    "feat_f64": (lambda f, g: (f.double(), g), "feat_n has dtype"),
    "gid_i64": (lambda f, g: (f, g.long()), "gid has dtype"),
    "width_10": (lambda f, g: (f[:, :10].contiguous(), g), r"\(N, 16\)"),
    "feat_strided": (lambda f, g: (torch.cat([f, f], 1)[:, ::2], g),
                     "contiguous"),
    "gid_2d": (lambda f, g: (f, g[:, None]), r"\(K,\)"),
    "meta": (lambda f, g: (f.to("meta"), g.to("meta")), "unsupported"),
    "no_gaussians": (lambda f, g: (f[:0], g), "no gaussian"),
}


@pytest.mark.parametrize("case", sorted(PACK_REJECTS))
def test_pack_gather_rows_rejects_bad_inputs(binned, case):
    make, match = PACK_REJECTS[case]
    feat, gid = make(_t(binned["feat_n"]), _t(binned["gid"]))
    with pytest.raises(ValueError, match=match):
        tr.pack_gather_rows(feat, gid)


# (alpha_clip, early_stop, zbuf)
K2_CASES = {
    "clip999_es1e-4": (0.999, 1e-4, False),
    "noclip_es1e-4": (None, 1e-4, False),
    "clip999_exact": (0.999, 0.0, False),
    "noclip_exact": (None, 0.0, False),
    "clip999_zbuf": (0.999, 1e-4, True),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_rasterize_plain_matches_splatjax(binned, case):
    clip, es, use_zb = K2_CASES[case]
    zbuf = binned["zbuf"] if use_zb else None
    want = _splatjax_tiles(binned, clip, es, zbuf)
    got = _port_tiles(binned, clip, es, zbuf)
    assert got.shape == want.shape == (6, 8, 256)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])   # chunks_done
    err = np.abs(got[:, [0, 1, 2, 3, 5]] - want[:, [0, 1, 2, 3, 5]]).max()
    assert err <= TOL, (case, err)
    # the frame exercises what the chunking contract is about
    starts, ends = binned["starts"], binned["ends"]
    astart = starts // CHUNK * CHUNK
    n_chunks = -(-(ends - astart) // CHUNK)
    assert (n_chunks > 1).all() and (starts % CHUNK != 0).any()
    if es == 0.0:
        assert (got[:, 4, 0] == n_chunks).all()    # exact walks every chunk
    elif not use_zb:
        assert (got[:, 4, 0] < n_chunks).any()     # a tile stopped early


def test_image_assembly_bit_equal():
    rng = np.random.default_rng(5)
    for w, h in ((W, H), (72, 40)):
        cfg_j, cfg_t = JTileConfig(w, h), TileConfig(w, h)
        tiles = rng.uniform(size=(cfg_t.num_tiles, 8, 256)).astype(np.float32)
        bg = np.array([0.1, 0.9, 0.2], np.float32)
        np.testing.assert_array_equal(
            tr.tiles_to_image(_t(tiles), cfg_t, _t(bg)).numpy(),
            np.asarray(jr.tiles_to_image(jnp.asarray(tiles), cfg_j,
                                         jnp.asarray(bg))),
        )
        np.testing.assert_array_equal(
            tr.tiles_to_depth(_t(tiles), cfg_t).numpy(),
            np.asarray(jr.tiles_to_depth(jnp.asarray(tiles), cfg_j)),
        )
        zb = rng.uniform(-3, -1, size=(h, w)).astype(np.float32)
        np.testing.assert_array_equal(
            tr.zbuffer_to_tiles(_t(zb), cfg_t).numpy(),
            np.asarray(jr.zbuffer_to_tiles(jnp.asarray(zb), cfg_j)),
        )


def test_tile_order_heaviest_first():
    """The rasterizer kernels' block order: a permutation of every tile,
    longest list first, ties (empty tiles among them) in index order."""
    work = torch.tensor([0, 5, 3, 5, 0, 9, 1, 3, 0], dtype=torch.int32)
    order = tile_order(work)
    assert order.dtype == torch.int32
    assert order.tolist() == [5, 1, 3, 2, 7, 6, 0, 4, 8]
    work = _t(np.random.default_rng(3).integers(0, 4, size=2000,
                                                  dtype=np.int32))
    order = tile_order(work).long()
    assert sorted(order.tolist()) == list(range(2000))
    w = work[order]
    assert bool((w[:-1] >= w[1:]).all())
    tie = w[:-1] == w[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())


def test_wrapper_rejects_bad_inputs(binned):
    cfg = TileConfig(W, H)
    rows = tr.pack_feature_table(_t(binned["feat_n"]))
    starts, ends = _t(binned["starts"]), _t(binned["ends"])
    with pytest.raises(ValueError, match="rows"):
        tr.rasterize_fwd(rows[:, :4].contiguous(), starts, ends, cfg)
    with pytest.raises(ValueError, match="starts"):
        tr.rasterize_fwd(rows, starts.long(), ends, cfg)
    with pytest.raises(ValueError, match="ends"):
        tr.rasterize_fwd(rows, starts, ends[:-1], cfg)
    with pytest.raises(ValueError, match="8, 16, 32, 64"):
        TileConfig(W, H, 12, 12)
