"""Port parity, the tile edge: ``render``, ``render_binned``, the gradient
and every entry point that takes ``tile_size``, at square tiles of 8, 32
and 64 px, against splatjax (CPU, Pallas in interpret mode) on the same
numpy scene; the plain versions of K2, K3 and K4 carry the port here.

300 splats at 96x64 for 8 and 32 px, 48x32 (one tile) at 64 px, where
splatjax's own error against ``render_reference`` grows to 2e-4.

Tolerances: the 32-byte render within 1e-4 of splatjax's (both composite
the same rows in f32, in other summation orders); the 16-byte render and
the 16-byte cached redraw (K3's plain version) within 1e-2 (splatjax's
16-byte mode runs its scans and color sums as single bf16 MXU passes); the
32-byte gradients of every ``TrainableGaussians`` leaf within atol 2e-3 x
the largest |gradient|, rtol 2e-3 (splatjax's own gradient contract); the
port's entry points against each other bit-equal, and the one-rank
``render_sharded`` within 1e-4 of ``render``.

The contracts the 32 and 64 px cluster kernels and the 8 px kernels keep,
on the plain versions (CPU, no splatjax): one chunks_done a tile; the
support rectangle that lets a sub-block skip an instance holding every
fragment that passes the cutoff, on scene rows and on random conics
(hypothesis), also at 8 px, where cluster_variants.py's warp skip relies
on it; and at 8 px, with no early stop, a result that does not depend on
where the chunk grid falls. A plain-torch model of the split walk of 8 px
tiles that cluster_variants.py times as a variant of K4 (a chunk's rows cut
into segments joined by a pre-pass of log-transmittance and suffix sums),
against the plain K4 on moved rows and on a stack whose T underflows f32.
"""
import dataclasses
import importlib
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs
import torch
import torch.distributed as dist

from splatjax.camera import make_camera as j_make_camera
from splatjax.io import synthetic_scene
from splatjax.render import bin_scene as j_bin_scene
from splatjax.render import render as j_render
from splatjax.render import render_binned as j_render_binned
from splatjax.scene import GaussianScene as JScene
from splatjax.scene import TrainableGaussians as JTrainable

import splatjax_torch as st
from splatjax_torch.ops.binning import TileConfig

EDGES = (8, 32, 64)
VIEW = {8: (96, 64), 32: (96, 64), 64: (48, 32)}
EYE = (0, 0, 2.2)
TOL = 1e-4
TOL_16 = 1e-2
GRAD_TOL = 2e-3
LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors")

_render_mod = importlib.import_module("splatjax_torch.render")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves():
    s = synthetic_scene(300, seed=21, extent=0.6, scale_range=(0.02, 0.08))
    return {k: np.asarray(getattr(JTrainable.from_scene(s), k))
            for k in LEAVES}


def _t_cam(w, h, eye=EYE):
    return st.make_camera(eye, (0, 0, 0), width=w, height=h, device="cpu")


def _t_scene(leaves):
    """The activated scene of ``leaves``, detached from them."""
    s = st.trainable_from_numpy(leaves, device="cpu").to_scene()
    return st.GaussianScene(**{
        f.name: None if getattr(s, f.name) is None
        else getattr(s, f.name).detach() for f in dataclasses.fields(s)})


@pytest.fixture(scope="module", params=EDGES, ids=lambda e: f"tile{e}")
def jref(request):
    """splatjax at one tile edge: the 32-byte image and the gradient of
    sum(image * target) w.r.t. every leaf (one vjp), the 16-byte image,
    and the 16-byte redraw on ``bin_scene(cache_params=True)``."""
    edge = request.param
    w, h = VIEW[edge]
    leaves = _leaves()
    tgt = np.random.default_rng(edge).normal(size=(h, w, 4)).astype(
        np.float32)
    cam = j_make_camera(EYE, (0, 0, 0), width=w, height=h)
    params = JTrainable(**{k: jnp.asarray(v) for k, v in leaves.items()})
    img32, vjp = jax.vjp(
        lambda p: j_render(p.to_scene(), cam, tile_size=edge), params)
    (grads,) = vjp(jnp.asarray(tgt))
    scene = params.to_scene()
    bins = j_bin_scene(scene, cam, tile_size=edge, cache_params=True)
    return dict(
        edge=edge, leaves=leaves, tgt=tgt,
        img32=np.asarray(img32),
        grads={k: np.asarray(getattr(grads, k)) for k in LEAVES},
        img16=np.asarray(j_render(scene, cam, tile_size=edge,
                                  feature_bytes=16)),
        cached16=np.asarray(j_render_binned(scene, cam, bins,
                                            tile_size=edge,
                                            feature_bytes=16)),
    )


@pytest.mark.parametrize("feature_bytes", (32, 16))
def test_render_matches_splatjax(jref, feature_bytes):
    edge = jref["edge"]
    img, overflow = st.render(_t_scene(jref["leaves"]), _t_cam(*VIEW[edge]),
                              tile_size=edge, feature_bytes=feature_bytes,
                              return_overflow=True)
    want = jref["img32" if feature_bytes == 32 else "img16"]
    assert int(overflow) == 0 and want[..., 3].mean() > 0.1
    np.testing.assert_allclose(img.numpy(), want,
                               atol=TOL if feature_bytes == 32 else TOL_16)


def test_cached_redraw_matches_splatjax(jref):
    edge = jref["edge"]
    scene, cam = _t_scene(jref["leaves"]), _t_cam(*VIEW[edge])
    bins = st.bin_scene(scene, cam, tile_size=edge, cache_params=True)
    assert bins.bins.starts.numel() == TileConfig(
        *VIEW[edge], edge, edge).num_tiles
    img = st.render_binned(scene, cam, bins, tile_size=edge,
                           feature_bytes=16)
    np.testing.assert_allclose(img.numpy(), jref["cached16"], atol=TOL_16)


def test_gradients_match_splatjax(jref):
    edge = jref["edge"]
    params = st.trainable_from_numpy(jref["leaves"], device="cpu")
    img = st.render(params.to_scene(), _t_cam(*VIEW[edge]), tile_size=edge)
    (img * torch.from_numpy(jref["tgt"])).sum().backward()
    got = np.concatenate([getattr(params, k).grad.numpy().ravel()
                          for k in LEAVES])
    want = np.concatenate([jref["grads"][k].ravel() for k in LEAVES])
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("feature_bytes", (32, 16))
def test_stale_order_renderer_equals_render_binned(feature_bytes):
    """SplatRenderer(tile_size=32, resort_interval=3) over five eyes: each
    frame is render_binned on the bins of the frame that last rebuilt
    them (frames 0 and 3)."""
    scene = _t_scene(_leaves())
    cams = [_t_cam(96, 64, (0.02 * i, -0.01 * i, 2.2)) for i in range(5)]
    r = st.SplatRenderer(scene=scene, tile_size=32, resort_interval=3,
                         feature_bytes=feature_bytes, device="cpu")
    for i, cam in enumerate(cams):
        got = r.render(cam)
        bins = st.bin_scene(scene, cams[i // 3 * 3], tile_size=32,
                            cache_params=True)
        want = st.render_binned(scene, cam, bins, tile_size=32,
                                feature_bytes=feature_bytes)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert r._bins.bins.starts.numel() == TileConfig(96, 64, 32, 32
                                                     ).num_tiles


def _compose(scene, cam):
    return st.compose_scene([(scene, None)], [], cam, tile_size=32)


def _instances(scene, cam):
    return st.render_instances([(scene, None)], cam, tile_size=32)


def _stereo(scene, cam, shared=False):
    right = _t_cam(96, 64, (0.03, 0, 2.2))
    return torch.cat(st.render_stereo(scene, cam, right, tile_size=32,
                                      xr_pixel_ratio=1.0,
                                      shared_bins=shared))


def _renderer(scene, cam):
    return st.SplatRenderer(scene=scene, tile_size=32, device="cpu"
                            ).render(cam)


# entry point -> (call at tile_size=32, the same frame by render())
PASS_ON = {
    "compose_scene": (_compose, lambda s, c: st.render(s, c, tile_size=32)),
    "render_instances": (_instances,
                         lambda s, c: st.render(s, c, tile_size=32)),
    "render_stereo": (_stereo, lambda s, c: torch.cat([
        st.render(s, c, tile_size=32),
        st.render(s, _t_cam(96, 64, (0.03, 0, 2.2)), tile_size=32)])),
    "render_stereo_shared": (lambda s, c: _stereo(s, c, True), None),
    "SplatRenderer": (_renderer, lambda s, c: st.render(s, c, tile_size=32)),
}


@pytest.mark.parametrize("entry", sorted(PASS_ON))
def test_entry_points_pass_tile_size_on(monkeypatch, entry):
    """Every binning under the entry point runs at the edge it was given,
    and the frame is render()'s at that edge."""
    edges = []
    bin_gaussians = _render_mod.bin_gaussians

    def spy(proj, cfg, capacity):
        edges.append((cfg.tile_w, cfg.tile_h))
        return bin_gaussians(proj, cfg, capacity)

    call, same = PASS_ON[entry]
    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    with monkeypatch.context() as m:
        m.setattr(_render_mod, "bin_gaussians", spy)
        got = call(scene, cam)
    assert edges and set(edges) == {(32, 32)}
    if same is not None:
        np.testing.assert_array_equal(got.numpy(), same(scene, cam).numpy())


@pytest.mark.parametrize("edge", (4, 12, 24, 0, (16, 32)))
def test_other_tile_edges_raise(edge):
    tw, th = edge if isinstance(edge, tuple) else (edge, edge)
    with pytest.raises(ValueError, match="8, 16, 32, 64"):
        TileConfig(96, 64, tw, th)
    if tw == th:
        with pytest.raises(ValueError, match="8, 16, 32, 64"):
            st.render(_t_scene(_leaves()), _t_cam(96, 64), tile_size=tw)


@pytest.mark.parametrize("cache_params", (False, True))
def test_render_binned_refuses_bins_of_another_edge(cache_params):
    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    bins = st.bin_scene(scene, cam, tile_size=32, cache_params=cache_params)
    with pytest.raises(ValueError, match="tile_size"):
        st.render_binned(scene, cam, bins)
    with pytest.raises(ValueError, match="tile_size"):
        st.render_binned(scene, _t_cam(160, 64), bins, tile_size=32)
    st.render_binned(scene, cam, bins, tile_size=32)


def test_render_sharded_one_rank(tmp_path):
    """A one-rank gloo group: render_sharded at each edge, both band
    layouts, within 1e-4 of render() at that edge, no instance dropped."""
    from splatjax_torch.parallel import (
        init_distributed, make_mesh, render_sharded,
    )

    scene, cam = _t_scene(_leaves()), _t_cam(96, 64)
    assert init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cpu")
    try:
        mesh = make_mesh(1, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            for edge in EDGES:
                want = st.render(scene, cam, tile_size=edge)
                for balance in ("load", "equal"):
                    img, overflow = render_sharded(
                        scene, cam, mesh, tile_size=edge, balance=balance,
                        return_overflow=True)
                    assert overflow.tolist() == [0]
                    np.testing.assert_allclose(img.numpy(), want.numpy(),
                                               atol=TOL)
            with pytest.raises(ValueError, match="8, 16, 32, 64"):
                render_sharded(scene, cam, mesh, tile_size=24)
    finally:
        dist.destroy_process_group()


# -- what the 8, 32 and 64 px kernels rely on, on the plain versions ---------

DENSE_EYE = (0.1, -0.2, 1.2)


def _dense_case(edge, kind):
    """A 2000-splat scene that covers the 80x64 view (alpha above 0.98 on
    every pixel; at 32 and 64 px every tile two to fourteen 128-instance
    chunks deep) through the plain version of K2 (``fwd32``, ``fwd16``) or
    K3 (``cached``) at tile edge ``edge``, clip 0.999 and an early stop of
    0.02, which ends the tiles inside the view before their last chunk.
    Returns the tile config, the tiles' bounds, the decoded features of
    every instance row (K2's packed rows, K3's projected cached rows), the
    plain output and the row buffer (K2's packed rows, K3's cached
    parameter rows)."""
    from splatjax_torch.io import synthetic_scene as t_synthetic_scene
    from splatjax_torch.ops.binning import (
        bin_gaussians, features_from_projection,
    )
    from splatjax_torch.ops.projection import project_gaussians
    from splatjax_torch.ops.rasterize import (
        cached_camera, decode_rows, gather_rows, pack_table,
        project_cached_rows, rasterize_cached_fwd_plain, rasterize_fwd_plain,
    )
    from splatjax_torch.scene import build_covariances

    scene = t_synthetic_scene(2000, seed=5, extent=0.7,
                              scale_range=(0.03, 0.1), device="cpu")
    cam = _t_cam(80, 64, DENSE_EYE)
    cfg = TileConfig(80, 64, edge, edge)
    es = 0.02
    if kind == "cached":
        bins = st.bin_scene(scene, cam, tile_size=edge, cache_params=True)
        b = bins.bins
        out = rasterize_cached_fwd_plain(
            bins.prm, cached_camera(cam.modelview, cam.projection, 80, 64),
            b.starts, b.ends, cfg, 0.999, es)
        feats = project_cached_rows(bins.prm, cam.modelview, cam.projection,
                                    80, 64)
        return cfg, b, feats, out, bins.prm
    packed16 = kind == "fwd16"
    proj = project_gaussians(
        scene.means, build_covariances(scene.quats, scene.scales),
        scene.colors, scene.opacities, cam.modelview, cam.projection, 80, 64,
        max_scales=scene.scales.amax(dim=-1), support_eps=es)
    b = bin_gaussians(proj, cfg, 1 << 16)
    assert int(b.overflow) == 0
    rows = gather_rows(pack_table(features_from_projection(proj), packed16),
                       b.gauss_id)
    out = rasterize_fwd_plain(rows, b.starts, b.ends, cfg, 0.999, es,
                              packed16=packed16)
    return cfg, b, decode_rows(rows, packed16), out, rows


@pytest.mark.parametrize("kind", ("fwd32", "fwd16", "cached"))
@pytest.mark.parametrize("edge", (8, 32, 64))
def test_chunks_done_is_one_value_per_tile(edge, kind):
    """Output row 4 (chunks_done) is one value over every pixel of a tile:
    the whole tile stops at once. The 32 and 64 px kernels vote that stop
    across their cluster to keep it, the 8 px kernel across its two
    thread groups, and K4 reads it at a tile's pixel 0 only. The early
    stop fires before the last chunk of some tile."""
    from splatjax_torch.ops.rasterize import CHUNK

    _, b, _, out, _ = _dense_case(edge, kind)
    done = out[:, 4]
    assert torch.equal(done, done[:, :1].expand_as(done))
    astart = b.starts.long() // CHUNK * CHUNK
    n_chunks = (b.ends.long() - astart + CHUNK - 1) // CHUNK
    walked = done[:, 0].long()
    assert bool((walked <= n_chunks).all())
    assert bool(((walked >= 1) & (walked < n_chunks)).any())


def _rect_holds(mxl, myl, ca, cb, cc, opa, edge):
    """How many (instance, pixel) pairs of a tile pass the cutoff, after
    asserting that each lies inside the instance's ``support_rect``; the
    arguments are (B, C) f32 tensors."""
    from splatjax_torch.ops.rasterize import (
        fragment_power, pixel_coords, support_rect,
    )

    x, y = pixel_coords(TileConfig(edge, edge, edge, edge), "cpu")
    power, lnopa = fragment_power(mxl, myl, ca, cb, cc, opa,
                                  (x, y, x * x, x * y, y * y))
    passes = power >= (lnopa - 4.0)[:, None, :]                # (B, P, C)
    x0, x1, y0, y1 = (v[:, None, :] for v in support_rect(
        mxl, myl, ca, cb, cc, lnopa, edge))
    inside = ((x[None, :, None] >= x0) & (x[None, :, None] <= x1)
              & (y[None, :, None] >= y0) & (y[None, :, None] <= y1))
    assert not bool((passes & ~inside).any())
    return int(passes.sum())


@pytest.mark.parametrize("kind", ("fwd32", "fwd16", "cached"))
@pytest.mark.parametrize("edge", (8, 32, 64))
def test_support_rect_holds_the_scene_rows(edge, kind):
    """Every fragment of the dense scene that passes the cutoff lies inside
    its instance's support rectangle, for each tile's own rows."""
    cfg, b, f, _, _ = _dense_case(edge, kind)
    passed = 0
    for t in range(cfg.num_tiles):
        k = torch.arange(int(b.starts[t]), int(b.ends[t]))
        ox = float((t % cfg.tiles_x) * edge) + 0.5 * edge
        oy = float((t // cfg.tiles_x) * edge) + 0.5 * edge
        mxl, myl = f[0][k] - ox, f[1][k] - oy
        passed += _rect_holds(*(v[None] for v in (
            mxl, myl, f[2][k], f[3][k], f[4][k], f[8][k])), edge)
    assert passed > 0


@settings(max_examples=60, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1), edge=hs.sampled_from((8, 32, 64)),
       log_ratio=hs.floats(0.0, 7.0), bf16=hs.booleans())
def test_support_rect_holds_random_conics(seed, edge, log_ratio, bf16):
    """Random conics (eigenvalues 1e-6 to 1e8 per px^2, aspect up to 1e7,
    any angle; bf16-rounded as in 16-byte rows), opacities down to zero
    and means around the tile: no pixel outside ``support_rect`` passes
    the cutoff."""
    rng = np.random.default_rng(seed)
    n = 128
    small = 10.0 ** rng.uniform(-6.0, 1.0, n)
    big = small * 10.0 ** (log_ratio * rng.uniform(0.0, 1.0, n))
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    conic = [big * c * c + small * s * s, (big - small) * c * s,
             big * s * s + small * c * c]
    reach = 0.5 * edge + 1.2 * np.sqrt(8.0 / small)
    mean = [np.clip(rng.uniform(-1.0, 1.0, n) * reach, -6000.0, 6000.0)
            for _ in range(2)]
    opa = np.where(rng.uniform(size=n) < 0.1, 0.0,
                   10.0 ** rng.uniform(-8.0, 0.0, n))
    t = [torch.tensor(v, dtype=torch.float32)[None]
         for v in (*mean, *conic, opa)]
    if bf16:
        t[2:5] = [v.to(torch.bfloat16).to(torch.float32) for v in t[2:5]]
    _rect_holds(*t, edge)


SHIFTS = (1, 63, 64, 65, 127)  # chip_smoke.py's row shifts past 0


@pytest.mark.parametrize("kind", ("fwd32", "fwd16", "cached"))
def test_plain_8px_does_not_depend_on_the_chunk_grid(kind):
    """The plain versions of K2 and K3 at 8 px with no early stop, on the
    instance rows moved s rows on in their buffer (s dummy rows before
    them, ``starts``/``ends`` moved by s): chunks are aligned to global
    multiples of 128, so s moves the chunk grid under the tiles, which
    changes only how each tile's sums are associated, within TOL of the
    rows in place, and the tile walks every chunk of the moved grid.
    chip_smoke.py holds the 8 px kernels against these plain versions on
    such moved rows."""
    from splatjax_torch.ops.rasterize import (
        CHUNK, cached_camera, rasterize_cached_fwd_plain, rasterize_fwd_plain,
    )

    cfg, b, _, _, rows = _dense_case(8, kind)
    cam = _t_cam(80, 64, DENSE_EYE)
    camera = cached_camera(cam.modelview, cam.projection, 80, 64)

    def run(moved, starts, ends):
        if kind == "cached":
            return rasterize_cached_fwd_plain(moved, camera, starts, ends,
                                              cfg, 0.999, 0.0)
        return rasterize_fwd_plain(moved, starts, ends, cfg, 0.999, 0.0,
                                   packed16=kind == "fwd16")

    want = run(rows, b.starts, b.ends)[:, [0, 1, 2, 3, 5]]
    for s in SHIFTS:
        moved = torch.cat([rows.new_zeros((s,) + rows.shape[1:]), rows])
        starts, ends = b.starts + s, b.ends + s
        out = run(moved, starts, ends)
        assert float((out[:, [0, 1, 2, 3, 5]] - want).abs().max()) <= TOL
        astart = starts.long() // CHUNK * CHUNK
        n_chunks = (ends.long() - astart + CHUNK - 1) // CHUNK
        assert torch.equal(out[:, 4, 0].long(), n_chunks)


SUB = 16   # the pixel edge of a cluster block's sub-block at 32 and 64 px
K4_TOL = 1e-4  # chip_smoke.py's K4_TOL: x each gradient channel's max
K4_TOL_DEEP = 1e-3  # chip_smoke.py's K4_TOL_FULL, for deep stacks
K4_MIN_ROWS = 16  # cluster_variants.py's Backward8Split::MIN_ROWS


def _segments(lo, hi, groups):
    """The segments that the split walk of 8 px tiles (cluster_variants.py's
    split8_k4 variant of K4, ``Backward8Split``) cuts a chunk's live rows
    [lo, hi) into, per (tile) entry of ``lo`` and ``hi``: their number, at
    most ``groups``, with at least K4_MIN_ROWS rows each (one where the
    chunk has no more), and each row's segment, 0 the back-most, over the
    chunk's CHUNK rows."""
    from splatjax_torch.ops.rasterize import CHUNK

    n = hi - lo
    nseg = torch.where(n > K4_MIN_ROWS,
                       (n // K4_MIN_ROWS).clamp_max(groups),
                       torch.ones_like(n))
    lane = torch.arange(CHUNK)
    seg = sum((lane[None] < (hi - n * g // nseg)[:, None]).long()
              for g in range(1, groups))
    return nseg, seg


def _segmented_bwd(rows, starts, ends, out_saved, g_out, cfg, alpha_clip,
                   groups, packed16):
    """A plain-torch model of the split walk of 8 px tiles
    (cluster_variants.py's split8_k4 variant of K4, ``Backward8Split``),
    vectorised over tiles, pixels and a chunk's rows:
    per chunk, its live rows cut into ``_segments``; each segment's
    per-pixel pre-pass, L = its sum of s = log(1 - alpha) and U = its sum
    of alpha exp(l) (g . c), l the sum of s in front of the row within the
    segment; each segment's start state from the chunk's back-edge (log T,
    S) and the (L, U) of the segments behind it, in order; each segment
    walked back to front from its start state (suffix sums where the
    kernel walks row by row); the next chunk's state by the same sums over
    every segment, or a one-segment chunk's own walk. The chain rule and
    masks are ``rasterize_bwd_plain``'s."""
    from splatjax_torch.ops.rasterize import (
        CHUNK, _LOG_OM_MIN, clip_bounds_alpha, decode_rows, fragment_power,
        log_clip, pixel_coords,
    )
    from splatjax_torch.ops.rasterize_vjp import (
        _om_floor, _pack_grad_bf16, _suffix_cumsum,
    )

    f32 = torch.float32
    grad = torch.zeros((rows.shape[0], 16), dtype=f32)
    x, y = pixel_coords(cfg, "cpu")
    basis = (x, y, x * x, x * y, y * y)
    lc = log_clip(alpha_clip)
    clamp = not clip_bounds_alpha(alpha_clip)
    lane = torch.arange(CHUNK)
    st, en = starts.long(), ends.long()
    astart = st // CHUNK * CHUNK
    c_done = out_saved[:, 4, 0].long()
    tb = torch.arange(cfg.num_tiles)
    ox = ((tb % cfg.tiles_x) * cfg.tile_w).to(f32) + 0.5 * cfg.tile_w
    oy = ((tb // cfg.tiles_x) * cfg.tile_h).to(f32) + 0.5 * cfg.tile_h
    g_d = g_out[:, 5] if g_out.shape[1] > 4 else torch.zeros_like(g_out[:, 0])
    cot = torch.stack([g_out[:, 0], g_out[:, 1], g_out[:, 2], g_d], dim=-1)
    lt = out_saved[:, 6, :]                                  # (T, P)
    gtt = g_out[:, 3] * lt.exp()
    s_carry = torch.zeros_like(lt)
    for c in range(int(c_done.max()) - 1, -1, -1):
        active = c < c_done
        base = astart + c * CHUNK
        k = base[:, None] + lane[None, :]
        in_range = (k >= st[:, None]) & (k < en[:, None]) & active[:, None]
        f = decode_rows(rows[k.clamp(0, rows.shape[0] - 1)], packed16)
        mxl, myl = f[0] - ox[:, None], f[1] - oy[:, None]
        col = torch.stack([f[5], f[6], f[7], f[9]], dim=-1)  # (T, C, 4)
        power, lnopa = fragment_power(mxl, myl, f[2], f[3], f[4], f[8], basis)
        valid = (power >= (lnopa - 4.0)[:, None, :]) & in_range[:, None, :]
        p_eff = power if lc is None else power.clamp_max(lc)
        zero = torch.zeros_like(p_eff)
        alpha = torch.where(valid, p_eff.exp(), zero)
        s = torch.log1p(-alpha)
        if clamp:
            s = s.clamp_min(_LOG_OM_MIN)
        gdotc = (cot[:, :, None, :] * col[:, None, :, :]).sum(-1)
        nseg, seg = _segments((st - base).clamp_min(0),
                              (en - base).clamp_max(CHUNK), groups)
        masks = [((seg == g) & in_range)[:, None, :] for g in range(groups)]
        # the pre-pass and the segments' start states, back to front
        lt_h, s_h, starts_g = lt, s_carry, []
        for g, m in enumerate(masks):
            sg = s * m
            l_excl = torch.cat([zero[..., :1], sg.cumsum(-1)[..., :-1]], -1)
            big_u = (alpha * l_excl.exp() * gdotc * m).sum(-1)
            starts_g.append((lt_h, s_h))
            on = (g < nseg)[:, None]
            lt_h = torch.where(on, lt_h - sg.sum(-1), lt_h)
            s_h = torch.where(on, s_h + lt_h.exp() * big_u, s_h)
        # each segment back to front from its start state
        lt_k, s_excl = zero.clone(), zero.clone()
        for g, m in enumerate(masks):
            lt_g = starts_g[g][0][:, :, None] - _suffix_cumsum(s * m)
            u_incl = _suffix_cumsum(alpha * lt_g.exp() * gdotc * m)
            se = torch.cat([u_incl[..., 1:], zero[..., :1]], dim=-1) \
                + starts_g[g][1][:, :, None]
            lt_k = torch.where(m, lt_g, lt_k)
            s_excl = torch.where(m, se, s_excl)
            if g == 0:  # a one-segment chunk's end state
                walk_end = (lt_g[..., 0], s_carry + u_incl[..., 0])
        t_k = lt_k.exp()
        tg = t_k * gdotc
        om = 1.0 - alpha
        if _om_floor(alpha_clip):
            om = torch.where(om > 1e-6, om, torch.full_like(om, 1e-6))
        g_alpha = tg - (s_excl + gtt[:, :, None]) / om
        if lc is not None:
            g_alpha = torch.where(power < lc, g_alpha, zero)
        g_pow = torch.where(valid, g_alpha * alpha, zero)
        w = alpha * t_k
        dx = x[None, :, None] - mxl[:, None, :]
        dy = y[None, :, None] - myl[:, None, :]
        sdx, sdy = (g_pow * dx).sum(1), (g_pow * dy).sum(1)
        cw = (w[..., None] * cot[:, :, None, :]).sum(1)       # (T, C, 4)
        ca, cb, cc, opa = f[2], f[3], f[4], f[8]
        rows10 = torch.stack(
            [ca * sdx + cb * sdy, cb * sdx + cc * sdy,
             -0.5 * (g_pow * dx * dx).sum(1), -(g_pow * dx * dy).sum(1),
             -0.5 * (g_pow * dy * dy).sum(1), cw[..., 0], cw[..., 1],
             cw[..., 2], g_pow.sum(1) / torch.where(
                 opa.abs() > 1e-12, opa, torch.full_like(opa, 1e-12)),
             cw[..., 3]], dim=-1)
        grad[k[in_range], :10] = rows10[in_range]
        one = (nseg == 1)[:, None]
        act = active[:, None]
        lt = torch.where(act, torch.where(one, walk_end[0], lt_h), lt)
        s_carry = torch.where(act, torch.where(one, walk_end[1], s_h),
                              s_carry)
    return _pack_grad_bf16(grad) if packed16 else grad


def _assert_k4_close(got, want, packed16, tol=K4_TOL):
    """chip_smoke.py's compare_k4: within ``tol`` of each channel's max
    |value|, plus one bf16 ulp for packed rows; finite, not all zero."""
    from splatjax_torch.ops.segreduce import unpack_bf16_pairs

    extra = 0.0
    if packed16:
        got, want = unpack_bf16_pairs(got), unpack_bf16_pairs(want)
        extra = 2.0 ** -7 * want.abs()
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    assert bool(got.isfinite().all()) and float(want.abs().max()) > 0.0
    assert bool(((got - want).abs() <= tol * scale + extra).all())


@pytest.fixture(scope="module")
def dense8():
    return {kind: _dense_case(8, kind) for kind in ("fwd32", "fwd16")}


@pytest.mark.parametrize("packed16", (False, True))
@pytest.mark.parametrize("groups", (1, 2, 4))
def test_k4_8px_segmented_walk_matches_plain(dense8, groups, packed16):
    """The split walk of 8 px tiles, modelled by ``_segmented_bwd``,
    within K4_TOL of ``rasterize_bwd_plain`` on the dense scene's rows in
    place and moved 1-127 rows on (the moves change where the chunk grid
    falls, so which chunks have one live row, fewer segments than groups
    or one per group; each kind occurs over the moves)."""
    from splatjax_torch.ops.rasterize import CHUNK, rasterize_fwd_plain
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd_plain

    cfg, b, _, _, rows = dense8["fwd16" if packed16 else "fwd32"]
    g_out = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (cfg.num_tiles, 8, cfg.pixels_per_tile)).astype(np.float32))
    kinds = set()
    for s in (0,) + SHIFTS:
        moved = torch.cat([rows.new_zeros((s,) + rows.shape[1:]), rows])
        starts, ends = b.starts + s, b.ends + s
        out = rasterize_fwd_plain(moved, starts, ends, cfg, 0.999, 0.02,
                                  packed16=packed16)
        _assert_k4_close(
            _segmented_bwd(moved, starts, ends, out, g_out, cfg, 0.999,
                           groups, packed16),
            rasterize_bwd_plain(moved, starts, ends, out, g_out, cfg, 0.999,
                                packed16=packed16), packed16)
        astart = starts.long() // CHUNK * CHUNK
        for c in range(int(out[:, 4, 0].max())):
            base = astart + c * CHUNK
            on = c < out[:, 4, 0].long()
            lo = (starts.long() - base).clamp_min(0)[on]
            hi = (ends.long() - base).clamp_max(CHUNK)[on]
            nseg = _segments(lo, hi, groups)[0]
            kinds |= {"one row"} if bool((hi - lo == 1).any()) else set()
            kinds |= {int(v) for v in nseg.unique()}
    assert kinds >= {"one row", *range(1, groups + 1)}


@pytest.mark.parametrize("packed16", (False, True))
def test_k4_8px_segmented_walk_past_t_underflow(packed16):
    """A stack of 600 instances over one 8 px tile whose log T falls below
    -100 at every pixel (about -485), so T underflows f32: the split
    walk's rows, the front instances' among them, are finite, not zero,
    and within K4_TOL_DEEP of ``rasterize_bwd_plain``. Both recover the
    front's log T from log T_final by some 600 f32 additions near -485,
    whose rounding alone moves a front T by a few 1e-4 in either
    version (the model with one group, the plain walk's order, agrees to
    4e-7); chip_smoke.py holds the full frame's deep stacks to the same
    1e-3."""
    from splatjax_torch.ops.rasterize import pack_table, rasterize_fwd_plain
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd_plain
    from splatjax_torch.ops.segreduce import unpack_bf16_pairs

    rng = np.random.default_rng(17)
    n = 600
    feat = np.zeros((n, 16), np.float32)
    feat[:, 0:2] = 4.0 + rng.uniform(-1.0, 1.0, (n, 2))   # near the centre
    feat[:, 2] = rng.uniform(0.01, 0.05, n)                # wide conics
    feat[:, 3] = rng.uniform(-0.005, 0.005, n)
    feat[:, 4] = rng.uniform(0.01, 0.05, n)
    feat[:, 5:8] = rng.uniform(0.0, 1.0, (n, 3))
    feat[:, 8] = rng.uniform(0.6, 0.95, n)
    feat[:, 9] = np.linspace(1.0, 5.0, n)
    rows = pack_table(torch.from_numpy(feat), packed16)
    cfg = TileConfig(8, 8, 8, 8)
    starts = torch.zeros(1, dtype=torch.int32)
    ends = torch.full((1,), n, dtype=torch.int32)
    out = rasterize_fwd_plain(rows, starts, ends, cfg, 0.999, 0.0,
                              packed16=packed16)
    assert float(out[0, 6].max()) < -100.0 and int(out[0, 4, 0]) == 5
    g_out = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (1, 8, cfg.pixels_per_tile)).astype(np.float32))
    got = _segmented_bwd(rows, starts, ends, out, g_out, cfg, 0.999, 4,
                         packed16)
    _assert_k4_close(got, rasterize_bwd_plain(
        rows, starts, ends, out, g_out, cfg, 0.999, packed16=packed16),
        packed16, K4_TOL_DEEP)
    front = unpack_bf16_pairs(got[:64]) if packed16 else got[:64]
    assert bool((front[:, :10] != 0).any(dim=1).all())


@pytest.mark.parametrize("packed16", (False, True))
@pytest.mark.parametrize("edge", (32, 64))
def test_k4_rows_split_over_sub_blocks(edge, packed16):
    """What the 32 and 64 px K4 clusters compute, on the plain version: an
    instance's gradient row is linear in the cotangent, so the row with
    ``g_out`` is the sum over the tile's 16x16 sub-blocks of the rows
    with ``g_out`` zeroed outside each, the blocks' partials that the
    cluster adds (32-byte rows, within K4_TOL of each channel's max: only
    the grouping of the pixel sums differs). Where an instance's support
    rectangle misses a sub-block, that sub-block's row is exactly zero, at
    both row widths: the block that skips the instance adds nothing."""
    from splatjax_torch.ops.rasterize import support_rect
    from splatjax_torch.ops.rasterize_vjp import rasterize_bwd_plain
    from splatjax_torch.ops.segreduce import unpack_bf16_pairs

    cfg, b, f, out, rows = _dense_case(edge, "fwd16" if packed16 else
                                       "fwd32")
    rng = np.random.default_rng(11)
    g_out = torch.from_numpy(rng.standard_normal(
        (cfg.num_tiles, 8, cfg.pixels_per_tile)).astype(np.float32))

    def grad(g):
        g = rasterize_bwd_plain(rows, b.starts, b.ends, out, g, cfg, 0.999,
                                packed16=packed16)
        return unpack_bf16_pairs(g) if packed16 else g

    full = grad(g_out)
    cols = edge // SUB
    pix = torch.arange(cfg.pixels_per_tile)
    sub_of_pixel = (pix // edge // SUB) * cols + pix % edge // SUB
    parts = [grad(g_out * (sub_of_pixel == k).float())
             for k in range(cols * cols)]
    if not packed16:
        scale = full.abs().amax(dim=0).clamp_min(1e-30)
        assert bool(((sum(parts) - full).abs() <= K4_TOL * scale).all())

    # instance k's tile and the sub-blocks its support rectangle misses
    skipped = nonzero = 0
    h = 0.5 * edge
    for t in range(cfg.num_tiles):
        k = torch.arange(int(b.starts[t]), int(b.ends[t]))
        ox = float((t % cfg.tiles_x) * edge) + h
        oy = float((t // cfg.tiles_x) * edge) + h
        x0, x1, y0, y1 = support_rect(
            f[0][k] - ox, f[1][k] - oy, f[2][k], f[3][k], f[4][k],
            f[8][k].clamp_min(1e-30).log(), edge)
        for sb in range(cols * cols):
            lo_x = (sb % cols) * SUB - h + 0.5
            lo_y = (sb // cols) * SUB - h + 0.5
            miss = (x0 > lo_x + SUB - 1) | (x1 < lo_x) \
                | (y0 > lo_y + SUB - 1) | (y1 < lo_y)
            assert bool((parts[sb][k[miss]] == 0).all())
            skipped += int(miss.sum())
            nonzero += int((parts[sb][k[~miss]] != 0).any(dim=1).sum())
    assert skipped > 0 and nonzero > 0
