"""Port parity, streamed assets: ``stream_chunks`` and ``StreamProgress``
over a path, a file object and a ``file://`` URL, ``StreamingSplatReader``
over ragged chunks, ``synthetic_splat_bytes``, ``SplatRenderer(src=...,
progress=...)`` and ``SplatRenderer.from_stream``, and the convert CLI,
each against splatjax's on the same bytes (bit-equal scenes and bytes, the
same progress events but for their clocks). No test reaches the network:
an ``http(s)://`` source is only named, with ``stream_chunks`` replaced.
"""
import os

import numpy as np
import pytest
import torch

import splatjax.io as jio
from splatjax.io.stream import stream_chunks as j_stream
from splatjax.tools import convert as j_convert
from splatjax.viewer import SplatRenderer as JRenderer

import splatjax_torch.io as tio
from splatjax_torch import SplatRenderer, make_camera, viewer
from splatjax_torch.io.stream import (
    DEFAULT_CHUNK, StreamProgress, stream_chunks,
)
from splatjax_torch.render import render
from splatjax_torch.tools import convert as t_convert

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("means", "scales", "quats", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_equal(t_scene, j_scene):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t_scene, f).numpy(),
                                      np.asarray(getattr(j_scene, f)),
                                      err_msg=f)
    if j_scene.sh is None:
        assert t_scene.sh is None
    else:
        np.testing.assert_array_equal(t_scene.sh.numpy(),
                                      np.asarray(j_scene.sh))


def _events(events):
    return [(e.bytes_read, e.total_bytes, e.done, e.fraction)
            for e in events]


@pytest.fixture(scope="module")
def splat_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "scene.splat"
    path.write_bytes(jio.synthetic_splat_bytes(100, seed=3))
    return path


class _NoSeek:
    def __init__(self, f):
        self._f = f

    def read(self, n):
        return self._f.read(n)


@pytest.mark.parametrize("kind", ["path", "file", "no_seek", "file_url"])
def test_stream_chunks_same_events(splat_path, kind):
    """The same chunks and the same progress sequence as splatjax's."""
    out = {}
    for name, fn in (("t", stream_chunks), ("j", j_stream)):
        events = []
        if kind in ("file", "no_seek"):
            with open(splat_path, "rb") as f:
                src = f if kind == "file" else _NoSeek(f)
                chunks = list(fn(src, chunk_size=640,
                                 progress=events.append))
        else:
            src = splat_path.as_uri() if kind == "file_url" \
                else str(splat_path)
            chunks = list(fn(src, chunk_size=640, progress=events.append))
        out[name] = (chunks, _events(events))
    assert out["t"] == out["j"]
    chunks, events = out["t"]
    assert b"".join(chunks) == splat_path.read_bytes()
    assert events[-1][2] and events[-1][0] == 3200
    total = None if kind == "no_seek" else 3200
    assert all(e[1] == total for e in events)


def test_progress_event_math_and_text():
    e = StreamProgress(bytes_read=5_000_000, total_bytes=10_000_000,
                       seconds=2.0)
    assert e.fraction == 0.5 and abs(e.mbps - 20.0) < 1e-9
    assert str(e) == "50% 20.00 Mbps"
    unknown = StreamProgress(bytes_read=640, total_bytes=None, seconds=0.0)
    assert unknown.fraction is None and unknown.mbps == 0.0
    assert str(unknown) == "640 B 0.00 Mbps"
    assert DEFAULT_CHUNK == 256 * 1024


def test_streaming_reader_ragged_chunks():
    data = jio.synthetic_splat_bytes(100, seed=1)
    t_reader = tio.StreamingSplatReader(device="cpu")
    j_reader = jio.StreamingSplatReader()
    sizes = [1, 31, 33, 777, 5, 64, 2000, 3200]
    pos = 0
    for size in sizes:
        chunk = data[pos:pos + size]
        pos += size
        got, want = t_reader.feed(chunk), j_reader.feed(chunk)
        assert (got is None) == (want is None)
        if got is not None:
            _assert_equal(got, want)
        assert t_reader.rows_emitted == j_reader.rows_emitted
    assert t_reader.rows_emitted == 100


def test_synthetic_splat_bytes_equal():
    for n, seed in ((1, 0), (257, 12)):
        assert tio.synthetic_splat_bytes(n, seed) == \
            jio.synthetic_splat_bytes(n, seed)


@pytest.mark.parametrize("asset", ["trained_scene.ply",
                                   "trained_scene.splat"])
def test_renderer_src_file_url_with_progress(asset):
    path = os.path.join(FIXTURES, asset)
    url = "file://" + os.path.abspath(path)
    t_events, j_events = [], []
    t = SplatRenderer(src=url, progress=t_events.append, device="cpu")
    j = JRenderer(src=url, progress=j_events.append)
    _assert_equal(t.scene, j.scene)
    assert _events(t_events) == _events(j_events)
    assert t_events[-1].done
    assert t_events[-1].bytes_read == os.path.getsize(path)
    # a path gives the same scene
    _assert_equal(SplatRenderer(src=path, device="cpu").scene, j.scene)


def test_renderer_ply_frame_equals_render():
    path = os.path.join(FIXTURES, "trained_scene.ply")
    r = SplatRenderer(src=path, device="cpu", max_splats=1500)
    cam = make_camera((0.0, 0.0, 2.5), (0, 0, 0), width=48, height=32,
                      device="cpu")
    scene = tio.load_ply(path, backend="numpy", device="cpu")
    assert r.scene.num_gaussians == 1500
    want = render(viewer._truncate(scene, 1500), cam)
    assert torch.equal(r.render(cam), want)
    assert float(want[..., 3].max()) > 0.1


def test_renderer_url_query_is_stripped(monkeypatch):
    """The extension is tested without the URL's ``?query``: such a .ply
    is parsed whole (``stream_chunks`` stands in for the download)."""
    path = os.path.join(FIXTURES, "trained_scene.ply")
    url = "https://assets.example/scene.ply?v=3"
    seen = []

    def fake(src, chunk_size=DEFAULT_CHUNK, progress=None):
        seen.append(src)
        return stream_chunks(path, chunk_size, progress)

    monkeypatch.setattr(viewer, "stream_chunks", fake)
    events = []
    r = SplatRenderer(src=url, progress=events.append, device="cpu")
    assert seen == [url] and events[-1].done
    _assert_equal(r.scene, jio.load_ply(path, backend="numpy"))


def test_from_stream_matches_splatjax(splat_path):
    t = SplatRenderer.from_stream(
        stream_chunks(splat_path, chunk_size=700), device="cpu",
        max_splats=73)
    j = JRenderer.from_stream(j_stream(str(splat_path), chunk_size=700),
                              max_splats=73)
    t._materialize()
    j._materialize()
    assert t.scene.num_gaussians == 73
    _assert_equal(t.scene, j.scene)


@pytest.mark.parametrize("flags", [[], ["--no-importance-sort",
                                        "--max-sh-degree", "1"]])
def test_convert_cli_round_trip(tmp_path, flags, capsys, monkeypatch):
    """ply -> splat -> ply: the port's files equal splatjax's. The port
    reads a .ply with NumPy, the semantics of record; splatjax's "auto"
    would take its native converter whenever another test has built it,
    so the reference is held to NumPy here."""
    from splatjax.io import native as j_native

    monkeypatch.setattr(j_native, "available", lambda: False)
    src = os.path.join(FIXTURES, "trained_scene.ply")
    out = {}
    for name, mod in (("t", t_convert), ("j", j_convert)):
        splat, ply = tmp_path / f"{name}.splat", tmp_path / f"{name}.ply"
        assert mod.main([src, str(splat), *flags]) == 0
        assert mod.main([str(splat), str(ply)]) == 0
        out[name] = (splat.read_bytes(), ply.read_bytes())
    assert out["t"] == out["j"]
    assert t_convert.main([src, str(tmp_path / "x.obj")]) == 2
    assert "unsupported output" in capsys.readouterr().err
