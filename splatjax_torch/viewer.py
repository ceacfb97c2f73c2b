"""High-level scene API (PyTorch port of ``splatjax/viewer.py``): the
reference component's few knobs (src, cutout, pixelRatio, xrPixelRatio)
over the tiled pipeline.

    renderer = SplatRenderer(src="scene.splat", pixel_ratio=0.5)
    img = renderer.render(make_camera((0, 0, 3), (0, 0, 0),
                                      width=1920, height=1080))

``src`` is a path or a ``file://`` or ``http(s)://`` URL, streamed with
progress events. :meth:`SplatRenderer.feed` and
:meth:`SplatRenderer.from_stream` ingest .splat bytes progressively, as the
viewer's streaming loader does. ``resort_interval > 1`` redraws against a
tile index rebuilt every that many frames (the reference viewer drawing
with the worker's previous sort order).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Optional

import torch

from splatjax_torch import trace
from splatjax_torch.camera import Camera
from splatjax_torch.device import resolve_device
from splatjax_torch.io.ply_format import parse_ply_bytes
from splatjax_torch.io.splat_format import ROW_LENGTH, parse_splat_bytes
from splatjax_torch.io.stream import stream_chunks
from splatjax_torch.render import (
    _scale_camera,
    bin_scene,
    render,
    render_binned,
)
from splatjax_torch.scene import GaussianScene

# The viewer caps its texture at MAX_TEXTURE_SIZE^2 splats; excess rows are
# truncated.
DEFAULT_MAX_SPLATS = 16384 * 16384


def _concat_scenes(parts: list[GaussianScene]) -> GaussianScene:
    if len(parts) == 1:
        return parts[0]
    return GaussianScene(
        means=torch.cat([p.means for p in parts]),
        scales=torch.cat([p.scales for p in parts]),
        quats=torch.cat([p.quats for p in parts]),
        colors=torch.cat([p.colors for p in parts]),
        opacities=torch.cat([p.opacities for p in parts]),
    )


def _truncate(scene: GaussianScene, n: int) -> GaussianScene:
    return GaussianScene(**{
        f.name: None if getattr(scene, f.name) is None
        else getattr(scene, f.name)[:n]
        for f in dataclasses.fields(scene)
    })


@dataclasses.dataclass
class SplatRenderer:
    """Load-and-render surface mirroring the reference component schema.

    Args:
      src: a .splat or .ply asset, as a path or a ``file://`` or
        ``http(s)://`` URL. A .ply (the extension tested without any
        ``?query``) is read whole and converted; a .splat is fed chunk by
        chunk as it arrives.
      scene: alternatively, an in-memory GaussianScene.
      cutout: optional (4, 4) world -> unit-box matrix.
      pixel_ratio: resolution scale of render calls (0.5 renders at half
        resolution; the returned image is simply smaller).
      xr_pixel_ratio: the scale used by ``render(..., xr=True)``.
      max_splats: truncation like the viewer's texture capacity.
      capacity / alpha_clip / early_stop / viewer_exact / tile_size /
        feature_bytes / background: see
        :func:`splatjax_torch.render.render`.
      progress: optional callback taking each
        :class:`splatjax_torch.io.stream.StreamProgress` of a ``src``
        load, the last one with ``done=True``.
      resort_interval: 1 renders the exact per-frame sort; N > 1 rebuilds
        a cached tile index (``bin_scene(cache_params=True)``) every N
        frames and whenever the scene object, the viewport or the tile
        edge changes, and redraws the frames between with
        ``render_binned`` (16-byte rows: one K3 launch per frame).
      device: where a ``src`` or ``feed()`` scene is loaded.
    """

    src: Optional[str] = None
    scene: Optional[GaussianScene] = None
    cutout: Optional[object] = None
    pixel_ratio: float = 1.0
    xr_pixel_ratio: float = 0.5
    max_splats: int = DEFAULT_MAX_SPLATS
    capacity: Optional[int] = None
    alpha_clip: object = "auto"
    early_stop: float = 1e-4
    viewer_exact: bool = False
    feature_bytes: object = "auto"
    tile_size: int = 16
    background: Optional[object] = None
    progress: Optional[object] = None
    resort_interval: int = 1
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._pending = b""
        self._parts: list[GaussianScene] = []
        self._fed = 0
        self._bins = None             # cached tile index (resort_interval>1)
        self._bins_key = None         # (scene object, width, height, tile)
        self._frames_since_sort = 0
        if self.src is not None:
            chunks = stream_chunks(self.src, progress=self.progress)
            if str(self.src).split("?")[0].endswith(".ply"):
                self.scene = parse_ply_bytes(b"".join(chunks),
                                             device=self.device)
            else:
                for chunk in chunks:
                    self.feed(chunk)
                self._materialize()
        if self.scene is not None and \
                self.scene.num_gaussians > self.max_splats:
            self.scene = _truncate(self.scene, self.max_splats)

    # -- progressive ingest ------------------------------------------------
    def feed(self, chunk: bytes) -> int:
        """Push raw .splat bytes; returns splats loaded so far. Bytes past
        ``max_splats`` are discarded unparsed."""
        base = self.scene.num_gaussians if self.scene is not None else 0
        budget = self.max_splats - base - self._fed
        if budget <= 0:
            return base + self._fed
        self._pending += chunk
        n_rows = min(len(self._pending) // ROW_LENGTH, budget)
        if n_rows:
            whole = self._pending[: n_rows * ROW_LENGTH]
            self._pending = self._pending[n_rows * ROW_LENGTH:]
            self._parts.append(parse_splat_bytes(whole, self.device))
            self._fed += n_rows
        return base + self._fed

    def _materialize(self) -> None:
        if not self._parts:
            return
        parts = ([self.scene] if self.scene is not None else []) + self._parts
        self.scene = _concat_scenes(parts)
        self._parts = []
        self._fed = 0

    @classmethod
    def from_stream(cls, chunks: Iterable[bytes], **kw) -> "SplatRenderer":
        """A renderer fed the .splat byte ``chunks`` (for example
        :func:`splatjax_torch.io.stream.stream_chunks` of a URL);
        ``kw`` are the dataclass fields."""
        r = cls(**kw)
        for c in chunks:
            r.feed(c)
        return r

    # -- rendering -----------------------------------------------------------
    def render(self, camera: Camera, xr: bool = False, **overrides):
        """Render; ``xr=True`` applies ``xr_pixel_ratio`` instead of
        ``pixel_ratio``. ``overrides`` are passed on to
        :func:`splatjax_torch.render.render` and force the exact per-frame
        path (with a warning when ``resort_interval > 1``)."""
        with trace.root("sj.frame"):
            self._materialize()
            if self.scene is None or self.scene.num_gaussians == 0:
                raise ValueError("no scene loaded (src/scene/feed)")
            camera = _scale_camera(
                camera, self.xr_pixel_ratio if xr else self.pixel_ratio)
            if self.resort_interval > 1:
                if not overrides:
                    return self._render_stale_order(camera)
                # the cached tile index cannot honour arbitrary render() kwargs
                warnings.warn(
                    "SplatRenderer.render(**overrides) bypasses the cached "
                    "stale-order tile index (resort_interval ignored): "
                    f"exact per-frame sort used for {sorted(overrides)}",
                    stacklevel=2,
                )
            kw = dict(
                tile_size=self.tile_size,
                capacity=self.capacity,
                alpha_clip=self.alpha_clip,
                early_stop=self.early_stop,
                viewer_exact=self.viewer_exact,
                feature_bytes=self.feature_bytes,
                cutout=self.cutout,
                background=self.background,
            )
            kw.update(overrides)
            return render(self.scene, camera, **kw)

    def _render_stale_order(self, camera: Camera):
        """A frame against a possibly stale tile index, rebuilt every
        ``resort_interval`` frames and whenever the scene, the viewport or
        the tile edge changes; projection and shading are always the
        frame's own."""
        # the key holds the scene object itself (compared with `is`), not
        # its id(), which can be reused once the object is freed; feed()
        # always builds a new scene object. The tile edge is in it too, so
        # a changed tile_size rebuilds the index
        key = (self.scene, camera.width, camera.height, self.tile_size)
        if (
            self._bins is None
            or self._bins_key[0] is not key[0]
            or self._bins_key[1:] != key[1:]
            or self._frames_since_sort >= self.resort_interval
        ):
            self._bins = bin_scene(
                self.scene, camera, tile_size=self.tile_size,
                capacity=self.capacity,
                viewer_exact=self.viewer_exact, cutout=self.cutout,
                early_stop=self.early_stop, cache_params=True,
            )
            self._bins_key = key
            self._frames_since_sort = 0
        self._frames_since_sort += 1
        return render_binned(
            self.scene, camera, self._bins, tile_size=self.tile_size,
            alpha_clip=self.alpha_clip,
            early_stop=self.early_stop, viewer_exact=self.viewer_exact,
            feature_bytes=self.feature_bytes, cutout=self.cutout,
            background=self.background,
        )
