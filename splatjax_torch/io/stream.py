"""Streaming asset fetch with progress reporting (the port's own copy of
``splatjax/io/stream.py``).

The reference viewer streams its ``src`` with ``fetch``, logging percent
and Mbps as chunks arrive, and pushes whole 32-byte rows into its buffers
while the download is in flight. This module does the same for local
paths, file objects, and ``file://`` and ``http(s)://`` URLs (``urllib``):

    from splatjax_torch.io.stream import stream_chunks

    for chunk in stream_chunks("https://host/scene.splat",
                               progress=lambda p: print(p)):
        renderer.feed(chunk)

Progress events carry bytes so far, the total from Content-Length (or the
file size) when known, and Mbps.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator, Optional

DEFAULT_CHUNK = 256 * 1024


@dataclasses.dataclass(frozen=True)
class StreamProgress:
    """One progress sample: the viewer's '<pct>% <mbps> Mbps' log line."""

    bytes_read: int
    total_bytes: Optional[int]      # None when the length is unknown
    seconds: float
    done: bool = False

    @property
    def fraction(self) -> Optional[float]:
        if not self.total_bytes:
            return None
        return self.bytes_read / self.total_bytes

    @property
    def mbps(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.bytes_read * 8 / self.seconds / 1e6

    def __str__(self) -> str:
        pct = (f"{100 * self.fraction:.0f}%" if self.fraction is not None
               else f"{self.bytes_read} B")
        return f"{pct} {self.mbps:.2f} Mbps"


def _open_source(src):
    """-> (readable, total_bytes or None, closer)."""
    if hasattr(src, "read"):
        total = None
        try:
            pos = src.tell()
            src.seek(0, os.SEEK_END)
            total = src.tell() - pos
            src.seek(pos)
        except (OSError, ValueError, AttributeError):
            pass
        return src, total, lambda: None
    s = str(src)
    if s.startswith(("http://", "https://", "file://")):
        # urllib streams the body; Content-Length drives the fraction
        from urllib.request import urlopen

        resp = urlopen(s)
        cl = resp.headers.get("Content-Length")
        total = int(cl) if cl else None
        return resp, total, resp.close
    f = open(s, "rb")
    total = os.fstat(f.fileno()).st_size
    return f, total, f.close


def stream_chunks(
    src,
    chunk_size: int = DEFAULT_CHUNK,
    progress: Optional[Callable[[StreamProgress], None]] = None,
) -> Iterator[bytes]:
    """Yield byte chunks from a path, URL or file object, reporting
    progress after each chunk and a final ``done=True`` event."""
    reader, total, close = _open_source(src)
    read = 0
    t0 = time.perf_counter()
    try:
        while True:
            chunk = reader.read(chunk_size)
            if not chunk:
                break
            read += len(chunk)
            if progress is not None:
                progress(StreamProgress(read, total,
                                        time.perf_counter() - t0))
            yield chunk
    finally:
        close()
    if progress is not None:
        progress(StreamProgress(read, total, time.perf_counter() - t0,
                                done=True))
