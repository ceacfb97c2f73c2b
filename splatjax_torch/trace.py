"""Spans and counters of the port's layers, on the torch profiler's clock.

A span is a ``torch.profiler.record_function`` annotation around one call
of a layer (``sj.project``, ``sj.bin``, ``sj.gather``, ...). It lands in
the same Kineto trace as the kernel, copy and launch records, so a reader
of that trace can sum the device time of the kernels launched inside it.
A root span (``sj.frame``, ``sj.step``) also opens a :class:`Record`, into
which the layers' counters of that frame or step go.

There is no switch of its own: spans are made and counters kept only
while a torch profiler records on the calling thread. Without one a span
costs one flag test and returns a shared null context, and a counter
keeps nothing. To see them, wrap a render or train loop in
``torch.profiler.profile``, open its trace in Perfetto or TensorBoard, and
read :func:`records`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional

import torch

# True while a profiler records on this thread (the autograd engine's
# threads inherit it from the thread that runs the backward)
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
MAX_RECORDS = 4096
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
# per thread, as the profiler's flag is: the records of the roots being
# run on this thread, innermost last
_local = threading.local()
_made = 0               # records made so far, the next one's index


@dataclasses.dataclass
class Record:
    """The counters of one root span, or of counts made outside any root
    (``name`` None). ``values`` maps a counter to the values counted, as
    given: device tensors stay unreduced until :meth:`get` reads them."""

    name: Optional[str]
    index: int
    values: dict = dataclasses.field(default_factory=dict)

    def get(self, key: str) -> Optional[int]:
        """The sum of a counter's values, read to the host, or None if
        nothing was counted under ``key``."""
        vals = self.values.get(key)
        return None if vals is None else sum(int(v) for v in vals)


def _open() -> list:
    if not hasattr(_local, "open"):
        _local.open = []
    return _local.open


def _new_record(name: Optional[str]) -> Record:
    global _made
    rec = Record(name, _made)
    _made += 1
    _records.append(rec)
    return rec


def recording() -> bool:
    """True while a profiler records on the calling thread: a caller that
    would launch work only to count it tests this first."""
    return _recording()


def span(name: str):
    """A context manager that annotates its body as ``name`` while a
    profiler records."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _root(name: str):
    rec = _new_record(name)
    opened = _open()
    opened.append(rec)
    try:
        with torch.profiler.record_function(name, str(rec.index)):
            yield
    finally:
        opened.pop()


def root(name: str):
    """The span of one frame or step: its annotation's args hold the
    record's index (shown where the profiler records shapes), and the
    counters made inside it go into its record."""
    if not _recording():
        return _OFF
    return _root(name)


def count(**values) -> None:
    """Add ``values`` to the innermost open root's record on this thread
    (a record of its own outside any root), only while a profiler records.
    A tensor is kept as a copy of its own, unreduced: counting syncs
    nothing, and a kept record holds no buffer that the counted value
    views (a 0-d count taken from a cumulative sum would keep the sum)."""
    if not _recording():
        return
    opened = _open()
    rec = opened[-1] if opened else _new_record(None)
    for key, v in values.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().clone()
        rec.values.setdefault(key, []).append(v)


def records() -> list:
    """The kept records, oldest first (at most ``MAX_RECORDS``)."""
    return list(_records)
