"""Profiling and tracing: one recorder of spans and counters.

The port's copy of ``efficientlo_net_tpu/utils/profiling.py``, on
``torch.profiler``.

* ``span(name, id=None)`` marks a region of the host's work.  Recording is
  on while ``torch.profiler`` records (any profile, whatever its
  activities) and after ``enable()``; a span is recorded if recording was
  on when it opened.  Off, ``span`` reads the two flags and returns one
  shared object that does nothing: no clock, no allocation, no
  ``record_function``.  On, it keeps in memory the span's name, its start
  and end on ``time.time_ns()`` (the clock of ``torch.profiler``'s events:
  nanoseconds since the Unix epoch), its parent (the innermost span open on
  the same thread), its thread and a request id (its ``id``, else its
  parent's: a root span's id reaches every child), and it enters
  ``torch.profiler.record_function(name)``, so that a trace that records
  the CPU shows the span on its timeline.  The newest ``MAX_SPANS`` spans
  are kept; the counter ``spans_dropped`` counts the older ones let go.
  While ``torch.export`` or ``torch.compile`` traces, spans record nothing.
* ``count(name, n=1)`` adds to a total in every state; while recording, it
  also files the count under the innermost open span of its thread.
* ``spans()``, ``counters()`` read the recorder; ``reset()`` clears it.
* ``trace`` profiles a block and writes its Chrome trace (viewable in
  Perfetto, ``chrome://tracing`` or TensorBoard's profile plugin).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

MAX_SPANS = 1 << 16
DROPPED = "spans_dropped"

_forced = False  # enable()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, int] = {}
_counting = threading.Lock()
_local = threading.local()


class Span:
    """One recorded region: ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``), ``parent`` (a ``Span`` or None), ``thread``
    (``threading.get_ident()``), ``id`` and ``counts`` (the ``count`` calls
    made inside it and outside its children, or None)."""

    __slots__ = ("name", "id", "start_ns", "end_ns", "parent", "thread", "counts", "_rf")

    def __init__(self, name: str, id=None):
        self.name, self.id = name, id
        self.start_ns = self.end_ns = 0
        self.counts: Optional[Dict[str, int]] = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        self.thread = threading.get_ident()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        if len(_spans) == MAX_SPANS:
            _add(DROPPED, 1)
        _spans.append(self)


class _Off:
    """The shared span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, id=None):
    """A context manager over a region named ``name``; ``id`` names the
    request it serves (a step, a batch, a scan)."""
    if not (_forced or _torch_profiler._is_profiler_enabled):
        return OFF
    if torch.compiler.is_compiling():
        return OFF
    return Span(name, id)


def _add(name: str, n: int) -> None:
    with _counting:
        _counters[name] = _counters.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and while recording to the
    innermost open span's counts."""
    _add(name, n)
    if _forced or _torch_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n


def enable(on: bool = True) -> None:
    """Record spans whether or not ``torch.profiler`` records."""
    global _forced
    _forced = on


def spans() -> List[Span]:
    """The recorded spans, oldest first, each appended as it closed."""
    return list(_spans)


def counters() -> Dict[str, int]:
    with _counting:
        return dict(_counters)


def reset(*names: str) -> None:
    """Zero the counters ``names``; with none, clear the recorder: every
    span and every counter."""
    with _counting:
        if names:
            for name in names:
                _counters.pop(name, None)
            return
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU operators and spans, and CUDA kernels
    when a card is present) and write its Chrome trace into ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``.  Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum the block's
    operators."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
