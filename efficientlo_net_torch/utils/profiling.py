"""Profiling and tracing.

The port's copy of ``efficientlo_net_tpu/utils/profiling.py``, on
``torch.profiler``: ``trace`` records the host's operators and, where a
card is present, its kernels and copies, and writes a Chrome trace
(viewable in Perfetto, ``chrome://tracing`` or TensorBoard's profile
plugin); ``StepTimer`` times steps on the host's clock, waiting for the
card first; ``annotate`` names a region in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU operators, and CUDA kernels when a
    card is present) and write its Chrome trace into ``log_dir`` as
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


class StepTimer:
    """Host-clock step timing that waits for the card: work on a CUDA
    device is only queued when a call returns."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.history = []

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync: Optional[torch.Tensor] = None) -> float:
        """Seconds since ``start``, after synchronising ``sync``'s CUDA
        device when given a CUDA tensor; appended to ``history``."""
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - self._t0
        self.history.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.history) / max(len(self.history), 1)


def annotate(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
