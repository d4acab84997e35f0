"""The profiled stretch of a traced run, the profile of an untraced
run's whole window, and the CUDA-event stage timer.

A traced run profiles only a short stretch of its window, so that its rate
stays near the untraced one: ``Stretch`` starts ``torch.profiler`` at the
first step boundary past half the window, keeps it on for the next
``count`` steps or batches, stops, and reduces the Chrome trace (written to
a temporary directory, then deleted) with ``harness.reduce_trace``; the
host seconds that stopping and reducing take are kept apart
(``overhead_s``), so the window's rate outside the stretch leaves them out.
``WindowProfile`` records the device's activity over a whole untraced
window, for a metric of the device's busy time.  The profiler records the
device's activity alone (kernels, copies, fills and the CUDA runtime calls
that launch them), not every host operator, so the profiled steps run at
nearly the pace of the others.  The device is
synchronised at both ends; the host seconds between them are the
stretch's window, and they and the stretch's samples are kept, so the rate
outside it can be taken apart."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from . import harness


def activities():
    """What the profiler records: the device's activity alone."""
    import torch

    return [torch.profiler.ProfilerActivity.CUDA]


class Stretch:
    def __init__(self, enabled: bool, count: int, start_at: float):
        self.enabled, self.count, self.start_at = enabled, count, start_at
        self.prof = None
        self.done = 0
        self.seconds = 0.0
        self.samples = 0
        self.overhead_s = 0.0
        self.trace: Optional[Dict] = None
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        return self.prof is not None

    def begin_step(self) -> None:
        """At the start of a step or batch: open the profiler when the time
        has come."""
        import torch

        if not self.enabled or self.prof is not None or self.done >= self.count \
                or time.perf_counter() < self.start_at:
            return
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=activities())
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def end_step(self, samples: int) -> None:
        """At the end of a step or batch: count it, and close the profiler
        after the last of the stretch."""
        import torch

        if self.prof is None:
            return
        self.done += 1
        self.samples += samples
        if self.done < self.count:
            return
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.seconds = t1 - self._t0
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.trace = harness.reduce_trace(harness.read_trace_file(path), self.done,
                                              self.seconds)
        self.prof = None
        self.overhead_s = time.perf_counter() - t1

    def outside(self, window_s: float) -> float:
        """The host seconds of a window of ``window_s`` outside the stretch
        and outside its stopping and reducing."""
        return window_s - self.seconds - self.overhead_s


def device_ops(prof) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every device operation (kernel, copy, fill)
    that ``prof`` recorded, times in microseconds, read from the profiler's
    own results without a trace file."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns() * 1e-3
            out.append((start, start + e.duration_ns() * 1e-3, e.name()))
    return out


class WindowProfile:
    """The device's activity over a whole window: ``start`` before the
    window opens (in set-up), ``stop`` once all its work has finished.
    ``busy_s`` is then the seconds in which a device operation ran
    (``harness.busy_seconds``), None where none was recorded."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.busy_s: Optional[float] = None
        self.ops = 0
        self.stop_s: Dict[str, float] = {}

    def start(self) -> None:
        import torch

        if self.enabled:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=activities())
            self.prof.__enter__()

    def stop(self) -> None:
        import torch

        if self.prof is None:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        ops = device_ops(self.prof)
        self.prof = None
        self.ops = len(ops)
        self.busy_s = harness.busy_seconds(ops)
        self.stop_s = {"profiler": t1 - t0, "reduce": time.perf_counter() - t1}


class StageTimer:
    """CUDA events at named marks of each timed step; ``ms`` gives, per
    stage, the time from the previous mark to its own, one entry a step.
    Marks count only between ``start`` and ``stop``: a step left unstarted
    (one in the profiled stretch) leaves no entry, and its marks fall into
    no other step's."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.steps: List[Dict] = []
        self.open = False

    def start(self) -> None:
        if self.enabled:
            self.steps.append({})
            self.open = True
            self.mark("start")

    def stop(self) -> None:
        self.open = False

    def mark(self, name: str) -> None:
        import torch

        if self.open:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.steps[-1][name] = ev

    def ms(self) -> Dict[str, List[float]]:
        import torch

        torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for marks in self.steps:
            names = list(marks)
            for a, b in zip(names, names[1:]):
                out.setdefault(b, []).append(marks[a].elapsed_time(marks[b]))
        return out
