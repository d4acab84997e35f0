"""Spans of the program's own recorder (``efficientlo_net_torch.utils.
profiling``), read by the per-layer metrics of the host's time.

Recording is on while ``torch.profiler`` records, so in a traced run the
recorder holds the spans of the profiled stretch alone: a span is kept if
it opened while the profiler ran.  The program is imported inside these
functions only; a program without the recorder's ``spans`` gives nothing
to read, and every function then returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def durations_ms(name: str) -> List[float]:
    """Host milliseconds of every recorded span named ``name``."""
    try:
        from efficientlo_net_torch.utils.profiling import spans
    except ImportError:
        return []
    return [(s.end_ns - s.start_ns) * 1e-6 for s in spans() if s.name == name]


def mean_ms(ctx: Dict, kind: str, name: str) -> Optional[float]:
    """Mean host milliseconds of the spans ``name`` in a run of ``kind``."""
    times = durations_ms(name) if ctx.get("kind") == kind else []
    return statistics.fmean(times) if times else None


def host_us_per_kernel(ctx: Dict, kind: str, names) -> Optional[float]:
    """Host microseconds a step or batch, the summed means of the spans
    ``names``, over the CUDA kernels a step or batch of the profiled
    stretch."""
    trace = ctx.get("trace") if ctx.get("kind") == kind else None
    if not trace or not trace["kernels"]:
        return None
    means = [mean_ms(ctx, kind, name) for name in names]
    if None in means:
        return None
    return sum(means) * 1e3 / (trace["kernels"] / trace["steps"])
