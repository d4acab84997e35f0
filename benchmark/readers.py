"""Arithmetic shared by the per-layer metric readers in ``layer_metrics/``.

A reader gets the run's context: ``kind`` ("train" or "eval"), the CUDA
event times of the entry's stages (``stage_ms``), the reduced device trace
of the profiled stretch (``trace``, ``harness.reduce_trace``), the select
bound of one step or batch and the dense-product operations of one sample
from ``counts/``, the samples and seconds of the window outside the
profiled stretch, and in eval the latencies of the batches outside it.  A reader returns None where it finds nothing to read.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from .harness import F32_FLOPS_PER_S, p95

SELECT_KERNELS = ("window_select_kernel", "select_and_group_kernel")


def stage_ms(ctx: Dict, kind: str, stage: str) -> Optional[float]:
    """Mean CUDA-event time of one stage over the window's steps."""
    times = (ctx.get("stage_ms") or {}).get(stage) if ctx.get("kind") == kind else None
    return statistics.fmean(times) if times else None


def kernels_per_step(ctx: Dict, kind: str) -> Optional[float]:
    trace = ctx.get("trace") if ctx.get("kind") == kind else None
    if not trace or not trace["kernels"]:
        return None
    return trace["kernels"] / trace["steps"]


def select_roofline(ctx: Dict, kind: str) -> Optional[float]:
    """The select kernels' least time from ``counts/`` over their summed
    device time in the profiled stretch, in %."""
    trace = ctx.get("trace") if ctx.get("kind") == kind else None
    if not trace:
        return None
    seconds = sum(t for name, t in trace["kernel_s_by_name"].items()
                  if any(k in name for k in SELECT_KERNELS))
    if seconds <= 0.0:
        return None
    return 100.0 * ctx["select_bound_s"] * trace["steps"] / seconds


def mfu(ctx: Dict, kind: str) -> Optional[float]:
    """Dense-product operations of the window's samples over its seconds,
    against the card's float32 peak, in %."""
    if ctx.get("kind") != kind or not ctx.get("samples") or not ctx.get("untraced_s"):
        return None
    return 100.0 * ctx["flops_per_sample"] * ctx["samples"] / ctx["untraced_s"] / F32_FLOPS_PER_S


def device_idle(ctx: Dict, kind: str) -> Optional[float]:
    trace = ctx.get("trace") if ctx.get("kind") == kind else None
    if not trace or trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def host_rate(ctx: Dict, kind: str) -> Optional[float]:
    """Samples a second on the host's clock, outside the profiled stretch."""
    if ctx.get("kind") != kind or not ctx.get("samples") or not ctx.get("untraced_s"):
        return None
    return ctx["samples"] / ctx["untraced_s"]


def host_tail(ctx: Dict, kind: str) -> Optional[float]:
    """95th percentile of the batches' latencies outside the profiled stretch."""
    latencies = ctx.get("latency_ms") if ctx.get("kind") == kind else None
    return p95(latencies) if latencies else None
