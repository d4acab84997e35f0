"""The harness's data model and its measuring pieces.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root
of the checkout names the cell's configuration, traffic mix and metrics;
``configs/<config>.json`` holds the configuration, ``traffic/<mix>.json``
the mix and the driver that runs it (``drivers/<driver>.py``),
``limits/<workload>.json`` the limits of the numbers the cell compares with
the reference, and ``layer_metrics/<metric>.py`` the reader of each
per-layer metric.  This module imports neither torch nor the program at
import time, so the CPU tests can load it anywhere.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no process of the benchmark may hold: the JAX
#: package the program was ported from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "efficientlo_net_tpu")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files resolved."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve_cell(name: str, spec: Optional[Dict] = None, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration, traffic, limits and the
    metrics it reports; raises KeyError for an unknown workload and
    FileNotFoundError for a file that is not there."""
    spec = spec or benchmark_spec(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def load_file_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (metric names hold
    dots, so their readers are loaded by path, not by import)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_module(name: str):
    return load_file_module(HERE / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """``read(ctx)`` of ``layer_metrics/<name>.py``: the metric's value from
    the run's spans, counters and trace, or None where it finds nothing."""
    return load_file_module(HERE / "layer_metrics" / f"{name}.py",
                            "benchmark_metric_" + name.replace(".", "_")).read


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of ``sys.modules`` that are forbidden, compared
    whole (``efficientlo_net_torch`` is not ``efficientlo_net_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics (numpy's
    default)."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---- the device trace ------------------------------------------------------------

def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _with_op(call: str, op: Optional[str]) -> str:
    return f"{call}: {op}" if op else call


def reduce_trace(events: List[Dict], steps: int, window_s: float) -> Optional[Dict]:
    """Reduce a Chrome trace's events (``torch.profiler``'s export) of a
    profiled stretch of ``steps`` steps or batches, whose window, the host
    seconds between the device's synchronisations at both ends, is
    ``window_s``: every device operation in the trace lies in it.  Busy
    time is the union of the intervals of the device's operations, kernels,
    copies and fills (``chip_smoke.py::busy_share`` takes the kernels
    alone); ``kernels`` counts the kernels.  Each idle gap between them is
    named by the innermost host call running at its start, where the trace
    holds one (with the device operation that call issued, as a copy that
    waits for the device does), else by the device operation that ends it.  Returns None
    when the trace holds no device operation.  Times in seconds."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in device)
    if not ops or steps <= 0 or window_s <= 0.0:
        return None
    busy = _merged([(a, b) for a, b, _ in ops])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    first_at = {}
    for a, _, n in ops:
        first_at.setdefault(a, n)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    launched = {e["args"]["correlation"]: e["name"] for e in device
                if "correlation" in e.get("args", {})}
    host = [(e["ts"], e["ts"] + e.get("dur", 0),
             _with_op(e["name"], launched.get(e.get("args", {}).get("correlation"))))
            for e in events if e.get("cat") in HOST_CATEGORIES]

    def name(gap):
        """The innermost host call running at the gap's start (with the
        device operation it issued), or the device operation after it."""
        live = [(a, n) for a, b, n in host if a <= gap[0] < b]
        return max(live)[1] if live else f"before {first_at[gap[1]]}"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_us * 1e-6,
        "steps": steps,
        "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
        "kernel_s_by_name": {n: t * 1e-6 for n, t in by_name.items()},
        "device_ops": [[n, t * 1e-6] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[name(g), (g[1] - g[0]) * 1e-6] for g in longest],
    }


def busy_seconds(ops) -> Optional[float]:
    """Seconds in which a device operation ran: the union of the intervals
    of ``ops``, (start, end, name) in microseconds.  Host-to-device copies
    after the last kernel are left out: they are the inputs of a batch that
    the window closed before it ran.  None where ``ops`` holds no kernel."""
    ops = sorted(ops)
    kernels = [i for i, (_, _, n) in enumerate(ops) if not n.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    last = ops[kernels[-1]][0]
    kept = [(a, b) for a, b, n in ops if a <= last or "HtoD" not in n]
    return sum(b - a for a, b in _merged(kept)) * 1e-6


def read_trace_file(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]
