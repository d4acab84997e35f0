"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by name (see
``harness.py``); its driver sets up, warms up, measures for ``--seconds``
and hands back what it measured; the reference then judges what the timed
path produced.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` the ``breakdown`` of the profiled stretch,
and last ``checks``: each compared number beside its limit, which also
close standard error.  Without a CUDA card, or with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, it prints no result
and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build caches at fixed paths inside the checkout: only a cell's first run
# in a checkout builds
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def fail(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return 2


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def per_sample_ms(ctx) -> dict:
    """Milliseconds a sample inside the profiled stretch and outside it: what
    the profiler costs the steps it records."""
    out = {}
    for key, seconds, samples in (("profiled", "stretch_s", "stretch_samples"),
                                  ("unprofiled", "untraced_s", "samples")):
        if ctx.get(samples):
            out[key] = ctx[seconds] * 1e3 / ctx[samples]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    try:
        cell = harness.resolve_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"the cell needs {cell.chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    # one host thread: torch's intra-op pool contends for the cores with the
    # thread that launches the kernels (see PERF.md)
    torch.set_num_threads(1)
    return measure(cell, args, torch.device("cuda", 0))


def measure(cell, args, device) -> int:
    """Everything of a run after the look for the card: the driver's set-up
    and window, the jax check, the metrics, the reference's judgement and
    the result's line."""
    import torch

    from benchmark import harness

    # float32 as the configurations state it: no TF32 in matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = harness.driver_module(cell.driver)
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace), device)

    ctx = result["ctx"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result["e2e"], setup_s=result["setup_end"] - T0,
                      peak_mem_gib=result["peak_bytes"] / 2**30)
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            # a device metric whose trace held no device operation
            return fail(f"end-to-end metrics not measured: {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    print(json.dumps({"card": device_name(device), "power_limit": power_limit(),
                      "peak_mem_gib": result["peak_bytes"] / 2**30,
                      "window_s": result["window_s"], "setup_s": result["setup_end"] - T0,
                      "stretch_s": ctx.get("stretch_s"),
                      "stretch_samples": ctx.get("stretch_samples"),
                      "ms_per_sample": per_sample_ms(ctx)}))

    readings = result["judge"]()
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in sorted(cell.limits.items())}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and result["failed"] == 0
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu", "kind": device_name(device),
                       "count": cell.chips, "memory_peak_bytes": result["peak_bytes"]}}
    trace = ctx.get("trace")
    if args.trace:
        if trace:
            line["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
            line["breakdown"] = {"device_ops": trace["device_ops"],
                                 "idle_gaps": trace["idle_gaps"]}
        else:
            line["device"].update(busy_s=0.0, window_s=0.0)
    line["checks"] = checks
    loaded = harness.forbidden_loaded()
    if loaded:
        return fail(f"modules loaded that the benchmark may not hold: {loaded}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
