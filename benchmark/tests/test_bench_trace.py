"""The reduction of a Chrome trace (busy share, kernels, top operations and
idle gaps) on hand-made traces, and the statistics helpers."""

import pytest

from benchmark import harness, readers


def _trace():
    """A stretch of 2 steps in a 200 us window: kernels at 10-30, 20-40
    (overlapping), 60-70 and 150-190, a copy at 40-45 issued by the CUDA
    runtime call on the host at 39-63, another call at 100-101."""
    return [
        {"name": "k_a", "cat": "kernel", "ts": 10, "dur": 20},
        {"name": "k_b", "cat": "kernel", "ts": 20, "dur": 20},
        {"name": "window_select_kernel<true>", "cat": "kernel", "ts": 60, "dur": 10},
        {"name": "k_a", "cat": "kernel", "ts": 150, "dur": 40},
        {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 40, "dur": 5,
         "args": {"correlation": 7}},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 39, "dur": 24,
         "args": {"correlation": 7}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 100, "dur": 1},
    ]


def _reduced():
    return harness.reduce_trace(_trace(), 2, 200e-6)


def test_busy_share_is_the_union_of_kernel_intervals():
    r = _reduced()
    # busy: 10-45 (35), 60-70 (10), 150-190 (40) = 85 of the 200 us window
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(85e-6)
    assert r["kernels"] == 4 and r["steps"] == 2
    assert r["kernel_s_by_name"]["k_a"] == pytest.approx(60e-6)
    assert r["device_ops"][0] == ["k_a", pytest.approx(60e-6)]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    r = _reduced()
    # gaps: 70-150 (80 us, no host call at its start: named by the kernel
    # that ends it), 45-60 (15 us, the call that issued the copy running)
    assert r["idle_gaps"] == [["before k_a", pytest.approx(80e-6)],
                              ["cudaMemcpyAsync: Memcpy DtoH", pytest.approx(15e-6)]]


def test_a_trace_without_kernels_or_ranges_reduces_to_nothing():
    events = [e for e in _trace() if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert harness.reduce_trace(events, 2, 200e-6) is None
    assert harness.reduce_trace(_trace(), 0, 200e-6) is None


def test_readers_on_the_reduced_trace():
    trace = _reduced()
    ctx = {"kind": "train", "trace": trace, "select_bound_s": 2e-6,
           "stage_ms": {"forward": [1.0, 3.0]}, "flops_per_sample": 67e12 * 1e-3,
           "samples": 10, "untraced_s": 1.0}
    assert readers.device_idle(ctx, "train") == pytest.approx(57.5)
    assert readers.kernels_per_step(ctx, "train") == 2.0
    # 2 steps x 2 us of bound over 10 us of select kernel
    assert readers.select_roofline(ctx, "train") == pytest.approx(40.0)
    assert readers.stage_ms(ctx, "train", "forward") == 2.0
    assert readers.mfu(ctx, "train") == pytest.approx(1.0)
    for fn in (readers.device_idle, readers.kernels_per_step, readers.select_roofline,
               readers.mfu):
        assert fn(ctx, "eval") is None
    assert readers.select_roofline(dict(ctx, trace=dict(trace, kernel_s_by_name={})),
                                   "train") is None


def test_window_busy_seconds_leave_out_copies_in_after_the_last_kernel():
    ops = [(0.0, 10.0, "k_a"), (5.0, 12.0, "Memcpy HtoD (Pinned -> Device)"),
           (20.0, 30.0, "k_b"), (30.0, 31.0, "Memcpy DtoH (Device -> Pageable)"),
           (40.0, 44.0, "Memset (Device)"), (50.0, 60.0, "Memcpy HtoD (Pinned -> Device)")]
    # 0-12, 20-31 and 40-44 us; the last copy in feeds a batch the window closed on
    assert harness.busy_seconds(ops) == pytest.approx(27e-6)
    assert harness.busy_seconds([(0.0, 5.0, "Memcpy HtoD (Pinned -> Device)")]) is None
    assert harness.busy_seconds([]) is None


def test_host_readers_take_the_batches_outside_the_stretch():
    ctx = {"kind": "eval", "samples": 300, "untraced_s": 2.0,
           "latency_ms": [float(x) for x in range(1, 101)]}
    assert readers.host_rate(ctx, "eval") == pytest.approx(150.0)
    assert readers.host_tail(ctx, "eval") == pytest.approx(95.05)
    assert readers.host_rate(ctx, "train") is None and readers.host_tail(ctx, "train") is None
    assert readers.host_tail(dict(ctx, latency_ms=[]), "eval") is None


def test_p95_is_numpys_linear_percentile():
    import numpy as np

    xs = [float(x) for x in np.random.default_rng(0).exponential(size=401)]
    assert harness.p95(xs) == pytest.approx(float(np.percentile(xs, 95)))
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)
