"""Whole runs of the harness on the CPU, at the tiny network: past the look
for a card, through set-up, window, metrics and the reference's judgement
to the result's line.  A sound run comes out correct; each fault the cell
can have, planted in the timed path, comes out not correct; and without a
card the command prints no result and fails."""

import argparse
import os
import subprocess
import sys

import contextlib

import pytest

from benchmark import faults, harness
from benchmark.tests.conftest import last_json

RUN = harness.HERE / "run.py"


def measure(cell, capsys, fault=None, trace=0, seconds=1.0, seed=2**31 + 5):
    """A run of ``cell`` past the look for a card, with ``fault`` planted in
    the program's timed path."""
    import torch

    run = harness.load_file_module(RUN, "benchmark_run")
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=seconds, trace=trace)
    kind = "train" if cell.driver == "train_step" else "eval"
    with faults.planted(kind, fault) if fault else contextlib.nullcontext():
        assert run.measure(cell, args, torch.device("cpu")) == 0
    captured = capsys.readouterr()
    line = last_json(captured.out)
    # the compared numbers close standard error, and the line
    assert list(line)[-1] == "checks"
    tail = captured.err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in line["checks"]]
    return line


@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged"])
def test_train_run_correct_only_without_fault(cpu_cuda, tiny_train_cell, capsys, fault):
    line = measure(tiny_train_cell, capsys, fault)
    assert line["correct"] is (fault is None), line["checks"]
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.fixture
def window_device_ops(monkeypatch):
    """The whole-window profile on the CPU: the profiler records the host
    (the CPU has no CUDA activity), and its device operations are a
    stand-in of 2 ms of kernels and a copy in after them."""
    import torch

    from benchmark import stretch

    monkeypatch.setattr(stretch, "activities", lambda: [torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(stretch, "device_ops", lambda prof: [
        (0.0, 1500.0, "k"), (1500.0, 2000.0, "k"), (2500.0, 2600.0, "Memcpy HtoD")])


@pytest.mark.parametrize("fault", [None, "altered", "half_batch"])
def test_eval_run_correct_only_without_fault(cpu_cuda, window_device_ops, tiny_eval_cell,
                                             capsys, fault):
    line = measure(tiny_eval_cell, capsys, fault, seconds=4.0)
    assert line["correct"] is (fault is None), line["checks"]
    assert set(line["metrics"]) == {"eval_device_ms_per_frame", "peak_mem_gib", "setup_s"}
    assert line["metrics"]["eval_device_ms_per_frame"]["value"] == \
        pytest.approx(2.0 / line["attempted"])


def test_eval_run_without_device_operations_prints_no_result(cpu_cuda, window_device_ops,
                                                            tiny_eval_cell, capsys,
                                                            monkeypatch):
    """An untraced eval run whose window profile holds no device operation
    has no end-to-end metric to give: it fails, printing no result."""
    import torch

    from benchmark import stretch

    monkeypatch.setattr(stretch, "device_ops", lambda prof: [])
    run = harness.load_file_module(RUN, "benchmark_run")
    args = argparse.Namespace(workload=tiny_eval_cell.name, seed=2**31 + 6, seconds=1.0,
                              trace=0)
    assert run.measure(tiny_eval_cell, args, torch.device("cpu")) != 0
    captured = capsys.readouterr()
    assert '"correct"' not in captured.out
    assert "not measured" in captured.err


def test_traced_eval_run_reports_the_host_rate_and_tail(cpu_cuda, tiny_eval_cell, capsys,
                                                       monkeypatch):
    import torch

    from benchmark import stretch

    monkeypatch.setattr(stretch, "activities", lambda: [torch.profiler.ProfilerActivity.CPU])
    line = measure(tiny_eval_cell, capsys, trace=1, seconds=4.0)
    assert line["correct"] is True
    assert set(line["metrics"]) >= {"eval_encode_ms", "eval_correlate_ms",
                                    "host_frames_per_s.eval", "host_pose_latency_ms_p95.eval"}
    assert line["metrics"]["host_frames_per_s.eval"]["value"] > 0


def test_traced_train_run_reports_spans_and_no_device_numbers(cpu_cuda, tiny_train_cell,
                                                            capsys, monkeypatch):
    """On the CPU the profiler (recording the host there, as the CPU has no
    CUDA activity) sees no kernel: the trace readers find nothing and their
    metrics are left out; the span readers still read."""
    import torch

    from benchmark import stretch

    monkeypatch.setattr(stretch, "activities", lambda: [torch.profiler.ProfilerActivity.CPU])
    line = measure(tiny_train_cell, capsys, trace=1, seconds=2.0)
    assert set(line["metrics"]) >= {"train_forward_ms", "train_backward_ms", "mfu_pct.train"}
    assert not {"kernels_per_step.train", "select_roofline.train",
                "device_idle_pct.train"} & set(line["metrics"])


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_stage_times_skip_the_profiled_stretch(cpu_cuda, monkeypatch, request, kind):
    """The stage timer's entries each lie within one timed step: the steps
    of the profiled stretch leave none, and their marks fall into no other
    step's.  A stand-in stretch holds the second and third steps "profiled"
    and moves the stage events' clock 10 s on at the start of each, so an
    entry that reached into them would read 10,000 ms or more."""
    import time

    import torch

    skew = [0.0]

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0

        def record(self, stream=None):
            self.t = time.perf_counter() + skew[0]

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    class Stretch:
        def __init__(self, enabled, count, start_at):
            self.n, self.active, self.trace, self.seconds, self.samples = 0, False, None, 0.0, 0

        def begin_step(self):
            self.active = 1 <= self.n < 3
            skew[0] += 10.0 if self.active else 0.0

        def end_step(self, samples):
            self.n += 1

        def outside(self, window_s):
            return window_s - self.seconds

    monkeypatch.setattr(torch.cuda, "Event", Event)
    cell = request.getfixturevalue(f"tiny_{kind}_cell")
    driver = harness.driver_module(cell.driver)
    monkeypatch.setattr(driver, "Stretch", Stretch)
    out = driver.run(cell, 2**31 + 9, 8.0, True, torch.device("cpu"))
    stages = out["ctx"]["stage_ms"]
    steps = out["attempted"] if kind == "train" else -(-out["attempted"] // cell.traffic["batch_size"])
    assert steps >= 5
    for name, times in stages.items():
        assert len(times) == steps - 2, name
        assert max(times) < 10_000.0, (name, max(times))


def test_command_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(RUN), "--workload", "hdl64.train_b8",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_command_in_a_bare_directory_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files has
    no program to run."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hdl64.train_b8",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
