"""Driver of the sequence-evaluation cells: the program's streaming
sequence evaluation (``evaluation/runner.py::predict_sequence_streaming``
with the steps of ``training/step.py::make_streaming_eval_fns``) over an
in-memory drive, sequence after sequence, until the window closes.

The runner reads each scan through the dataset's ``read_scan``, sends the
batch as int16 and pairs each frame with the one before it.  The
benchmark's wrappers of the two steps take each batch's latency: the time
the runner takes for it, from the previous batch's poses (or the runner's
start, for a sequence's first batch) to this batch's poses on the host
(the correlate step's output synchronised, as the runner's ``.cpu()``
right after it does).  It holds the wait for the batch's scans, their
int16 transfer, both steps and the poses' way back.  The wrappers also
keep the poses.  The window closes at the first batch that would start
after it: the encode wrapper raises, and the runner's pools shut down.
After the window the reference computes the poses of a sample of frames,
drawn from the seed, and every batch of the window that posed one of them
is compared.

The end-to-end metric is the device's: in an untraced run the profiler
records the device's activity over the whole window (``WindowProfile``),
and ``eval_device_ms_per_frame`` is the seconds in which a device
operation ran over the frames posed.  The host paces these cells, and its
speed swings between runs by more than a bound may allow (PERF.md), so the
rate and the tail on the host's clock are per-layer metrics of traced
runs, taken over the batches outside the profiled stretch.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from typing import Dict, List

import numpy as np

from benchmark import compare, generate, harness, program
from benchmark.counts import network as counts
from benchmark.stretch import StageTimer, Stretch, WindowProfile

KIND = "eval"


class WindowClosed(Exception):
    pass


class Drive:
    """The in-memory dataset: ``read_scan(seq, frame)`` of one sequence."""

    def __init__(self, seq: int, scans: np.ndarray):
        self.seq, self.scans = seq, scans

    def read_scan(self, seq: int, frame: int) -> np.ndarray:
        if seq != self.seq:
            raise KeyError(f"the drive holds sequence {self.seq}, not {seq}")
        return self.scans[frame]


def make_drive(cell, seed: int, device) -> Drive:
    sensor, traffic = cell.config["sensor"], cell.traffic
    poses, world = generate.drive(seed, sensor, traffic)
    return Drive(traffic["seq"], generate.render(poses, world, sensor, device))


def check_frames(cell, seed: int) -> List[int]:
    """The frames whose poses are compared, drawn from the seed: frame 0
    (paired with itself) and ``check_frames - 1`` others."""
    n = cell.traffic["frames"]
    rng = np.random.default_rng([seed, 1])
    return [0] + sorted(rng.choice(np.arange(1, n), cell.traffic["check_frames"] - 1,
                                   replace=False).tolist())


def run(cell, seed: int, seconds: float, trace: bool, device):
    import torch
    from efficientlo_net_torch.data.loader import quantize_points
    from efficientlo_net_torch.evaluation import runner
    from efficientlo_net_torch.training.step import make_streaming_eval_fns

    traffic = cell.traffic
    b, n = traffic["batch_size"], traffic["frames"]
    if len(runner.sequence_indices(traffic["seq"])) != n:
        raise RuntimeError(f"sequence {traffic['seq']} is not {n} frames long in the program")
    t0 = time.perf_counter()
    model = program.load_model(cell.config, device)
    t1 = time.perf_counter()
    drive = make_drive(cell, seed, device)
    t2 = time.perf_counter()
    encode_step, correlate_step = make_streaming_eval_fns(program.model_config(cell.config))

    # warm-up: the cell's batch shape through both steps
    for _ in range(2):
        pts = torch.as_tensor(quantize_points(drive.scans[:b]), device=device)
        pyr = encode_step(model, pts)
        correlate_step(model, pyr, pyr)["q"].cpu()
    print(json.dumps({"setup_phases_s": {"model": t1 - t0, "inputs": t2 - t1,
                                         "warm_up": time.perf_counter() - t2}}))

    timer = StageTimer(trace)
    batches: List[Dict] = []  # per completed batch: frames, end, latency, profiled, poses
    state = {"pos": 0, "since": 0.0, "profiled": False}
    whole = WindowProfile(not trace)
    whole.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    stretch = Stretch(trace, traffic["profile_batches"], t_start + seconds / 2)

    def encode(model_, points):
        if time.perf_counter() >= deadline:
            raise WindowClosed
        stretch.begin_step()
        state["profiled"] = stretch.active
        if not stretch.active:
            timer.start()
        pyr = encode_step(model_, points)
        timer.mark("encode")
        return pyr

    def correlate(model_, pyr_new, pyr_prev):
        out = correlate_step(model_, pyr_new, pyr_prev)
        timer.mark("correlate")
        timer.stop()
        torch.cuda.current_stream(device).synchronize()
        done = time.perf_counter()
        s = state["pos"] * b
        real = min(b, n - s)
        stretch.end_step(real)
        batches.append({"real": real, "end": done,
                        "latency_ms": (done - state["since"]) * 1e3,
                        "profiled": state["profiled"],
                        "q": out["q"][:real], "t": out["t"][:real]})
        state["pos"] += 1
        # past the stretch's stopping and reducing, which no batch waits for
        state["since"] = time.perf_counter()
        return out

    while True:
        state["pos"] = 0
        state["since"] = time.perf_counter()
        try:
            runner.predict_sequence_streaming(encode, correlate, model, drive, traffic["seq"],
                                              batch_size=b, num_workers=traffic["readers"])
        except WindowClosed:
            break
    window_s = batches[-1]["end"] - t_start
    whole.stop()
    peak = torch.cuda.max_memory_allocated(device)
    frames = sum(x["real"] for x in batches)
    poses = [np.concatenate([x["q"].cpu().numpy(), x["t"].cpu().numpy()], axis=1)
             for x in batches]
    latencies = [x["latency_ms"] for x in batches if not x["profiled"]]
    failed = int(sum((~np.isfinite(p)).any(axis=1).sum() for p in poses))
    print(json.dumps({"batches": len(batches), "frames": frames,
                      "unprofiled_batches": len(latencies),
                      "latency_ms_median": statistics.median(latencies),
                      "latency_ms_p95": harness.p95(latencies),
                      "batches_beyond_p95": sum(v > harness.p95(latencies) for v in latencies),
                      "window_device_ops": whole.ops, "window_busy_s": whole.busy_s,
                      "window_profile_stop_s": whole.stop_s}))
    ctx = {"kind": KIND, "stage_ms": timer.ms() if trace else None, "trace": stretch.trace,
           "select_bound_s": counts.select_bound_s(
               counts.select_sites(cell.config, b, training=False),
               harness.HBM_BYTES_PER_S, harness.F32_FLOPS_PER_S),
           "flops_per_sample": counts.flops_per_sample(cell.config, training=False),
           "samples": frames - stretch.samples, "untraced_s": stretch.outside(window_s),
           "stretch_samples": stretch.samples, "stretch_s": stretch.seconds,
           "latency_ms": latencies}
    del model, encode_step, correlate_step, batches
    gc.collect()
    torch.cuda.empty_cache()

    def judge():
        frames_ = check_frames(cell, seed)
        want = reference_poses(cell, drive, frames_, device)
        got, ref = program_rows(poses, frames_, want, b, n)
        return compare.pose_gaps(got, ref)

    return {"setup_end": t_start, "window_s": window_s, "attempted": frames, "failed": failed, "peak_bytes": peak,
            "ctx": ctx, "e2e": {} if whole.busy_s is None else
            {"eval_device_ms_per_frame": whole.busy_s * 1e3 / frames},
            "judge": judge}


def program_rows(poses: List[np.ndarray], frames: List[int], want: np.ndarray, b: int, n: int):
    """Every pose the window gave one of ``frames``, beside the reference's
    row of that frame.  ``poses`` holds the completed batches in order,
    sequence after sequence, ``ceil(n / b)`` batches a sequence."""
    per_seq = -(-n // b)
    got, ref = [], []
    for k, rows in enumerate(poses):
        s = (k % per_seq) * b
        for j, f in enumerate(frames):
            if s <= f < s + len(rows):
                got.append(rows[f - s])
                ref.append(want[j])
    if not got:
        raise RuntimeError("the window posed none of the compared frames")
    return np.stack(got).astype(np.float64), np.stack(ref)


def reference_poses(cell, drive: Drive, frames: List[int], device, tf32: bool = False):
    """The reference's l0 (q, t) rows of ``frames``, in blocks of the cell's
    batch; ``tf32`` computes its matrix products in TF32 (the control)."""
    from benchmark.reference import train as ref_train

    net = ref_train.network(cell.config, harness.ROOT / cell.config["weights"], device)
    with ref_train.matmul_tf32(tf32):
        return ref_train.sequence_poses(net, lambda f: drive.scans[f], frames, device,
                                        block=cell.traffic["batch_size"])
