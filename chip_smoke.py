#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (efficientlo_net_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``efficientlo_net_torch/ops/csrc`` and drives
the port's main paths at the full HDL-64 width (64x1800 range images of
150k-point scans), from the 50-epoch weights in
``pretrained/synthetic_drive_50ep.msgpack``: eval-mode streaming odometry,
the train step at ``TrainConfig().batch_size`` = 8, the trainer with
sequence evaluation, SLAM with loop closures, the host-projected
stream, train step and trainer, the bfloat16 stream and train step, the
``torch.export`` artifact, the weight writer and both CLIs.  Phases, each
printing JSON lines:

1. device: the card (and its ``nvidia-smi`` name and power limit); TF32 is
   switched off for matmuls and convolutions, so float32 stays float32;
2. build: the kernels' build time and ptxas report, and the native
   library's (``native/lidar_io.cpp`` with the host compiler, alongside);
3. kernels: every select call of one push (14 ``window_select`` and 5
   ``select_and_group`` launches) is replayed on its recorded inputs through
   the kernel and through its plain PyTorch version: K sets and masks must be
   equal exactly, and each centre's grouped (xyz, feature) rows exactly, as
   multisets; plus one FIRST_K case with a random scan permutation per
   kernel.  Each call site is timed beside its bound: back-to-back calls
   (CUDA events, median; and the host's time to make the calls) of the
   wrapper and of its ``efficientlo::`` operator, which every call site of
   the port goes through, and the kernel alone (the replay of a CUDA graph
   that captured the calls);
4. stream: ~10 scans pushed through ``OdometryStream(device="cuda")``; every
   push must launch ``window_select`` 14 times and ``select_and_group`` 5
   times; poses must be finite with unit quaternions and match the same
   stream run through the plain select versions on the card; ms per push,
   and per stage (projection, tower, correlation + refinement);
5. train kernels: the 23 ``window_select`` calls of one train step (8 in
   the two towers, 3 at the coarse level, 4 at each refinement level; 19
   first-K with a fresh random scan order, 4 KNN) replayed through the
   kernel and the plain version: masks and indices equal, in the same slot
   order; each site timed as in phase 3;
6. train: ``make_train_step`` on ``create_train_state(load_model(...))``,
   2 warm-up steps, then 10 timed steps on one fixed B=8 batch; every step
   must launch ``window_select`` 23 times and ``select_and_group`` never,
   with finite losses, gradients and parameters, and ``w_x``/``w_q`` must
   move; ms per step (CUDA events), samples/s, stage ms (inputs, forward,
   backward, optimizer), peak device memory, the losses of every step; then
   one step through the kernel and one through the plain selects, from the
   same state and generator seed: the losses, every gradient and the new
   batch statistics must agree (``TRAIN_*`` tolerances below);
7. trainer and sequence eval: a KITTI-layout tree of sequence 04 (271
   full-width frames, 150k points each, 0.5 m apart along a 135 m path
   through ``random_scene`` blocks) is written to a temporary directory
   (phase 9 reads it too); ``Trainer(device="cuda")`` with the 50-epoch
   weights and ``TrainConfig(host_projection=False)`` (device projection;
   the default turns host projection on wherever the native library
   builds) takes 6 steps
   through the real loader (disk, ``make_batch``, mirroring and pinning in
   the loader's workers, ``device_prefetch``); every step must launch
   ``window_select`` 23 times and ``select_and_group`` never, losses
   finite, ``w_x``/``w_q`` moved;
   ms per step (CUDA events from one step's end to the next, loader in the
   loop), samples/s, peak memory.  A checkpoint saved and restored into a
   fresh ``Trainer`` must be bit-equal (parameters, buffers, ``w_x``,
   ``w_q``, Adam moments) and resume at epoch 1.  ``validate()`` runs
   streaming sequence eval over the 271 frames at B=8: every batch must
   launch ``window_select`` 14 times and ``select_and_group`` 5 times,
   t_rel and r_rel must be finite and ``04_pred.txt`` written; the pairwise
   ``predict_sequence`` must give the streaming (q, t) within
   ``EVAL_QT_ATOL``; frames/s of both.  The select calls of the first
   streaming batch (B=8) and of the same pairs through the pairwise step
   (the 2B tower) are recorded and replayed through the kernel and the
   plain version, checked as in phase 3;
8. SLAM: a closed-loop drive of ``SLAM_FRAMES`` frames (``synthetic_trajectory``
   kind "loop", ~144 m) through the drive world (``build_world``,
   ``make_dynamic_objects``), each 150k-point scan rendered by
   ``DriveRenderer`` in a pool of worker processes a few frames ahead of
   its use, pushed through ``OdometryStream(device="cuda")`` and fed to
   ``SlidingWindowSLAM`` (solver on the card, scan factors, whole-history
   closure search) with the range image on the card as the keyframe
   payload.  Each closure candidate is measured both ways with
   ``measure_relative`` (r = 3) and kept when the two agree; every such
   call must launch ``window_select`` 14r and ``select_and_group`` 5r + 4
   times, and at least one candidate must be measured.  After the drive
   ``global_optimize`` and ``render_map``; keyframe poses finite.  Checks
   against the CPU, on the same inputs: one captured window solve (odometry
   and closure factors, prior, scan factors), both ``global_optimize``
   solves, ``icp_refine`` on a revisit pair, ``compute_normals`` and
   ``projective_association``; the window solve again under
   ``torch.set_float32_matmul_precision("high")`` (the solver must keep
   float32); one ``measure_relative`` through the kernels against the
   plain selects.  Prints ms per push, ``add_frame``, ``optimize_window``
   and ``measure_relative``, t_rel / r_rel / ATE of the raw stream, the
   window and the global pass against the drive's own poses, and the map's
   median distance to the static world;
9. host projection: (a) the native library must be at ABI 3 with the
   fused pass, with no numpy fallback; (b) on the stream's scans (cropped)
   and one B=8 train batch (cropped and perturbed): ``sort`` and
   ``scatter`` on the card bit-equal, the card's ``sort`` against the CPU's
   and the native ``project_batch`` against the card's ``sort`` on at most
   ``PROJECTION_PIXEL_FRAC`` of the pixels apart, and the fused
   ``augment_project_batch`` (with a deferred mirror) against the two-pass
   host path likewise; ms of packed, sort and scatter on the card at B=1
   and B=8, of the native ``project_scan`` at 1, 4 and 8 threads and of
   ``augment_project_batch`` at B=8; (c) ``OdometryStream(host_projection=
   True)`` pushes the same scans: 14 + 5 launches a push, finite poses
   with unit quaternions; ms per push and per stage, and the largest pose
   difference from phase 4 (not checked: exact images against packed);
   (d) ``make_train_step(host_projected=True)`` on the host-projected
   batches, 2 warm-up and 10 timed steps: 23 + 0 launches a step, finite
   losses, gradients and parameters; the projected step fed the card's own
   device-projected images against the device step, from one state and
   seed (``TRAIN_*`` tolerances); (e) ``Trainer`` with
   ``host_projection=True`` over phase 7's tree, 6 steps as in phase 7,
   beside phase 7's numbers; (f) ``utils.profiling.trace`` around
   TRACE_STEPS steps of a device-projected and of the host-projected
   trainer: the device's busy and idle share over the window (the union
   of its CUDA kernel intervals) and its top operations;
10. bfloat16 and serving, at the full config: (a) the stream's scans
   through ``OdometryStream`` with ``compute_dtype="bfloat16"``: 14 + 5
   launches a push, finite poses with unit quaternions within
   ``BF16_*_BOUND`` of phase 4's float32 poses, one push's select calls
   replayed through kernel and plain version as in phase 3 (the features
   reaching ``select_and_group`` must be float32); ms per push beside phase
   4's; (b) the bfloat16 train step on phase 6's batches, 2 warm-up and 10
   timed: 23 + 0 launches a step, float32 loss, gradients, parameters and
   Adam moments; ms per step, stage ms and peak memory beside phase 6's;
   (c) ``serving.export.export_odometry(device="cuda")`` at B=1, saved and
   loaded: the artifact's (q, t) within ``EXPORT_ATOL`` of
   ``make_infer_fn``'s on two scans, 14 + 5 launches a call; export s, file
   bytes, ms per call of both; (d) ``save_pretrained`` of phase 7's trained
   state, read back by ``load_model``: tensors and the forward on one pair
   bit-equal; (e) ``cli.main`` in test mode over phase 7's tree with the
   weights (d) wrote, whose t_rel must be within ``CLI_T_REL_ATOL`` of phase
   7's ``validate()``, then ``evaluate_cli.main`` over its trajectory;
   (f) float32 against bfloat16 under ``torch.profiler``: PROFILED_CALLS
   pushes of a stream and PROFILED_CALLS B=8 train steps of each, after 2
   warm-up calls: CUDA kernels and kernel ms per call, and the host
   operators with the most self CPU time per call (the profiler's own cost
   inflates them: read them for their ranking);
11. parallelism (``efficientlo_net_torch/parallel``): (a) the W-axis ring's
   block kernels: the select sites of one push that the ring shards (down
   l0 through ``select_and_group`` with a random scan permutation, the l0
   cost volume's KNN and aggregation selects, the l0 up-conv cropped to
   ``UP_CROP``) run with the block offsets on the halo-widened block of
   every rank of a ring of 3 and of 5, exact against the plain block
   version and against the unsharded kernel's sector; device ms of each
   block and of the unsharded call; (b) an NCCL group of one rank in this
   process (``initialize_distributed`` from the environment, ``make_mesh``
   on the card): the full-width ring eval forward equals the unsharded one
   (14 + 5 launches), ``make_sharded_train_step`` at B=8 the single step,
   the DP state's checkpoint round-trips bit-equal, ``optimize(group=)``
   equals ``optimize()``; ms per DP step beside the plain step; (c) two
   gloo ranks spawned on the one card, B=4 each: their step against the
   single B=8 step, parameters after Adam bit-equal across the ranks, ms
   per step; (d) the ring in training: (a) in the NCCL group of (b), the
   ring's training forward, loss and backward at B=8 on a ``make_mesh((1,
   1))`` ring of one against the unsharded pass (losses, gradients and
   statistics at the train tolerances, 23 + 0 launches, ms of each timed
   in turns, one profiled pass of each); (b)
   the training select on every rank's widened block of rings of 3 and 5
   at the level-0 DownConv call of one push, exact against the plain block
   version and the unsharded kernel's sector, and its backward through the
   block gathers folded onto the sectors (``ring.fold_halo_grad``) against
   the unsharded ``select_and_group(fused=False)`` gradient, 2 + 0
   launches a block counted; device ms of each block;
12. the ``kernels`` line (each kernel's launches, times and bound, per path
   and summed), the total seconds, then the card line, then the result
   line.

Exits non-zero, printing no result, when no CUDA device is present or any
check fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

WEIGHTS = "pretrained/synthetic_drive_50ep.msgpack"
SEED = 0
N_SCANS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
FLOPS_PER_CANDIDATE = 13   # |q|^2, q - c and |q - c|^2 for one window slot
# Launch sites of one push, in call order (models/pwclo.py).
SELECT_SITES = ["cv_origin.knn", "cv_origin.self"] + [
    f"{name}_l{lvl}" for lvl in (2, 1, 0)
    for name in ("cv.knn", "cv.self", "up_w", "up_feat")
]
GROUP_SITES = ["down_l0", "down_l1", "down_l2", "down_l3", "cv_down_l3"]
# Kernel and plain selects write the K slots in the same order, so the two
# streams run the same arithmetic and should agree bit for bit.  The
# tolerance covers a library reduction that is not bitwise reproducible from
# run to run.  It does not cover a point that the in-network re-projection
# (models/pwclo.py, forward_from_pyramids) puts in another pixel after such an
# ulp-level pose difference: that moves l0 by more and fails the check.
STREAM_ATOL = 1e-5
# Train path.  Sites in call order (models/pwclo.py): the tower of frame 1,
# then of frame 2, the coarse level, then the refinement levels as above.
TRAIN_SELECT_SITES = [f"down_l{i}.frame{f}" for f in (1, 2) for i in range(4)] + [
    "cv_origin.knn", "cv_origin.self", "cv_down_l3"] + SELECT_SITES[2:]
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
# Kernel step against plain-select step.  Both select the same neighbours in
# the same slot order, so their forward passes run the same arithmetic: the
# losses and the new batch statistics should agree bit for bit (atol 1e-5
# covers a library reduction that is not reproducible from run to run).  The
# gathers' backward adds with atomics in a run-dependent order, so a
# gradient is held to TRAIN_GRAD_REL of the larger of its tensor's largest
# entry and TRAIN_GRAD_FLOOR of the largest gradient of all (the floor is
# for gradients that are zero but for rounding: the biases of dense layers
# that feed a batch norm).  A point that the in-network re-projection puts
# in another pixel changes a loss by far more, and fails the check.
TRAIN_LOSS_ATOL = 1e-5
TRAIN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_GRAD_REL = 1e-4
TRAIN_GRAD_FLOOR = 1e-2
# Trainer and sequence-eval path: sequence 04 (the shortest, 271 frames)
# written as a KITTI tree, poses KITTI_STEP m apart along x through
# random_scene blocks laid every KITTI_BLOCK_SPACING m.
KITTI_SEQ = 4
KITTI_STEP = 0.5
KITTI_BLOCK_SPACING = 30.0
TRAINER_BATCHES = 6
TIMED_STEPS = slice(2, None)  # steps 3-6: the first two warm the loader's queue
# Streaming against pairwise sequence eval: the same pairs through a B tower
# and a 2B tower, whose cuBLAS algorithms may differ by ulps.  A point that
# such an ulp moves to another pixel in the re-projection moves l0 by more
# and fails the check.
EVAL_QT_ATOL = 1e-4
# SLAM path: the closed loop of the JAX package's eval drive (loop kind,
# 0.6 m a frame, 8 m corners), 240 frames of it: ~144 m, ending where it
# started.  SlamConfig as tools/synthetic_drive.py (stage slam) sets it.
SLAM_FRAMES = 240
SLAM_SPEED = 0.6
SLAM_CORNER_RADIUS = 8.0
SLAM_SEED = 7
SLAM_REFINEMENTS = 3
# closure candidates: keyframes within this distance (m) of the newest one
# by the graph's own estimate; the drive tool's default --closure_radius,
# wide enough to find the start again through the odometry's drift
SLAM_CLOSURE_RADIUS = 12.0
# the two-way gate of tools/synthetic_drive.py: forward @ backward within
GATE_T_M = 0.15
GATE_R_DEG = 1.0
RENDER_WORKERS = 6
RENDER_AHEAD = 12  # frames rendered ahead of the stream, at most
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# One measure_relative pair through the kernels and through the plain
# selects: the same arithmetic, as in the stream (STREAM_ATOL), over 1 + r
# composed network measurements; absolute on the (4, 4) entries, whose
# translations reach the closure radius.
MEASURE_ATOL = 1e-4
# Card against CPU, the same inputs.  Both solve float32 normal equations
# (gauge weight 1e6, damping 1e-6) with sums in another order (atomic
# scatter-adds and cuBLAS on the card, MKL on the CPU); Gauss-Newton
# contracts such differences, so the poses agree to rounding of the
# solution: 1e-3 on the (4, 4) entries (1 mm, 1 mrad), chi2 to 1e-3.
SOLVE_POSE_ATOL = 1e-3
SOLVE_CHI2_RTOL = 1e-3
# ICP: the same association in another summation order; the pose to 1e-3.
# Its gates re-associate every iteration, so rounding may flip a few
# correspondences, bounded by count as below: the inlier fraction to
# PIXEL_FLIP_FRAC.  One flipped correspondence (a residual of up to 1 m
# against an RMS of centimetres, among a few thousand inliers) moves the
# RMS by up to ~10%: ICP_RMS_RTOL.
ICP_ATOL = 1e-3
ICP_RMS_RTOL = 0.1
# Normals and association are elementwise: a pixel may differ only where an
# ulp of atan2 / asin crosses a pixel border or a gate's threshold, which
# the tolerance bounds by count: at most 1e-3 of the pixels; normals
# elsewhere to 1e-4.
PIXEL_FLIP_FRAC = 1e-3
NORMAL_ATOL = 1e-4
# Host projection (phase 9).  Two implementations of the exact projection
# (the card's and the CPU's atan2 / asin, or libm's in the native projector)
# may put a point that lies within an ulp of a pixel border in either
# pixel: images differ on at most this share of the pixels
# (tests/test_host_preprocess.py holds the JAX package to the same bound).
PROJECTION_PIXEL_FRAC = 1e-3
NATIVE_THREADS = (1, 4, 8)
TRACE_STEPS = 4  # trainer steps traced; the window starts at the second
# Phase 10.  bfloat16 against float32 poses: the bounds of the JAX package's
# tests/test_bf16.py.  The exported artifact runs the same operations and
# kernels as make_infer_fn, in the same order: STREAM_ATOL's reasoning.  The
# CLI scores the weights phase 7 validated, through the same streaming
# eval at the same batch size.
BF16_Q_BOUND = 0.2
BF16_T_BOUND = 0.5
EXPORT_ATOL = 1e-5
CLI_T_REL_ATOL = 1e-4
PROFILED_CALLS = 3
TOP_HOST_OPS = 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def expect(failures, cond, msg):
    """``check``, deferred: a failed condition is appended to ``failures``."""
    if not cond:
        failures.append(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps=20, repeats=5):
    """Medians over ``repeats`` of the mean time of ``reps`` back-to-back
    calls: (CUDA-event ms, host ms to issue them).  Where the two are close,
    the device waited for the host's launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / reps)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / reps)
    return statistics.median(dev), statistics.median(host)


def graph_ms(fn, reps=20, repeats=5):
    """Device ms of one call with no host in the way: a CUDA graph captures
    ``reps`` calls, and the median over ``repeats`` replays of the replay's
    CUDA-event time is divided by ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


@contextlib.contextmanager
def recording(ws):
    """Record the arguments of every kernel call made inside the block.  Each
    tensor is copied; arguments that are one buffer (a self-select's centres
    and source) stay one copy."""
    calls = {"window_select": [], "select_and_group": []}
    originals = {name: getattr(ws, name) for name in calls}

    def wrap(name):
        def fn(*args):
            copies = {}

            def keep(a):
                if not hasattr(a, "clone"):
                    return a
                key = (a.data_ptr(), a.shape, a.stride(), a.dtype)
                if key not in copies:
                    copies[key] = a.detach().clone()
                return copies[key]

            calls[name].append(tuple(keep(a) for a in args))
            return originals[name](*args)
        return fn

    for name in calls:
        setattr(ws, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ws, name, fn)


@contextlib.contextmanager
def plain_selects(ws, nbr):
    """Route the network's selects through the plain PyTorch versions."""
    originals = {name: getattr(ws, name) for name in ("window_select", "select_and_group")}
    ws.window_select = nbr.select_neighbors_plain
    ws.select_and_group = nbr.select_and_group_plain
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ws, name, fn)


def sorted_sets(idx, mask):
    """Per centre, the selected flat indices sorted, -1 in empty slots."""
    return idx.masked_fill(mask[..., 0] == 0, -1).long().sort(dim=-1).values


def examined(nbr, args, group):
    """In-grid window slots the kernel tests for these inputs, over the valid
    centres: all of them for KNN; for FIRST_K those up to the K-th hit in
    scan order."""
    import torch

    if group:
        xyz1, _, ks, k, dist, cs, mode, perm = args
        xyz2, ss = xyz1, (1, 1)
    else:
        xyz1, xyz2, ks, k, dist, cs, ss, mode, perm = args
    ok, _, _ = nbr.candidate_mask(xyz1, xyz2, ks, dist, cs, ss)
    _, in_grid = nbr._window_index(*xyz1.shape[1:3], *xyz2.shape[1:3], ks, cs, ss, ok.device)
    b, n, t = ok.shape
    centre = xyz1[:, :: cs[0], :: cs[1]].reshape(b, n, 3)
    valid = ((centre * centre).sum(-1) > 1e-10)[..., None]
    in_grid = in_grid.expand(b, n, t)
    if mode == nbr.FIRST_K:
        if perm is not None:
            order = torch.as_tensor(perm, device=ok.device).long()
            ok, in_grid = ok[..., order], in_grid[..., order]
        before_kth = torch.cumsum(ok.int(), -1) - ok.int() < k  # slots scanned
        in_grid = in_grid & before_kth
    return int((in_grid & valid).sum())


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def select_bytes(args, idx, mask):
    """Bytes one ``window_select`` call must move: xyz1 at its centres only
    (nothing more when xyz1 is the source itself), the source xyz2, the
    scan permutation, and the indices and mask written."""
    xyz1, xyz2, perm = args[0], args[1], args[8]
    centres = 0 if xyz1 is xyz2 else idx.shape[0] * idx.shape[1] * 3 * xyz1.element_size()
    return centres + nbytes(xyz2, perm, idx, mask)


def select_site_row(ws, nbr, site, args):
    """One recorded ``window_select`` call: checked against the plain
    version, then timed beside its bound."""
    idx, mask, same = check_select_site(ws, nbr, args)
    ms, host_ms = time_ms(lambda: ws.window_select(*args))
    op_ms, op_host_ms = time_ms(lambda: ws.window_select_op(*args))
    device_ms = graph_ms(lambda: ws.window_select(*args))
    plain_ms, _ = time_ms(lambda: nbr.select_neighbors_plain(*args))
    b_ms, b_by = bound(select_bytes(args, idx, mask),
                       FLOPS_PER_CANDIDATE * examined(nbr, args, group=False))
    return dict(site=site, **describe(args, False), ms=ms, host_ms=host_ms, op_ms=op_ms,
                op_host_ms=op_host_ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, same_order=same)


def check_select_site(ws, nbr, args):
    """Kernel vs plain on one recorded window_select call."""
    import torch

    idx, mask = ws.window_select(*args)
    idx_p, mask_p = nbr.select_neighbors_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(mask, mask_p), "window_select mask differs from the plain version")
    diff = (sorted_sets(idx, mask) - sorted_sets(idx_p, mask_p)).abs().max().item()
    check(diff == 0, f"window_select K sets differ from the plain version (max {diff})")
    return idx, mask, bool(torch.equal(idx, idx_p))


def sort_rows(x):
    """(B, N, K, C): each centre's K rows in lexicographic order (a stable
    sort per channel, last channel first), so rows compare as multisets."""
    import torch

    order = torch.arange(x.shape[2], device=x.device).expand(x.shape[:3]).contiguous()
    for c in reversed(range(x.shape[3])):
        key = torch.gather(x[..., c], 2, order)
        order = torch.gather(order, 2, torch.argsort(key, dim=2, stable=True))
    return torch.gather(x, 2, order[..., None].expand(x.shape))


def check_group_site(ws, nbr, args):
    """Fused kernel vs plain on one recorded select_and_group call: masks
    equal, and per centre the grouped (xyz, feature) rows equal as multisets."""
    import torch

    gx, gf, m = ws.select_and_group(*args)
    px, pf, pm = nbr.select_and_group_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(m, pm), "select_and_group mask differs from the plain version")
    got = sort_rows(torch.cat([gx, gf], -1))
    want = sort_rows(torch.cat([px, pf], -1))
    err = (got - want).abs().max().item()
    check(err == 0, f"select_and_group values differ from the plain version (max {err})")
    same = bool(torch.equal(gx, px) and torch.equal(gf, pf))
    return (gx, gf, m), err, same


def describe(args, group):
    if group:
        xyz, feats, ks, k, dist, cs, mode, perm = args
        return {"grid": list(xyz.shape), "C": feats.shape[-1], "window": list(ks), "K": k,
                "radius": dist, "centre_stride": list(cs), "mode": mode}
    xyz1, xyz2, ks, k, dist, cs, ss, mode, perm = args
    return {"centres": list(xyz1.shape), "source": list(xyz2.shape), "window": list(ks),
            "K": k, "radius": dist, "centre_stride": list(cs), "source_stride": list(ss),
            "mode": mode, "perm": perm is not None}


def kernel_phase(ws, nbr, stream, scans):
    """Phase 3: record the select calls of one push, then replay every call
    site through the kernel and the plain version, checked and timed."""
    import torch

    stream.reset()
    stream.push(scans[0])
    with recording(ws) as calls:
        stream.push(scans[1])

    check(len(calls["window_select"]) == len(SELECT_SITES),
          f"one push made {len(calls['window_select'])} window_select calls, "
          f"expected {len(SELECT_SITES)}")
    check(len(calls["select_and_group"]) == len(GROUP_SITES),
          f"one push made {len(calls['select_and_group'])} select_and_group calls, "
          f"expected {len(GROUP_SITES)}")
    sites = {"window_select": [select_site_row(ws, nbr, site, args)
                               for site, args in zip(SELECT_SITES, calls["window_select"])],
             "select_and_group": []}
    for site, args in zip(GROUP_SITES, calls["select_and_group"]):
        outs, err, same = check_group_site(ws, nbr, args)
        ms, host_ms = time_ms(lambda: ws.select_and_group(*args))
        op_ms, op_host_ms = time_ms(lambda: ws.select_and_group_op(*args))
        device_ms = graph_ms(lambda: ws.select_and_group(*args))
        plain_ms, _ = time_ms(lambda: nbr.select_and_group_plain(*args))
        b_ms, b_by = bound(nbytes(args[0], args[1], *outs),
                           FLOPS_PER_CANDIDATE * examined(nbr, args, group=True))
        sites["select_and_group"].append(dict(
            site=site, **describe(args, True), ms=ms, host_ms=host_ms, op_ms=op_ms,
            op_host_ms=op_host_ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, max_abs_err=err, same_order=same))
    for name, rows in sites.items():
        for row in rows:
            emit({"phase": "kernel_site", "kernel": name, **row})

    # FIRST_K with a random scan order, one case per kernel
    rng = np.random.default_rng(SEED + 1)
    a = list(calls["window_select"][SELECT_SITES.index("up_w_l0")])
    a[8] = torch.as_tensor(rng.permutation(a[2][0] * a[2][1]), device=a[0].device)
    check_select_site(ws, nbr, tuple(a))
    g = list(calls["select_and_group"][GROUP_SITES.index("down_l0")])
    g[7] = torch.as_tensor(rng.permutation(g[2][0] * g[2][1]), device=g[0].device)
    check_group_site(ws, nbr, tuple(g))
    emit({"phase": "kernel_perm", "ok": True, "window_select_site": "up_w_l0",
          "select_and_group_site": "down_l0"})
    return sites, calls


def make_scans(sensor, n):
    from efficientlo_net_torch.data.synthetic import synthetic_pair

    rng = np.random.default_rng(SEED)
    scans = []
    while len(scans) < n:
        pc1, pc2, _ = synthetic_pair(rng, sensor)
        scans += [pc1, pc2]
    return scans[:n]


def run_stream(stream, ws, scans):
    """Push every scan after a reset.  Returns the poses, the ms of each push
    (CUDA events around a push, which ends by copying the pose to the host)
    and each push's kernel launches."""
    import torch

    stream.reset()
    poses, times, launches = [], [], []
    for s in scans:
        before = dict(ws.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        poses.append(stream.push(s))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        launches.append({k: ws.launches[k] - before[k] for k in before})
    return poses, times, launches


def stage_times(stream, scans):
    """Median ms per push of each stage (CUDA events on the device's
    timeline, so a stage's time includes any wait for the host's launches):
    projection (of the scan already on the card; with host projection, the
    host's projection and the image's copy), the feature tower, correlation
    + refinement."""
    import torch

    model = stream.model
    stages = {"projection": [], "tower": [], "correlation_refinement": []}
    prev = None
    with torch.no_grad():
        for s in scans:
            pts = None if stream.host_projection else torch.as_tensor(s, device=stream.device)[None]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            proj = stream.project_scan(s) if pts is None else stream.project(pts)
            ev[1].record()
            pyr = model._pyramid(proj)
            ev[2].record()
            model.forward_from_pyramids(pyr, pyr if prev is None else prev)
            ev[3].record()
            ev[3].synchronize()
            prev = pyr
            for vals, a, b in zip(stages.values(), ev, ev[1:]):
                vals.append(a.elapsed_time(b))
    return {name: statistics.median(vals) for name, vals in stages.items()}


def stream_phase(ws, nbr, stream, scans, meta, card):
    """Phase 4: the main path.  Returns the launches of each kernel in it, the
    poses and the push times."""
    run_stream(stream, ws, scans[:2])  # warm-up outside the counted run
    ws.reset_launches()
    poses, times, per_push = run_stream(stream, ws, scans)
    launches = dict(ws.launches)
    expected = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    for i, counts in enumerate(per_push):
        check(counts == expected, f"push {i} launched {counts}, expected {expected}")
    for q, t in poses:
        check(q.shape == (4,) and t.shape == (3,), "pose of the wrong shape")
        check(np.all(np.isfinite(q)) and np.all(np.isfinite(t)), "non-finite pose")
        check(abs(float(np.linalg.norm(q)) - 1.0) < 1e-3, f"|q| = {np.linalg.norm(q)}")

    with plain_selects(ws, nbr):
        run_stream(stream, ws, scans[:2])
        plain_poses, plain_times, plain_launches = run_stream(stream, ws, scans)
    check(all(not any(c.values()) for c in plain_launches), "the plain stream launched a kernel")
    q_err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(poses, plain_poses))
    t_err = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(poses, plain_poses))
    check(q_err <= STREAM_ATOL and t_err <= STREAM_ATOL,
          f"kernel stream differs from the plain stream: q {q_err}, t {t_err}")
    ms = statistics.median(times)
    stages = stage_times(stream, scans)
    emit({"phase": "stream", "config": "ModelConfig() full HDL-64 64x1800",
          "weights": WEIGHTS, "trained_epochs": meta.get("trained_epochs"),
          "scans": len(scans), "points_per_scan": int(scans[0].shape[0]),
          "launches_per_push": per_push[0], "q_max_abs_err_vs_plain": q_err,
          "t_max_abs_err_vs_plain": t_err, "tolerance": STREAM_ATOL,
          "ms_per_push_median": ms, "ms_per_push_max": max(times),
          "frames_per_s": 1000.0 / ms,
          "plain_ms_per_push_median": statistics.median(plain_times),
          "stage_ms_median": stages,
          "last_pose": {"q": poses[-1][0].tolist(), "t": poses[-1][1].tolist()},
          "card": card})
    return launches, poses, {"ms_per_push_median": ms, "ms_per_push_max": max(times),
                             "stage_ms_median": stages}


def summed(rows, launches):
    """A kernel's sites on one path: launches in the path's counted run,
    launches per call of the path, and times and bound per call, summed over
    the sites."""
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {"launches": launches, "launches_per_call": len(rows),
            "ms": sum(r["ms"] for r in rows), "device_ms": sum(r["device_ms"] for r in rows),
            "host_ms": sum(r["host_ms"] for r in rows),
            "op_ms": sum(r["op_ms"] for r in rows),
            "op_host_ms": sum(r["op_host_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": t_bytes + t_ops,
            "bound_by": None if not rows else "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0)}


def kernels_line(paths, counted, card):
    """Phase 12: one entry per kernel.  ``paths`` maps a timed path ("stream":
    one push, "train": one train step) to (its sites by kernel, its launches
    by kernel); ``counted`` maps an untimed path ("trainer", "sequence_eval",
    "slam", "host_stream", "host_train_step", "host_trainer", the bf16 and
    artifact paths, "ring_blocks", "ring_forward", "dp_step_nccl",
    "dp_step_gloo", "ring_train", "ring_train_blocks") to its
    launches by kernel, its launches per call by kernel, the unit of a call,
    the calls made, where its calls were checked against the plain versions
    the largest error by kernel, and where it also pushes scans its pushes
    and launches per push.  Top-level times and bound
    are one call of each timed path, summed; ``launches`` is the sum of
    every path's counted run; ``max_abs_err`` the largest of every check."""
    source = "efficientlo_net_torch/ops/csrc/window_select.cu"
    replaces = {"window_select": "efficientlo_net_tpu/ops/pallas_select.py:48",
                "select_and_group": "efficientlo_net_tpu/ops/pallas_select.py:98"}
    kernels = []
    for name, where in replaces.items():
        per = {path: summed(sites[name], launches[name])
               for path, (sites, launches) in paths.items()}
        for path, c in counted.items():
            per[path] = {"launches": c["launches"][name],
                         f"launches_per_{c['unit']}": c["per_call"][name],
                         "calls": c["calls"][name] if isinstance(c["calls"], dict) else c["calls"]}
            if name in c.get("max_abs_err", {}):
                per[path]["max_abs_err"] = c["max_abs_err"][name]
            if "per_push" in c:
                per[path].update(pushes=c["pushes"], launches_per_push=c["per_push"][name])
        rows = [r for sites, _ in paths.values() for r in sites[name]]
        total = summed(rows, sum(p["launches"] for p in per.values()))
        total["max_abs_err"] = max([total["max_abs_err"]]
                                   + [p["max_abs_err"] for p in per.values() if "max_abs_err" in p])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": where,
            **{k: total[k] for k in ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "host_ms", "op_ms", "op_host_ms")},
            "library_ms": None,
            "per": "times and bound: one push plus one train step, summed over call sites "
                   "(host_ms: the wrapper called directly; op_ms / op_host_ms: through the "
                   "efficientlo:: operator); launches: every path's counted run",
            "paths": per, "card": card,
        })
    return {"kernels": kernels}


def train_batches(sensor, batch_size):
    """The fixed batch of the timed steps, then the warm-up batches."""
    from efficientlo_net_torch.data.synthetic import synthetic_batch

    rng = np.random.default_rng(SEED + 2)
    return [synthetic_batch(rng, batch_size, sensor, training=True)
            for _ in range(1 + TRAIN_WARMUP)]


def fresh_train_state(cfg, tcfg, dev):
    from efficientlo_net_torch.pretrained import load_model
    from efficientlo_net_torch.training.state import create_train_state

    model, meta = load_model(WEIGHTS, cfg, device=dev)
    return create_train_state(model, tcfg, device=dev), meta


def train_kernel_phase(ws, nbr, cfg, tcfg, batch, dev):
    """Phase 5: record the select calls of one train step, then replay every
    call site through the kernel and the plain version, checked and timed."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    state, _ = fresh_train_state(cfg, tcfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    with recording(ws) as calls:
        make_train_step(cfg, tcfg)(state, batch, gen)
    check(len(calls["window_select"]) == len(TRAIN_SELECT_SITES),
          f"one train step made {len(calls['window_select'])} window_select calls, "
          f"expected {len(TRAIN_SELECT_SITES)}")
    check(not calls["select_and_group"], "a train step called the fused select_and_group")
    rows = []
    for site, args in zip(TRAIN_SELECT_SITES, calls["window_select"]):
        row = select_site_row(ws, nbr, site, args)
        check(row["same_order"], f"window_select at train site {site}: slot order differs")
        check(row["perm"] == (row["mode"] == nbr.FIRST_K),
              f"train site {site}: a first-K select without a scan permutation")
        emit({"phase": "train_kernel_site", "kernel": "window_select", **row})
        rows.append(row)
    return {"window_select": rows, "select_and_group": []}


def all_finite(tensors):
    import torch

    return bool(torch.stack([torch.isfinite(x).all() for x in tensors]).all())


def run_train(ws, step, state, batches, gen):
    """One train step per batch.  Returns per step: ms (CUDA events around
    the step), stage ms, launches and losses; checks finiteness after each
    step, outside its timing."""
    import torch

    stages = ("inputs", "forward", "backward", "optimizer")
    out = []
    for batch in batches:
        before = dict(ws.launches)
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + stages}
        ev["start"].record()
        state, metrics = step(state, batch, gen, stage=lambda name: ev[name].record())
        ev["optimizer"].synchronize()
        marks = [ev["start"]] + [ev[name] for name in stages]
        losses = {k: float(v) for k, v in metrics.items()}
        params = state.parameters()
        check(all(np.isfinite(v) for v in losses.values()), f"non-finite loss {losses}")
        check(all_finite([p.grad for p in params]), "non-finite gradient")
        check(all_finite(params), "non-finite parameter after the update")
        out.append({"ms": ev["start"].elapsed_time(ev["optimizer"]),
                    "stage_ms": {n: a.elapsed_time(b) for n, a, b in zip(stages, marks, marks[1:])},
                    "launches": {k: ws.launches[k] - before[k] for k in before},
                    "losses": losses})
    return state, out


def one_step(ws, nbr, cfg, tcfg, batch, dev, host_projected=False, plain=False, step=None):
    """One train step from a fresh state and the generator seed SEED + 3,
    through the kernel or (``plain``) the plain selects; ``step(state,
    batch, generator) -> (state, metrics)`` in place of ``make_train_step``'s.
    Returns (losses, gradients, new batch statistics, launches)."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    state, _ = fresh_train_state(cfg, tcfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    step = step or make_train_step(cfg, tcfg, host_projected=host_projected)
    with plain_selects(ws, nbr) if plain else contextlib.nullcontext():
        before = dict(ws.launches)
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        launched = {k: ws.launches[k] - before[k] for k in before}
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    grads.update(w_x=state.w_x.grad, w_q=state.w_q.grad)
    stats = {k: v for k, v in state.model.state_dict().items() if k.endswith((".mean", ".var"))}
    return {k: float(v) for k, v in metrics.items()}, grads, stats, launched


def step_errors(got, want):
    """The largest differences of two ``one_step`` results: losses
    (absolute), gradients (each relative to its scale: its largest entry,
    and at least TRAIN_GRAD_FLOOR of the largest of all) and the new batch
    statistics (absolute, and relative to each statistic's largest entry)."""
    (m_k, g_k, s_k, _), (m_p, g_p, s_p, _) = got, want
    top = max(float(g.abs().max()) for g in g_p.values())
    grad = {k: float((g_k[k] - g).abs().max()) / max(float(g.abs().max()), TRAIN_GRAD_FLOOR * top)
            for k, g in g_p.items()}
    worst = max(grad, key=grad.get)
    stats = {k: float((s_k[k] - v).abs().max()) for k, v in s_p.items()}
    return {"loss_max_abs_err": max(abs(m_k[k] - m_p[k]) for k in m_p),
            "grad_max_rel_err": grad[worst], "grad_worst": worst,
            "stats_max_abs_err": max(stats.values()),
            "stats_max_scale_err": max(stats[k] / max(float(v.abs().max()), 1e-30)
                                       for k, v in s_p.items())}


def compare_steps(got, want, what, grad_rel=TRAIN_GRAD_REL, stats_rel=None):
    """Two ``one_step`` results that should be the same optimization: the
    losses, every gradient (relative to its scale, within ``grad_rel``) and
    the new batch statistics, held to the ``TRAIN_*`` tolerances (and, with
    ``stats_rel``, to it relative to each statistic's scale).  Returns the
    largest differences (``step_errors``) and the tolerances."""
    import torch

    (m_k, _, s_k, _), (m_p, _, s_p, _) = got, want
    out = step_errors(got, want)
    check(out["loss_max_abs_err"] <= TRAIN_LOSS_ATOL,
          f"{what[0]} losses {m_k} differ from {what[1]} {m_p}")
    check(out["grad_max_rel_err"] <= grad_rel,
          f"gradient of {out['grad_worst']}: {what[0]} differs from {what[1]} by "
          f"{out['grad_max_rel_err']:.3g} of its scale")
    for k, v in s_p.items():
        check(torch.allclose(s_k[k], v, **TRAIN_STATS_TOL),
              f"batch statistic {k}: {what[0]} differs from {what[1]}")
    if stats_rel is not None:
        check(out["stats_max_scale_err"] <= stats_rel,
              f"batch statistics: {what[0]} differs from {what[1]} by "
              f"{out['stats_max_scale_err']:.3g} of a statistic's scale")
    return {**out, "tolerance": {"loss_atol": TRAIN_LOSS_ATOL, "grad_rel": grad_rel,
                                 "grad_floor": TRAIN_GRAD_FLOOR, "stats": TRAIN_STATS_TOL,
                                 "stats_rel": stats_rel}}


def train_vs_plain(ws, nbr, cfg, tcfg, batch, dev):
    """One step through the kernel and one through the plain selects, each
    from a fresh state and the same generator seed.  Returns the largest
    differences (losses, gradients relative to their scale, statistics)."""
    kernel = one_step(ws, nbr, cfg, tcfg, batch, dev)
    plain = one_step(ws, nbr, cfg, tcfg, batch, dev, plain=True)
    check(kernel[3] == {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0},
          f"the kernel step launched {kernel[3]}")
    check(not any(plain[3].values()), f"the plain-select step launched {plain[3]}")
    return {**compare_steps(kernel, plain, ("kernel step", "plain-select step")),
            "losses_kernel": kernel[0], "losses_plain": plain[0]}


def train_phase(ws, nbr, cfg, tcfg, batches, card, dev):
    """Phase 6: the train path.  Returns the launches of each kernel in its
    counted run and the step times."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    state, meta = fresh_train_state(cfg, tcfg, dev)
    w0 = (state.w_x.item(), state.w_q.item())
    step = make_train_step(cfg, tcfg)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    state, _ = run_train(ws, step, state, batches[1:], gen)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats(dev)
    ws.reset_launches()
    state, steps = run_train(ws, step, state, [batches[0]] * TRAIN_STEPS, gen)
    launches = dict(ws.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    checked_step_launches([s["launches"] for s in steps], "train")
    check(state.w_x.item() != w0[0] and state.w_q.item() != w0[1], "w_x / w_q did not move")
    times = [s["ms"] for s in steps]
    ms = statistics.median(times)
    vs_plain = train_vs_plain(ws, nbr, cfg, tcfg, batches[0], dev)
    emit({"phase": "train", "config": "ModelConfig() full HDL-64 64x1800, TrainConfig()",
          "weights": WEIGHTS, "trained_epochs": meta.get("trained_epochs"),
          "batch_size": tcfg.batch_size, "points_per_scan": int(batches[0]["pc1"].shape[1]),
          "optimizer": tcfg.optimizer, "warmup_steps": TRAIN_WARMUP, "steps": len(steps),
          "launches_per_step": steps[0]["launches"],
          "ms_per_step_median": ms, "ms_per_step_max": max(times), "ms_per_step": times,
          "samples_per_s": tcfg.batch_size * 1000.0 / ms,
          "stage_ms_median": {n: statistics.median(s["stage_ms"][n] for s in steps)
                              for n in steps[0]["stage_ms"]},
          "peak_memory_bytes": peak, "losses_fixed_batch": [s["losses"] for s in steps],
          "w_x": [w0[0], state.w_x.item()], "w_q": [w0[1], state.w_q.item()],
          "kernel_vs_plain": vs_plain, "card": card})
    return launches, train_numbers(steps, peak)


def train_numbers(steps, peak):
    times = [s["ms"] for s in steps]
    return {"ms_per_step_median": statistics.median(times), "ms_per_step_max": max(times),
            "stage_ms_median": {n: statistics.median(s["stage_ms"][n] for s in steps)
                                for n in steps[0]["stage_ms"]},
            "peak_memory_bytes": peak}


def kitti_world(sensor, length):
    """The static world of the written sequence: a ``random_scene`` block of
    ``sensor.num_points`` points every ``KITTI_BLOCK_SPACING`` m along x over
    the ``length`` m path, shuffled, so that a pose's scan (the points within
    the planar crop, the first ``num_points`` of them) samples the blocks in
    view uniformly."""
    from efficientlo_net_torch.data.synthetic import random_scene

    rng = np.random.default_rng(SEED + 4)
    centres = np.arange(0.0, length + KITTI_BLOCK_SPACING, KITTI_BLOCK_SPACING)
    world = np.concatenate([random_scene(rng, sensor.num_points, sensor)
                            + np.array([c, 0.0, 0.0], dtype=np.float32) for c in centres])
    return world[rng.permutation(len(world))]


def state_tensors(state):
    """Every tensor a checkpoint holds, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update(w_x=state.w_x.detach(), w_q=state.w_q.detach())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def train_through_trainer(ws, trainer, dev):
    """``train_one_epoch(0, limit_batches=TRAINER_BATCHES)`` with every step
    timed (CUDA events at its start, after each stage, at its end) and its
    launches counted.  Returns (steps, the launches of the run, peak bytes)."""
    import torch

    stages = ("inputs", "forward", "backward", "optimizer")
    step_fn = trainer.train_step
    steps = []

    def timed_step(state, batch, generator):
        before = dict(ws.launches)
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + stages}
        ev["start"].record()
        state, metrics = step_fn(state, batch, generator, stage=lambda name: ev[name].record())
        steps.append({"events": ev, "metrics": metrics,
                      "launches": {k: ws.launches[k] - before[k] for k in before}})
        return state, metrics

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    ws.reset_launches()
    trainer.train_one_epoch(0, limit_batches=TRAINER_BATCHES)
    torch.cuda.synchronize()
    launches = dict(ws.launches)
    trainer.train_step = step_fn
    for s in steps:
        ev = s["events"]
        s["in_step_ms"] = ev["start"].elapsed_time(ev["optimizer"])
        marks = [ev["start"]] + [ev[name] for name in stages]
        s["stage_ms"] = {n: a.elapsed_time(b) for n, a, b in zip(stages, marks, marks[1:])}
        s["losses"] = {k: float(v) for k, v in s.pop("metrics").items()}
    for prev, s in zip(steps, steps[1:]):  # one step's end to the next: loader in the loop
        s["ms"] = prev["events"]["optimizer"].elapsed_time(s["events"]["optimizer"])
    for s in steps:
        del s["events"]
    return steps, launches, torch.cuda.max_memory_allocated(dev)


def count_per_batch(ws, stream_fns):
    """``stream_fns`` wrapped to record each batch's launches (encode, then
    correlate) into the returned list."""
    encode, correlate = stream_fns
    per_batch = []

    def counted_encode(model, points):
        per_batch.append(dict(ws.launches))
        return encode(model, points)

    def counted_correlate(model, pyr_new, pyr_prev):
        out = correlate(model, pyr_new, pyr_prev)
        per_batch[-1] = {k: ws.launches[k] - v for k, v in per_batch[-1].items()}
        return out

    return (counted_encode, counted_correlate), per_batch


def eval_kernel_checks(ws, nbr, trainer, dev):
    """Phase 7's kernel checks: the select calls of the first batch of
    streaming eval (``encode_step`` and ``correlate_step`` at B) and of the
    same pairs through pairwise eval (``eval_step``, its 2B tower) are
    recorded, and every call is replayed through the kernel and its plain
    version, as in phase 3.  Returns, per eval path, the calls checked and
    the batch of each kernel's calls, and the largest error."""
    import torch

    from efficientlo_net_torch.data.loader import make_batch, quantize_points, to_device
    from efficientlo_net_torch.evaluation.runner import sequence_indices

    model, ds, bsz = trainer.state.model, trainer.dataset, trainer.train_cfg.batch_size
    encode, correlate = trainer.stream_eval_fns
    block = quantize_points(np.stack([ds.read_scan(KITTI_SEQ, f) for f in range(bsz)]))
    with recording(ws) as streaming:
        pyr = encode(model, to_device({"points": block}, dev)["points"])
        # frame 0 pairs with itself, frame i with i - 1
        prev = [tuple(torch.cat([a[:1], a[:-1]]) for a in level) for level in pyr]
        correlate(model, pyr, prev)
    pairs = make_batch(ds, sequence_indices(KITTI_SEQ)[:bsz], np.random.default_rng(SEED),
                       training=False)
    pairs = dict(pairs, pc1=quantize_points(pairs["pc1"]), pc2=quantize_points(pairs["pc2"]))
    with recording(ws) as pairwise:
        trainer.eval_step(model, to_device(pairs, dev))
    out = {}
    for path, calls in (("streaming", streaming), ("pairwise", pairwise)):
        counts = {k: len(v) for k, v in calls.items()}
        check(counts == {"window_select": len(SELECT_SITES),
                         "select_and_group": len(GROUP_SITES)},
              f"one {path} eval batch made {counts} kernel calls")
        for args in calls["window_select"]:
            check_select_site(ws, nbr, args)
        errs = [check_group_site(ws, nbr, args)[1] for args in calls["select_and_group"]]
        out[path] = {"checked": counts,
                     "max_abs_err": {"window_select": 0.0, "select_and_group": max(errs)},
                     "batch": {k: sorted({a[0].shape[0] for a in v}) for k, v in calls.items()}}
    return out


def kitti_tree(cfg, base):
    """Sequence 04 written under ``base`` as a KITTI tree for phases 7 and
    9: 271 full-width frames, 150k points each, KITTI_STEP m apart along x
    through ``random_scene`` blocks.  Returns (dataset root, gt_dir,
    description)."""
    from efficientlo_net_torch.data.kitti import SEQ_LENGTH_TABLE

    # numpy only: writes a KITTI tree.  Taken by its bare name, as the card
    # tests take it: an installed package named ``tests`` would shadow
    # ``tests.torch_cases``.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_cases import build_fake_kitti

    n_frames = SEQ_LENGTH_TABLE[KITTI_SEQ + 1] - SEQ_LENGTH_TABLE[KITTI_SEQ]
    t0 = time.perf_counter()
    world = kitti_world(cfg.sensor, (n_frames - 1) * KITTI_STEP)
    root, gt_dir, written = build_fake_kitti(
        base, world, cfg.sensor.num_points, step=KITTI_STEP,
        radius=cfg.sensor.max_planar_radius, seq=KITTI_SEQ, n_frames=n_frames)
    return root, gt_dir, {"frames": n_frames, "path_m": (n_frames - 1) * KITTI_STEP,
                          "world_points": len(world), "bytes": written,
                          "seconds": time.perf_counter() - t0}


def make_trainer(cfg, tcfg, tree, log_dir, dev):
    from efficientlo_net_torch.training.trainer import Trainer

    root, gt_dir, _ = tree
    return Trainer(cfg, tcfg, root, log_dir, gt_dir, train_list=[KITTI_SEQ],
                   val_list=[KITTI_SEQ], device=dev)


def trainer_steps(ws, trainer, tcfg, dev):
    """TRAINER_BATCHES steps of ``trainer`` (its weights loaded) through the
    loader, checked: 23 + 0 launches each, finite losses, ``w_x`` / ``w_q``
    moved.  Returns (the run's numbers, its launches)."""
    per_step = {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0}
    w0 = (trainer.state.w_x.item(), trainer.state.w_q.item())
    t0 = time.perf_counter()
    steps, launches, peak = train_through_trainer(ws, trainer, dev)
    train_s = time.perf_counter() - t0
    state = trainer.state
    check(state.step == TRAINER_BATCHES, f"trainer took {state.step} steps, "
                                         f"not {TRAINER_BATCHES}")
    for i, s in enumerate(steps):
        check(s["launches"] == per_step, f"trainer step {i} launched {s['launches']}, "
                                         f"expected {per_step}")
        check(all(np.isfinite(v) for v in s["losses"].values()),
              f"trainer step {i}: non-finite loss {s['losses']}")
    check(state.w_x.item() != w0[0] and state.w_q.item() != w0[1], "w_x / w_q did not move")
    timed = steps[TIMED_STEPS]
    ms = statistics.median(s["ms"] for s in timed)
    return {"steps": len(steps), "launches_per_step": steps[0]["launches"],
            "ms_per_step_median": ms, "ms_per_step": [s.get("ms") for s in steps],
            "in_step_ms": [s["in_step_ms"] for s in steps],
            # the device's wait between one step's end and the next's start
            "gap_ms_median": statistics.median(s["ms"] - s["in_step_ms"] for s in timed),
            "samples_per_s": tcfg.batch_size * 1000.0 / ms,
            "stage_ms_median": {n: statistics.median(s["stage_ms"][n] for s in timed)
                                for n in steps[0]["stage_ms"]},
            "peak_memory_bytes": peak, "seconds": train_s,
            "losses": [s["losses"]["loss"] for s in steps],
            "w_x": [w0[0], state.w_x.item()], "w_q": [w0[1], state.w_q.item()]}, launches


def trainer_eval_phase(ws, nbr, cfg, tcfg, card, dev, tree, work):
    """Phase 7: the trainer (device projection) and sequence-eval paths over
    the written KITTI ``tree``, logging under ``work``.  Returns each path's
    counted launches for the kernels line, the trainer's numbers, and the
    trained state with the t_rel that ``validate()`` gave it (phase 10)."""
    import torch

    from efficientlo_net_torch.evaluation.runner import (predict_sequence,
                                                         predict_sequence_streaming)

    n_frames = tree[2]["frames"]
    n_batches = -(-n_frames // tcfg.batch_size)
    per_step = {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0}
    per_batch_expected = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    # ---- training through the loader ------------------------------------------
    check(not tcfg.resolved_host_projection(), "phase 7 measures device projection")
    trainer = make_trainer(cfg, tcfg, tree, work, dev)
    scan_points = [int(np.any(trainer.dataset.read_scan(KITTI_SEQ, f) != 0, axis=-1).sum())
                   for f in (0, n_frames // 2, n_frames - 1)]
    check(min(scan_points) == cfg.sensor.num_points,
          f"scans of {scan_points} points, not {cfg.sensor.num_points}")
    meta = trainer.load_pretrained(WEIGHTS)
    train, train_launches = trainer_steps(ws, trainer, tcfg, dev)
    state = trainer.state

    # ---- checkpoint round trip --------------------------------------------
    t0 = time.perf_counter()
    step = trainer.ckpt.save(state, epoch=0)
    save_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(os.path.join(trainer.ckpt.directory, f"ckpt_{step}.pt"))
    other = make_trainer(cfg, tcfg, tree, work, dev)
    t0 = time.perf_counter()
    other.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(other.start_epoch == 1, f"restored run resumes at epoch {other.start_epoch}")
    check(other.state.step == TRAINER_BATCHES, f"restored step {other.state.step}")
    want, got = state_tensors(state), state_tensors(other.state)
    check(want.keys() == got.keys(), "restored state holds other tensors")
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    check(not differ, f"restored tensors differ: {differ[:5]}")
    del other, want, got
    checkpoint = {"bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
                  "tensors": len(state_tensors(state)), "bit_equal": True}

    # ---- sequence eval -----------------------------------------------------
    stream_fns = trainer.stream_eval_fns
    trainer.stream_eval_fns, per_batch = count_per_batch(ws, stream_fns)
    ws.reset_launches()
    t0 = time.perf_counter()
    val = trainer.validate()
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    eval_launches = dict(ws.launches)
    trainer.stream_eval_fns = stream_fns
    check(len(per_batch) == n_batches, f"{len(per_batch)} eval batches, not {n_batches}")
    for i, c in enumerate(per_batch):
        check(c == per_batch_expected, f"eval batch {i} launched {c}, "
                                       f"expected {per_batch_expected}")
    val_dir = os.path.join(work, "val")
    check(os.path.exists(os.path.join(val_dir, f"{KITTI_SEQ:02d}_pred.txt")),
          "validate() wrote no trajectory")
    # the segment errors validate() wrote: first_frame r_err t_err length speed
    errors = np.loadtxt(os.path.join(val_dir, f"{KITTI_SEQ:02d}_errors.txt"), ndmin=2)
    t_rel = float(np.mean(errors[:, 2])) * 100.0
    r_rel = float(np.mean(errors[:, 1])) / np.pi * 180.0 * 100.0
    check(np.isfinite(t_rel) and np.isfinite(r_rel), f"t_rel {t_rel}, r_rel {r_rel}")
    check(abs(t_rel - val) <= 1e-9 * max(1.0, abs(val)),
          f"validate() gave t_rel {val}, its segment errors {t_rel}")

    model, ds, bsz = state.model, trainer.dataset, tcfg.batch_size
    t0 = time.perf_counter()
    q_s, t_s = predict_sequence_streaming(*stream_fns, model, ds, KITTI_SEQ, bsz)
    stream_s = time.perf_counter() - t0
    before = dict(ws.launches)
    t0 = time.perf_counter()
    q_p, t_p = predict_sequence(trainer.eval_step, model, ds, KITTI_SEQ, bsz)
    pair_s = time.perf_counter() - t0
    pair_launches = {k: ws.launches[k] - before[k] for k in before}
    check(pair_launches == {k: v * n_batches for k, v in per_batch_expected.items()},
          f"pairwise eval launched {pair_launches} over {n_batches} batches")
    for a in (q_s, t_s, q_p, t_p):
        check(a.shape[0] == n_frames and np.all(np.isfinite(a)), "eval poses")
    q_err = float(np.abs(q_s - q_p).max())
    t_err = float(np.abs(t_s - t_p).max())
    check(q_err <= EVAL_QT_ATOL and t_err <= EVAL_QT_ATOL,
          f"streaming and pairwise eval differ: q {q_err}, t {t_err}")
    vs_plain = eval_kernel_checks(ws, nbr, trainer, dev)
    sequence_eval = {
        "frames": n_frames, "batch_size": bsz, "batches": n_batches,
        "launches_per_batch": per_batch[0], "launches": eval_launches,
        "t_rel": t_rel, "r_rel": r_rel, "segments": len(errors), "validate_s": validate_s,
        "validate_frames_per_s": n_frames / validate_s,
        "streaming_frames_per_s": n_frames / stream_s,
        "pairwise_frames_per_s": n_frames / pair_s,
        "pairwise_launches_per_batch": per_batch_expected,
        "q_max_abs_err_stream_vs_pairwise": q_err,
        "t_max_abs_err_stream_vs_pairwise": t_err, "tolerance": EVAL_QT_ATOL,
        "kernel_vs_plain": vs_plain}
    emit({"phase": "trainer_eval",
          "config": "ModelConfig() full HDL-64 64x1800, TrainConfig(host_projection=False)",
          "weights": WEIGHTS, "trained_epochs": meta.get("trained_epochs"),
          "tree": dict(tree[2], points_per_scan=scan_points),
          "train": train, "checkpoint": checkpoint, "sequence_eval": sequence_eval, "card": card})
    return {"trainer": {"launches": train_launches, "per_call": per_step, "unit": "step",
                        "calls": TRAINER_BATCHES},
            "sequence_eval": {"launches": eval_launches, "per_call": per_batch_expected,
                              "unit": "batch", "calls": n_batches,
                              "max_abs_err": {k: max(v["max_abs_err"][k] for v in vs_plain.values())
                                              for k in per_batch_expected}}}, train, (state, val)


# ---- phase 8: SLAM over a rendered closed-loop drive ---------------------------

_RENDERER = None  # the DriveRenderer of one render worker process


def _render_init(world, dynamics, height, width, vfov_up_deg, vfov_down_deg):
    global _RENDERER
    from efficientlo_net_torch.data.synthetic import DriveRenderer

    _RENDERER = DriveRenderer(world, height=height, width=width, vfov_up_deg=vfov_up_deg,
                              vfov_down_deg=vfov_down_deg, dynamics=dynamics)


def _render_frame(pose, frame, num_points):
    """Frame ``frame``'s scan, drawn from a generator of its own so that the
    workers may render in any order, and the seconds it took."""
    t0 = time.perf_counter()
    scan = _RENDERER.render(pose, num_points, np.random.default_rng([SLAM_SEED, frame]),
                            frame=frame)
    return scan, time.perf_counter() - t0


def drive_world():
    """(world_T_lidar poses (SLAM_FRAMES, 4, 4), static world points, moving
    objects) of the loop drive, from SLAM_SEED, in the order of
    tools/synthetic_drive.py."""
    from efficientlo_net_torch.data.synthetic import (build_world, make_dynamic_objects,
                                                      synthetic_trajectory)

    rng = np.random.default_rng(SLAM_SEED)
    traj = synthetic_trajectory(SLAM_FRAMES, rng, kind="loop", speed=SLAM_SPEED,
                                radius=SLAM_CORNER_RADIUS)
    world = build_world(traj, rng)
    return traj, world, make_dynamic_objects(traj, rng, max(4, SLAM_FRAMES // 120))


@contextlib.contextmanager
def rendered_scans(traj, world, dynamics, sensor):
    """An iterator of (scan, render seconds) in frame order, rendered by
    RENDER_WORKERS spawned processes at most RENDER_AHEAD frames ahead of
    the consumer.  The pool is shut down when the block ends."""
    import collections
    import concurrent.futures
    import multiprocessing

    # one thread per worker: numpy's BLAS threads in six workers would
    # oversubscribe the host's cores and slow the stream's launches
    threads = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    pool = concurrent.futures.ProcessPoolExecutor(
        RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_render_init,
        initargs=(world, dynamics, sensor.height, sensor.width, sensor.vertical_fov_up_deg,
                  sensor.vertical_fov_down_deg))

    def frames():
        pending = collections.deque()
        for i in range(len(traj)):
            while len(pending) < RENDER_AHEAD and i + len(pending) < len(traj):
                k = i + len(pending)
                pending.append(pool.submit(_render_frame, traj[k], k, sensor.num_points))
            yield pending.popleft().result()

    try:
        yield frames()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measure_launches(seeded):
    """Launches of one measure_relative call: 1 + r towers (4
    select_and_group each) and r correlation passes (14 window_select and 1
    select_and_group each) with a seed, one more of each without."""
    r = SLAM_REFINEMENTS
    towers, passes = (1 + r, r) if seeded else (2 + r, r + 1)
    return {"window_select": len(SELECT_SITES) * passes,
            "select_and_group": (len(GROUP_SITES) - 1) * towers + passes}


class ClosureGate:
    """The closure function of tools/synthetic_drive.py (stage slam): the
    candidate pair measured both ways with ``measure_relative``, kept when
    forward @ backward is within GATE_T_M and GATE_R_DEG of the identity.
    Records every call's launches and ms, and every candidate."""

    def __init__(self, stream, ws):
        self.stream, self.ws = stream, ws
        self.calls, self.candidates = [], []

    def measure(self, img_i, img_j, t_init):
        before = dict(self.ws.launches)
        t0 = time.perf_counter()
        out = self.stream.measure_relative(img_i, img_j, t_init=t_init,
                                           refinements=SLAM_REFINEMENTS)
        self.calls.append({"ms": (time.perf_counter() - t0) * 1e3, "seeded": t_init is not None,
                           "launches": {k: self.ws.launches[k] - before[k] for k in before}})
        return out

    def __call__(self, img_j, img_i, rel_init=None):
        fwd = self.measure(img_j, img_i, rel_init)
        bwd = self.measure(img_i, img_j, None if rel_init is None else np.linalg.inv(rel_init))
        gap = fwd @ bwd
        t_gap = float(np.linalg.norm(gap[:3, 3]))
        r_gap = float(np.degrees(np.arccos(np.clip((np.trace(gap[:3, :3]) - 1.0) / 2.0,
                                                   -1.0, 1.0))))
        ok = t_gap <= GATE_T_M and r_gap <= GATE_R_DEG
        self.candidates.append({"t_gap_m": t_gap, "r_gap_deg": r_gap, "accepted": ok,
                                "images": (img_j, img_i), "rel_init": rel_init, "fwd": fwd})
        return fwd if ok else None


@contextlib.contextmanager
def logged_solves(pg):
    """Wrap ``pose_graph.optimize``: each call's ms (host clock; the caller
    reads the result back, so the call has ended) and, under key "last",
    the arguments and outputs of the latest call with a prior and scan
    factors; under "global", those of every call while ``keep_all`` is set."""
    log = {"ms": [], "last": None, "global": [], "keep_all": False}
    original = pg.optimize

    def optimize(poses, factors, cfg=pg.GaussNewtonConfig(), prior=None, scan_factors=None,
                 group=None):
        check(group is None, "phase 8's SLAM runs ungrouped")
        t0 = time.perf_counter()
        out = original(poses, factors, cfg, prior=prior, scan_factors=scan_factors)
        float(out[1][-1])
        log["ms"].append((time.perf_counter() - t0) * 1e3)
        call = {"args": (poses, factors, cfg, prior, scan_factors), "out": out}
        if log["keep_all"]:
            log["global"].append(call)
        elif prior is not None and scan_factors is not None:
            log["last"] = call
        return out

    pg.optimize = optimize
    try:
        yield log
    finally:
        pg.optimize = original


def on(device, obj):
    """``obj`` with its tensors (and those of a dataclass's fields) on
    ``device``."""
    import dataclasses

    import torch

    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                           for f in dataclasses.fields(obj)
                                           if torch.is_tensor(getattr(obj, f.name))})
    return obj


def cpu_solve(pg, call):
    """A captured ``optimize`` call re-run on the CPU from the same inputs:
    ((poses, chi2 history), ms)."""
    t0 = time.perf_counter()
    out = pg.optimize(*(on("cpu", a) for a in call["args"]))
    return out, (time.perf_counter() - t0) * 1e3


def compare_solve(card_out, cpu_out, what, failures):
    """The card's poses and chi2 history against the CPU's; a disagreement
    is appended to ``failures``."""
    import torch

    poses, history = (x.cpu() for x in card_out)
    cpu_poses, cpu_history = cpu_out
    pose_err = float((poses - cpu_poses).abs().max())
    chi2_err = float(((history - cpu_history).abs() / cpu_history.abs().clamp(min=1e-6)).max())
    expect(failures, bool(torch.isfinite(poses).all()), f"{what}: non-finite poses")
    expect(failures, pose_err <= SOLVE_POSE_ATOL and chi2_err <= SOLVE_CHI2_RTOL,
           f"{what}: card and CPU differ: poses {pose_err}, chi2 {chi2_err} (relative)")
    return {"pose_max_abs_err": pose_err, "chi2_max_rel_err": chi2_err}


def geometry_vs_cpu(sfm, sensor, img_a, img_b, t_ab, failures):
    """compute_normals, projective_association and icp_refine of a revisit
    pair on the card and on the CPU; disagreements are appended to
    ``failures``."""
    import torch

    out = {}
    n_a, ok_a = sfm.compute_normals(img_a)
    n_b, _ = sfm.compute_normals(img_b)
    n_a_c, ok_a_c = sfm.compute_normals(img_a.cpu())
    n_b_c, _ = sfm.compute_normals(img_b.cpu())
    pixels = ok_a.numel()
    both = (ok_a.cpu() & ok_a_c)
    out["normals"] = {"pixels": pixels, "valid": int(ok_a.sum()),
                      "mask_flips": int((ok_a.cpu() != ok_a_c).sum()),
                      "max_abs_err": float((n_a.cpu() - n_a_c)[both].abs().max())}
    expect(failures, out["normals"]["mask_flips"] <= PIXEL_FLIP_FRAC * pixels
           and out["normals"]["max_abs_err"] <= NORMAL_ATOL,
           f"compute_normals: card and CPU differ: {out['normals']}")

    t = torch.as_tensor(t_ab, dtype=torch.float32, device=img_a.device)
    card = sfm.projective_association(img_b, img_a, n_a, t, sensor, normals_j=n_b)
    cpu = sfm.projective_association(img_b.cpu(), img_a.cpu(), n_a_c, t.cpu(), sensor,
                                     normals_j=n_b_c)
    # a point differs when its gate decision does, or when it matched another
    # pixel (another anchor point; the normals there differ by rounding only)
    n_err = (card.n_i.cpu() - cpu.n_i).abs().amax(-1)
    moved = (card.q_i.cpu() != cpu.q_i).any(-1) | (n_err > NORMAL_ATOL)
    differ = (card.w.cpu() != cpu.w) | (moved & (cpu.w > 0))
    out["association"] = {"points": cpu.w.numel(), "matched": int(cpu.w.sum()),
                          "differ": int(differ.sum()),
                          "normal_max_abs_err": float(n_err[cpu.w > 0].max())}
    expect(failures, out["association"]["differ"] <= PIXEL_FLIP_FRAC * cpu.w.numel(),
           f"projective_association: card and CPU differ: {out['association']}")

    t0 = time.perf_counter()
    icp = sfm.icp_refine(img_a, img_b, t, sensor)
    icp = [x.cpu() for x in icp]
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    icp_c = sfm.icp_refine(img_a.cpu(), img_b.cpu(), t.cpu(), sensor)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    errs = [float((a - b).abs().max()) for a, b in zip(icp, icp_c)]
    errs[2] /= max(float(icp_c[2]), 1e-6)  # the RMS, relative
    out["icp"] = {"t_max_abs_err": errs[0], "inlier_frac": [float(icp[1]), float(icp_c[1])],
                  "rms_m": [float(icp[2]), float(icp_c[2])], "ms": card_ms, "cpu_ms": cpu_ms,
                  "moved_m": float(np.linalg.norm(icp_c[0][:3, 3].numpy() - t_ab[:3, 3]))}
    expect(failures, errs[0] <= ICP_ATOL and errs[1] <= PIXEL_FLIP_FRAC
           and errs[2] <= ICP_RMS_RTOL,
           f"icp_refine: card and CPU differ: pose {errs[0]}, inlier fraction {errs[1]}, "
           f"RMS {errs[2]} (relative)")
    return out


def trajectory_scores(gt, est):
    """t_rel (%), r_rel (deg / 100 m) over 100 m segments and the
    unaligned ATE (m) of ``est`` against ``gt``: lists of 4x4 poses."""
    from efficientlo_net_torch.evaluation.kitti_metrics import evaluate_sequence

    res = evaluate_sequence(gt, est)
    return {"t_rel": res.t_rel, "r_rel": res.r_rel, "ate_m": res.ate_m}


def reanchor(kf_frames, kf_poses, raw):
    """Per-frame poses from keyframe poses: frame f after keyframe k keeps
    its raw motion relative to k (as tools/synthetic_drive.py)."""
    out, ki = [], 0
    for f in range(len(raw)):
        while ki + 1 < len(kf_frames) and kf_frames[ki + 1] <= f:
            ki += 1
        out.append(kf_poses[ki] @ np.linalg.inv(raw[kf_frames[ki]]) @ raw[f])
    return out


def slam_phase(ws, nbr, cfg, model, card, dev):
    """Phase 8: SLAM over the rendered loop drive.  Returns the counted
    launches of the path for the kernels line."""
    import torch
    from scipy.spatial import cKDTree

    from efficientlo_net_torch.backend import pose_graph as pg
    from efficientlo_net_torch.backend import scan_factors as sfm
    from efficientlo_net_torch.backend.slam import SlamConfig, SlidingWindowSLAM
    from efficientlo_net_torch.evaluation.odometry import quat_to_mat_np
    from efficientlo_net_torch.evaluation.streaming import OdometryStream

    t0 = time.perf_counter()
    traj, world, dynamics = drive_world()
    world_s = time.perf_counter() - t0
    stream = OdometryStream(model, cfg, device=dev)
    gate = ClosureGate(stream, ws)
    slam = SlidingWindowSLAM(
        SlamConfig(keyframe_distance=2.0, window_size=20, optimize_every=5,
                   closure_radius=SLAM_CLOSURE_RADIUS, closure_min_gap=15,
                   closure_search_all=True, use_scan_factors=True,
                   gn=pg.GaussNewtonConfig(robust_kernel="gm")),
        closure_fn=gate, scan_sensor=cfg.sensor)
    check(slam.device.type == dev.type, f"the solver runs on {slam.device}, not {dev}")
    window_ms = []
    optimize_window = slam.optimize_window

    def timed_optimize_window():
        t = time.perf_counter()
        chi2 = optimize_window()
        window_ms.append((time.perf_counter() - t) * 1e3)
        return chi2

    slam.optimize_window = timed_optimize_window
    raw = [np.eye(4)]
    render_s, push_ms, add_ms = [], [], []
    t0 = time.perf_counter()
    with logged_solves(pg) as solves:
        ws.reset_launches()
        with rendered_scans(traj, world, dynamics, cfg.sensor) as scans:
            for i, (scan, secs) in enumerate(scans):
                render_s.append(secs)
                t = time.perf_counter()
                q, tr = stream.push(scan)
                push_ms.append((time.perf_counter() - t) * 1e3)
                img = stream.last_projection[0]  # the range image stays on the card
                if i == 0:
                    slam.set_initial_payload(img)
                    continue
                m = np.eye(4)
                m[:3, :3] = quat_to_mat_np(np.asarray(q, np.float64) / np.linalg.norm(q))
                m[:3, 3] = tr
                raw.append(raw[-1] @ m)
                t = time.perf_counter()
                slam.add_frame(q, tr, payload=img)
                add_ms.append((time.perf_counter() - t) * 1e3)
        drive_s = time.perf_counter() - t0
        slam.optimize_window()
        launches = dict(ws.launches)
        window_poses = [p.copy() for p in slam.kf_poses]
        solves["keep_all"] = True
        t0 = time.perf_counter()
        slam.global_optimize()
        global_s = time.perf_counter() - t0
    slam.optimize_window = optimize_window

    # ---- launches of the path ---------------------------------------------------
    # every check from here on is collected, so that the phase prints what it
    # measured before it fails
    failures = []
    n_push = len(push_ms)
    per_push = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    for c in gate.calls:
        expect(failures, c["launches"] == measure_launches(c["seeded"]),
               f"a measure_relative call launched {c['launches']}, expected "
               f"{measure_launches(c['seeded'])}")
    expected = {k: n_push * per_push[k] + sum(c["launches"][k] for c in gate.calls)
                for k in per_push}
    expect(failures, launches == expected, f"the drive launched {launches}, expected {expected}")
    check(gate.candidates, "no closure candidate was measured")
    kf = np.stack(slam.kf_poses)
    expect(failures, np.all(np.isfinite(kf)) and np.all(np.isfinite(np.stack(window_poses))),
           "non-finite keyframe pose")

    # ---- accuracy against the drive's own poses -----------------------------------
    gt = [np.linalg.inv(traj[0]) @ p for p in traj]
    frames = np.asarray(slam.kf_frame_ids)
    scores = {"stream": trajectory_scores(gt, raw),
              "window": trajectory_scores(gt, reanchor(frames, window_poses, raw)),
              "global": trajectory_scores(gt, reanchor(frames, slam.kf_poses, raw))}
    t0 = time.perf_counter()
    map_pts = slam.render_map(voxel=0.3, max_range=30.0)
    map_s = time.perf_counter() - t0
    anchored = map_pts @ traj[0][:3, :3].T + traj[0][:3, 3]
    map_dist = float(np.median(cKDTree(world).query(anchored, workers=-1)[0]))
    expect(failures, len(map_pts) > 0 and np.isfinite(map_dist), "empty map")

    # ---- card against CPU, and the kernels against the plain selects ------------
    check(solves["last"] is not None, "no window solve had both a prior and scan factors")
    window = solves["last"]
    args = window["args"]
    t0 = time.perf_counter()
    pg.optimize(*args)[1][-1].item()
    window_card_ms = (time.perf_counter() - t0) * 1e3
    cpu_out, cpu_ms = cpu_solve(pg, window)
    vs_cpu = {"window": compare_solve(window["out"], cpu_out, "window solve", failures)}
    vs_cpu["window"].update(ms=window_card_ms, cpu_ms=cpu_ms, nodes=int(args[0].shape[0]),
                            factors=int(args[1].valid.sum()),
                            scan_pairs=int(args[4].src.numel()),
                            scan_points=int(args[4].w.numel()),
                            scan_matched=int((args[4].w > 0).sum()))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # a caller that allows TF32
    try:
        tf32_out = pg.optimize(*args)
        expect(failures, torch.get_float32_matmul_precision() == "high",
               "optimize did not restore the caller's matmul precision")
    finally:
        torch.set_float32_matmul_precision(precision)
    vs_cpu["window_under_tf32"] = compare_solve(tf32_out, cpu_out, "window solve under TF32",
                                                failures)
    # what the guard prevents: the same solve with full_fp32 unable to
    # switch TF32 off (recorded, not checked)
    set_precision = torch.set_float32_matmul_precision
    set_precision("high")
    torch.set_float32_matmul_precision = lambda p: None
    try:
        unguarded_out = pg.optimize(*args)
    finally:
        torch.set_float32_matmul_precision = set_precision
        set_precision(precision)
    vs_cpu["window_tf32_unguarded"] = compare_solve(unguarded_out, cpu_out,
                                                    "window solve, TF32 unguarded", [])
    check(len(solves["global"]) == 2, f"global_optimize made {len(solves['global'])} solves")
    vs_cpu["global"] = []
    for i, call in enumerate(solves["global"]):
        cpu_out, cpu_ms = cpu_solve(pg, call)
        vs_cpu["global"].append(dict(compare_solve(call["out"], cpu_out, f"global solve {i}",
                                                   failures),
                                     cpu_ms=cpu_ms, ms=solves["ms"][-2 + i]))
    first = next((c for c in gate.candidates if c["accepted"]), gate.candidates[0])
    img_a, img_b = first["images"]
    t_ab = first["fwd"] if first["accepted"] else first["rel_init"]
    vs_cpu.update(geometry_vs_cpu(sfm, cfg.sensor, img_a, img_b, t_ab, failures))

    kernel_m = stream.measure_relative(img_a, img_b, t_init=first["rel_init"],
                                       refinements=SLAM_REFINEMENTS)
    with plain_selects(ws, nbr):
        plain_m = stream.measure_relative(img_a, img_b, t_init=first["rel_init"],
                                          refinements=SLAM_REFINEMENTS)
    measure_err = float(np.abs(kernel_m - plain_m).max())
    expect(failures, measure_err <= MEASURE_ATOL,
           f"measure_relative through the kernels differs from the plain selects: {measure_err}")

    accepted = [c for c in gate.candidates if c["accepted"]]
    call_ms = [c["ms"] for c in gate.calls]
    emit({"phase": "slam", "config": "ModelConfig() full HDL-64 64x1800", "weights": WEIGHTS,
          "drive": {"frames": SLAM_FRAMES, "kind": "loop", "speed_m": SLAM_SPEED,
                    "corner_radius_m": SLAM_CORNER_RADIUS, "seed": SLAM_SEED,
                    "path_m": float(np.sum(np.linalg.norm(np.diff(traj[:, :3, 3], axis=0),
                                                          axis=1))),
                    "world_points": len(world), "moving_objects": len(dynamics),
                    "points_per_scan": cfg.sensor.num_points, "world_s": world_s,
                    "render_s_total": float(np.sum(render_s)),
                    "render_s_median": statistics.median(render_s),
                    "render_workers": RENDER_WORKERS, "drive_s": drive_s},
          "slam_config": {"closure_radius_m": SLAM_CLOSURE_RADIUS, "closure_min_gap": 15,
                          "window_size": 20, "optimize_every": 5, "refinements": SLAM_REFINEMENTS,
                          "gate": {"t_m": GATE_T_M, "r_deg": GATE_R_DEG},
                          "solver_device": str(slam.device)},
          "ms_per_push": {"median": statistics.median(push_ms), "max": max(push_ms)},
          "ms_per_add_frame": {"median": statistics.median(add_ms), "max": max(add_ms)},
          "ms_per_optimize_window": {"median": statistics.median(window_ms),
                                     "max": max(window_ms), "calls": len(window_ms)},
          "ms_per_optimize_call": {"median": statistics.median(solves["ms"]),
                                   "max": max(solves["ms"]), "calls": len(solves["ms"])},
          "ms_per_measure_relative": {"median": statistics.median(call_ms),
                                      "max": max(call_ms), "calls": len(call_ms)},
          "global_optimize_s": global_s, "keyframes": len(slam.kf_poses),
          "candidates": len(gate.candidates), "accepted_closures": len(accepted),
          "closure_pairs": sorted([int(a), int(b)] for a, b in slam.closed_pairs),
          "gaps": [{k: c[k] for k in ("t_gap_m", "r_gap_deg", "accepted")}
                   for c in gate.candidates],
          "launches": launches, "launches_per_push": per_push,
          "launches_per_measure_relative": measure_launches(True),
          "scores": scores, "map_points": len(map_pts), "map_s": map_s,
          "map_median_dist_m": map_dist, "vs_cpu": vs_cpu,
          "tolerance": {"solve_pose_atol": SOLVE_POSE_ATOL, "solve_chi2_rtol": SOLVE_CHI2_RTOL,
                        "icp_atol": ICP_ATOL, "icp_rms_rtol": ICP_RMS_RTOL,
                        "pixel_flip_frac": PIXEL_FLIP_FRAC,
                        "normal_atol": NORMAL_ATOL, "measure_atol": MEASURE_ATOL},
          "measure_relative_kernel_vs_plain_max_abs_err": measure_err,
          "failures": failures, "card": card})
    check(not failures, "; ".join(failures))
    return {"slam": {"launches": launches, "per_call": measure_launches(True),
                     "unit": "measure_relative", "calls": len(gate.calls),
                     "pushes": n_push, "per_push": per_push}}


# ---- phase 9: host projection ----------------------------------------------------


def differing_pixels(a, b):
    """Share of the pixels of two (B, H, W, 3) images that differ."""
    import torch

    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return float(torch.any(a != b, dim=-1).float().mean())


def host_ms(fn, reps):
    """Median host-clock ms of ``reps`` calls (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def projection_checks(cfg, scans, raw, dev):
    """Phase 9b: the exact projections on the card against each other, the
    CPU's and the native projector's, on the stream's scans (cropped) and
    one B=8 train batch (cropped and perturbed by ``crop_and_augment``);
    the fused host pass against the two-pass one; and their times."""
    import torch

    from efficientlo_net_torch.data import native_io
    from efficientlo_net_torch.data.augmentation import mirror_batch
    from efficientlo_net_torch.data.host_preprocess import augment_project_batch, crop_and_augment
    from efficientlo_net_torch.ops.projection import project_to_range_image

    s = cfg.sensor
    h, w = s.height, s.width
    clouds = np.stack(scans)
    keep = np.any(clouds != 0, -1) & (np.linalg.norm(clouds[..., :2], axis=-1)
                                      <= s.max_planar_radius)
    pc1, pc2 = crop_and_augment(raw["pc1"], raw["pc2"], raw["T_trans"], raw["aug_frame"],
                                s.max_planar_radius)
    cases = {"stream_scans": (clouds * keep[..., None]).astype(np.float32),
             "train_pc1": pc1, "train_pc2": pc2}
    out = {}
    for name, pts in cases.items():
        card_pts = torch.as_tensor(pts, device=dev)
        sort = project_to_range_image(card_pts, None, h, w, s)[0]
        scatter = project_to_range_image(card_pts, None, h, w, s, method="scatter")[0]
        check(torch.equal(sort, scatter), f"{name}: sort and scatter differ on the card")
        cpu = project_to_range_image(torch.as_tensor(pts), None, h, w, s)[0]
        native = native_io.project_batch(pts, h, w, s)
        row = {"clouds": len(pts), "sort_equals_scatter": True,
               "card_vs_cpu_sort": differing_pixels(sort, cpu),
               "native_vs_card_sort": differing_pixels(native, sort)}
        for k in ("card_vs_cpu_sort", "native_vs_card_sort"):
            check(row[k] <= PROJECTION_PIXEL_FRAC, f"{name}: {k} differ on {row[k]} of the pixels")
        out[name] = row
    # the fused pass (with a deferred mirror) against mirror, crop_and_augment, project
    mirrored = mirror_batch(raw, np.random.default_rng(SEED + 5))
    deferred = mirror_batch(raw, np.random.default_rng(SEED + 5), clouds=False)
    check("mirror_sign" in deferred, "the mirror flipped no sample")
    fused = augment_project_batch(deferred, s)
    m1, m2 = crop_and_augment(mirrored["pc1"], mirrored["pc2"], raw["T_trans"],
                              raw["aug_frame"], s.max_planar_radius)
    out["fused_vs_two_pass"] = {k: differing_pixels(fused[k], native_io.project_batch(m, h, w, s))
                                for k, m in (("p1", m1), ("p2", m2))}
    for k, v in out["fused_vs_two_pass"].items():
        check(v <= PROJECTION_PIXEL_FRAC, f"fused {k} differs from two-pass on {v} of the pixels")

    times = {}
    for b, pts in (("B1", cases["stream_scans"][:1]), ("B8", pc1)):
        card_pts = torch.as_tensor(pts, device=dev)
        for method in ("packed", "sort", "scatter"):
            times[f"card_{method}_{b}_ms"] = time_ms(
                lambda: project_to_range_image(card_pts, None, h, w, s, method=method))[0]
    for n in NATIVE_THREADS:
        times[f"native_project_scan_{n}_threads_ms"] = host_ms(
            lambda: native_io.project_scan(scans[0], h, w, s, crop_radius=s.max_planar_radius,
                                           num_threads=n), reps=10)
    times["augment_project_batch_B8_ms"] = host_ms(lambda: augment_project_batch(deferred, s),
                                                   reps=5)
    out["times"] = times
    return out


def host_stream_phase(ws, cfg, model, scans, device_poses, dev):
    """Phase 9c: the host-projected stream over the stream phase's scans.
    Returns its numbers and launches."""
    from efficientlo_net_torch.evaluation.streaming import OdometryStream

    stream = OdometryStream(model, cfg, device=dev, host_projection=True)
    run_stream(stream, ws, scans[:2])  # warm-up outside the counted run
    ws.reset_launches()
    poses, times, per_push = run_stream(stream, ws, scans)
    launches = dict(ws.launches)
    expected = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    for i, counts in enumerate(per_push):
        check(counts == expected, f"host-projected push {i} launched {counts}, expected {expected}")
    for q, t in poses:
        check(np.all(np.isfinite(q)) and np.all(np.isfinite(t)), "non-finite pose")
        check(abs(float(np.linalg.norm(q)) - 1.0) < 1e-3, f"|q| = {np.linalg.norm(q)}")
    ms = statistics.median(times)
    return {"pushes": len(scans), "launches_per_push": per_push[0],
            "ms_per_push_median": ms, "ms_per_push_max": max(times), "frames_per_s": 1000.0 / ms,
            "stage_ms_median": stage_times(stream, scans),
            # not checked: the exact images differ from the packed ones by design
            "q_max_abs_diff_vs_device_projected": max(
                float(np.abs(a[0] - b[0]).max()) for a, b in zip(poses, device_poses)),
            "t_max_abs_diff_vs_device_projected": max(
                float(np.abs(a[1] - b[1]).max()) for a, b in zip(poses, device_poses))}, launches


def host_train_phase(ws, nbr, cfg, tcfg, batches, dev):
    """Phase 9d: the host-projected train step on the host-projected train
    batches (2 warm-up, 10 timed), and the projected step fed the card's own
    device-projected images against the device step.  Returns its numbers
    and the timed run's launches."""
    import torch

    from efficientlo_net_torch.data.host_preprocess import augment_project_batch
    from efficientlo_net_torch.training.step import _forward_inputs, make_train_step

    projected = [augment_project_batch(b, cfg.sensor) for b in batches]
    state, _ = fresh_train_state(cfg, tcfg, dev)
    w0 = (state.w_x.item(), state.w_q.item())
    step = make_train_step(cfg, tcfg, host_projected=True)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    state, _ = run_train(ws, step, state, projected[1:], gen)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats(dev)
    ws.reset_launches()
    state, steps = run_train(ws, step, state, [projected[0]] * TRAIN_STEPS, gen)
    launches = dict(ws.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    expected = checked_step_launches([st["launches"] for st in steps], "host-projected")
    check(state.w_x.item() != w0[0] and state.w_q.item() != w0[1], "w_x / w_q did not move")

    raw = batches[0]
    p1, p2, _, _ = _forward_inputs(raw, cfg.sensor, dev)
    same_images = dict({k: raw[k] for k in ("T_gt", "T_trans", "T_trans_inv", "aug_frame")},
                       p1=p1, p2=p2)
    dev_run = one_step(ws, nbr, cfg, tcfg, raw, dev)
    proj_run = one_step(ws, nbr, cfg, tcfg, same_images, dev, host_projected=True)
    check(proj_run[3] == expected, f"the projected step launched {proj_run[3]}")
    vs_device = compare_steps(proj_run, dev_run, ("projected step", "device step"))
    times = [st["ms"] for st in steps]
    ms = statistics.median(times)
    return {"batch_size": tcfg.batch_size, "warmup_steps": TRAIN_WARMUP, "steps": len(steps),
            "launches_per_step": steps[0]["launches"], "ms_per_step_median": ms,
            "ms_per_step_max": max(times), "samples_per_s": tcfg.batch_size * 1000.0 / ms,
            "stage_ms_median": {n: statistics.median(st["stage_ms"][n] for st in steps)
                                for n in steps[0]["stage_ms"]},
            "peak_memory_bytes": peak, "losses_fixed_batch": [st["losses"] for st in steps],
            "w_x": [w0[0], state.w_x.item()], "w_q": [w0[1], state.w_q.item()],
            "projected_vs_device_step": vs_device}, launches


def busy_share(trace_file, step_name):
    """The device's busy and idle share over a traced window, from the
    Chrome trace's CUDA kernel intervals: the window runs from the start of
    the second ``step_name`` range on the host (the first waits for the
    loader's first batch) to the end of the last kernel; busy is the union
    of the kernel intervals within it.  Also the top device operations by
    summed kernel time."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    starts = sorted(e["ts"] for e in events
                    if e.get("name") == step_name and e.get("cat") == "user_annotation")
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("cat") == "kernel"]
    check(len(starts) >= 2 and kernels, f"the trace holds {len(starts)} '{step_name}' ranges "
                                        f"and {len(kernels)} CUDA kernels")
    begin, end = starts[1], max(k[1] for k in kernels)
    busy, reach = 0.0, begin
    for a, b, _ in sorted(kernels):
        a, b = max(a, reach), min(b, end)
        if b > a:
            busy += b - a
            reach = b
    by_name = {}
    for a, b, name in kernels:
        if b > begin:
            by_name[name] = by_name.get(name, 0.0) + (b - max(a, begin))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    share = busy / (end - begin)
    return {"window_ms": (end - begin) / 1e3, "busy_ms": busy / 1e3, "busy_share": share,
            "idle_share": 1.0 - share, "kernels": sum(1 for k in kernels if k[1] > begin),
            "top_device_ops_ms": [[name, t / 1e3] for name, t in top],
            "trace_bytes": os.path.getsize(trace_file)}


def traced_steps(trainer, log_dir):
    """TRACE_STEPS trainer steps (epoch 1, through the loader) under
    ``utils.profiling.trace``, each in the step's own ``train.step`` span;
    returns ``busy_share`` of the trace."""
    import glob

    import torch

    from efficientlo_net_torch.utils.profiling import trace

    with trace(log_dir):
        trainer.train_one_epoch(1, limit_batches=TRACE_STEPS)
        torch.cuda.synchronize()
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    return busy_share(path, "train.step")


def host_projection_phase(ws, nbr, cfg, tcfg, scans, device_poses, batches, tree, work,
                          device_trainer, native_build, card, dev):
    """Phase 9: the host-projected paths.  Returns their counted launches
    for the kernels line."""
    import dataclasses

    from efficientlo_net_torch.data import native_io
    from efficientlo_net_torch.pretrained import load_model

    t0 = time.perf_counter()
    # a. the native library, built in phase 2; no numpy fallback here
    native = dict(native_build, abi=native_io.abi_version(), available=native_io.available(),
                  fused_available=native_io.fused_available())
    check(native["available"] and native["fused_available"] and native["abi"] == 3,
          f"native library: {native}")
    # b. projections
    projection = projection_checks(cfg, scans, batches[0], dev)
    # c. the host-projected stream
    model, _ = load_model(WEIGHTS, cfg, device=dev)
    stream, stream_launches = host_stream_phase(ws, cfg, model, scans, device_poses, dev)
    del model
    # d. the host-projected train step
    step, step_launches = host_train_phase(ws, nbr, cfg, tcfg, batches, dev)
    # e. the host-projected trainer over phase 7's tree
    host_tcfg = dataclasses.replace(tcfg, host_projection=True)
    trainer = make_trainer(cfg, host_tcfg, tree, os.path.join(work, "host"), dev)
    check(trainer.host_projection, "the trainer does not project on the host")
    trainer.load_pretrained(WEIGHTS)
    train, trainer_launches = trainer_steps(ws, trainer, host_tcfg, dev)
    # f. the device's idle share under the profiler, both trainers
    other = make_trainer(cfg, tcfg, tree, os.path.join(work, "device"), dev)
    other.load_pretrained(WEIGHTS)
    idle = {"device_projected": traced_steps(other, os.path.join(work, "trace_device")),
            "host_projected": traced_steps(trainer, os.path.join(work, "trace_host"))}
    untraced = {"device_projected": device_trainer, "host_projected": train}
    for name, v in idle.items():
        check(0.0 <= v["busy_share"] <= 1.0 and 0.0 <= v["idle_share"] <= 1.0,
              f"{name}: busy share {v['busy_share']}")
        # the profiler slows the host, not the kernels: the traced kernel time
        # of a step over the untraced step's time
        v["busy_ms_per_step"] = v["busy_ms"] / (TRACE_STEPS - 1)
        v["busy_share_of_untraced_step"] = (v["busy_ms_per_step"]
                                            / untraced[name]["ms_per_step_median"])
    per_step = {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0}
    emit({"phase": "host_projection", "config": "ModelConfig() full HDL-64 64x1800",
          "weights": WEIGHTS, "native": native, "projection": projection,
          "stream": stream, "train_step": step,
          "trainer": {"host_projected": train, "device_projected": device_trainer},
          "idle": dict(idle, window=f"trainer steps 2-{TRACE_STEPS} of epoch 1 under "
                                    "torch.profiler (CPU + CUDA activity)"),
          "tolerance": {"pixel_frac": PROJECTION_PIXEL_FRAC},
          "seconds": time.perf_counter() - t0, "card": card})
    return {"host_stream": {"launches": stream_launches,
                            "per_call": {"window_select": len(SELECT_SITES),
                                         "select_and_group": len(GROUP_SITES)},
                            "unit": "push", "calls": len(scans)},
            "host_train_step": {"launches": step_launches, "per_call": per_step, "unit": "step",
                                "calls": TRAIN_STEPS},
            "host_trainer": {"launches": trainer_launches, "per_call": per_step, "unit": "step",
                             "calls": TRAINER_BATCHES}}


# ---- phase 10: bfloat16, the export artifact, the weight writer, the CLIs --------


def bf16_stream(ws, nbr, cfg16, scans, f32_poses, dev):
    """Phase 10a: the stream phase's scans through a bfloat16 stream: 14 + 5
    launches a push, one push's select calls replayed through kernel and
    plain version (exact, as in phase 3), l0 poses against the float32
    stream's.  Returns its numbers and launches."""
    import torch

    from efficientlo_net_torch.evaluation.streaming import OdometryStream
    from efficientlo_net_torch.pretrained import load_model

    model, _ = load_model(WEIGHTS, cfg16, device=dev)
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "the bf16 model holds weights that are not float32")
    stream = OdometryStream(model, cfg16, device=dev)
    run_stream(stream, ws, scans[:2])  # warm-up outside the counted run
    ws.reset_launches()
    poses, times, per_push = run_stream(stream, ws, scans)
    launches = dict(ws.launches)
    expected = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    for i, counts in enumerate(per_push):
        check(counts == expected, f"bf16 push {i} launched {counts}, expected {expected}")
    for q, t in poses:
        check(np.all(np.isfinite(q)) and np.all(np.isfinite(t)), "non-finite bf16 pose")
        check(abs(float(np.linalg.norm(q)) - 1.0) < 1e-3, f"bf16 |q| = {np.linalg.norm(q)}")
    dq = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(poses, f32_poses))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(poses, f32_poses))
    check(dq < BF16_Q_BOUND and dt < BF16_T_BOUND,
          f"bf16 poses from the float32 stream's: q {dq}, t {dt}")
    stream.reset()
    stream.push(scans[0])
    with recording(ws) as calls:
        stream.push(scans[1])
    counts = {k: len(v) for k, v in calls.items()}
    check(counts == expected, f"one bf16 push made {counts} kernel calls")
    for args in calls["window_select"]:
        check_select_site(ws, nbr, args)
    errs = [check_group_site(ws, nbr, args)[1] for args in calls["select_and_group"]]
    feat_dtypes = sorted({str(args[1].dtype) for args in calls["select_and_group"]})
    check(feat_dtypes == ["torch.float32"],
          f"bf16 features reach select_and_group as {feat_dtypes}")
    return {"pushes": len(scans), "launches_per_push": per_push[0],
            "ms_per_push_median": statistics.median(times), "ms_per_push_max": max(times),
            "stage_ms_median": stage_times(stream, scans),
            "q_max_abs_diff_vs_f32": dq, "t_max_abs_diff_vs_f32": dt,
            "bound": {"q": BF16_Q_BOUND, "t": BF16_T_BOUND},
            "replayed": counts, "group_feature_dtypes": feat_dtypes,
            "max_abs_err": {"window_select": 0.0, "select_and_group": max(errs)}}, launches


def bf16_train(ws, cfg16, tcfg, batches, dev):
    """Phase 10b: the bfloat16 train step on phase 6's batches (2 warm-up, 10
    timed): 23 + 0 launches a step, finite losses, float32 loss, gradients,
    parameters and Adam moments.  Returns its numbers and launches."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    state, _ = fresh_train_state(cfg16, tcfg, dev)
    step = make_train_step(cfg16, tcfg)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    state, _ = run_train(ws, step, state, batches[1:], gen)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats(dev)
    ws.reset_launches()
    state, steps = run_train(ws, step, state, [batches[0]] * TRAIN_STEPS, gen)
    launches = dict(ws.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    checked_step_launches([st["launches"] for st in steps], "bf16 train")
    _, metrics = step(state, batches[0], gen)  # one more, outside the counted run
    moments = [v for st in state.optimizer.state.values() for v in st.values() if v.dim() > 0]
    dtypes = {"loss": str(metrics["loss"].dtype),
              "parameters": sorted({str(p.dtype) for p in state.parameters()}),
              "gradients": sorted({str(p.grad.dtype) for p in state.parameters()}),
              "adam_moments": sorted({str(v.dtype) for v in moments})}
    check(dtypes == {"loss": "torch.float32", "parameters": ["torch.float32"],
                     "gradients": ["torch.float32"], "adam_moments": ["torch.float32"]},
          f"bf16 train step dtypes {dtypes}")
    return dict(train_numbers(steps, peak), steps=len(steps), warmup_steps=TRAIN_WARMUP,
                launches_per_step=steps[0]["launches"], dtypes=dtypes,
                losses_fixed_batch=[st["losses"]["loss"] for st in steps]), launches


def export_check(ws, cfg, scans, work, dev):
    """Phase 10c: ``export_odometry`` on the card at B=1, saved and loaded
    back; the artifact against ``make_infer_fn`` on two scans, 14 + 5
    launches a call.  Returns its numbers and launches."""
    import torch

    from efficientlo_net_torch.pretrained import load_model
    from efficientlo_net_torch.serving.export import (export_odometry, load_odometry,
                                                      make_infer_fn, save_artifact)

    model, _ = load_model(WEIGHTS, cfg, device=dev)
    t0 = time.perf_counter()
    exported = export_odometry(model, cfg, batch_size=1, device=dev)
    export_s = time.perf_counter() - t0
    path = save_artifact(os.path.join(work, "odometry"), exported)
    _, call = load_odometry(path)
    ops = {}
    for node in exported.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("efficientlo."):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    pc1, pc2 = (torch.as_tensor(s[None], device=dev) for s in scans[:2])
    infer = make_infer_fn(model, cfg)
    with torch.no_grad():
        q_d, t_d = infer(pc1, pc2)
    ws.reset_launches()
    q_a, t_a = call(pc1, pc2)
    torch.cuda.synchronize()
    per_call = dict(ws.launches)
    expected = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    check(per_call == expected, f"an artifact call launched {per_call}, expected {expected}")
    q_err = float((q_a - q_d).abs().max())
    t_err = float((t_a - t_d).abs().max())
    check(q_err <= EXPORT_ATOL and t_err <= EXPORT_ATOL,
          f"the artifact differs from make_infer_fn: q {q_err}, t {t_err}")
    ws.reset_launches()
    artifact_ms, artifact_host_ms = time_ms(lambda: call(pc1, pc2), reps=5)
    launches, calls = dict(ws.launches), 1 + 5 * 5
    with torch.no_grad():
        direct_ms, direct_host_ms = time_ms(lambda: infer(pc1, pc2), reps=5)
    return {"export_s": export_s, "file_bytes": os.path.getsize(path),
            "graph_ops": ops, "launches_per_call": per_call,
            "q_max_abs_err_vs_direct": q_err, "t_max_abs_err_vs_direct": t_err,
            "tolerance": EXPORT_ATOL, "artifact_ms_per_call": artifact_ms,
            "artifact_host_ms_per_call": artifact_host_ms, "direct_ms_per_call": direct_ms,
            "direct_host_ms_per_call": direct_host_ms}, launches, calls


def writer_check(state, cfg, scans, work, dev):
    """Phase 10d: ``save_pretrained`` of phase 7's trained state, read back by
    ``load_model``: every tensor and the forward on one pair bit-equal.
    Returns its numbers and the file's path."""
    import torch

    from efficientlo_net_torch.ops.projection import crop_and_project
    from efficientlo_net_torch.pretrained import (load_model, save_pretrained,
                                                  variables_from_train_state)

    path = os.path.join(work, "phase7_state.msgpack")
    t0 = time.perf_counter()
    size = save_pretrained(path, variables_from_train_state(state),
                           meta={"note": "the 50-epoch weights after phase 7's trainer steps"})
    save_s = time.perf_counter() - t0
    loaded, meta = load_model(path, cfg, device=dev)
    want = state.model.state_dict()
    differ = [k for k, v in loaded.state_dict().items() if not torch.equal(v, want[k])]
    check(not differ, f"written weights differ: {differ[:5]}")
    model = state.model.eval()
    p1, p2 = (crop_and_project(torch.as_tensor(s[None], device=dev), cfg.sensor)
              for s in scans[:2])
    with torch.no_grad():
        a, b = model(p1, p2), loaded(p1, p2)
    same = all(torch.equal(x, y) for k in ("q", "t") for x, y in zip(a[k], b[k]))
    check(same, "the loaded model's forward is not bit-equal to the trained state's")
    return {"bytes": size, "save_s": save_s, "param_count": meta["param_count"],
            "tensors": len(want), "forward_bit_equal": same}, path


def cli_check(cfg, tree, weights, val, work, dev):
    """Phase 10e: ``cli.main`` in test mode over phase 7's tree with the
    weights phase 7 validated, then ``evaluate_cli.main`` over the
    trajectory it wrote.  Returns its numbers."""
    import io

    from efficientlo_net_torch import cli
    from efficientlo_net_torch.evaluation import evaluate_cli

    root, gt_dir, _ = tree
    result = os.path.join(work, "cli_result")
    t0 = time.perf_counter()
    cli.main(["--mode", "test", "--pretrained", weights, "--data_root", root,
              "--gt_dir", gt_dir, "--test_list", str(KITTI_SEQ),
              "--log_dir", os.path.join(work, "cli_log_"), "--result_dir", result,
              "--device", dev.type])
    cli_s = time.perf_counter() - t0
    errors = np.loadtxt(os.path.join(result, f"{KITTI_SEQ:02d}_errors.txt"), ndmin=2)
    t_rel = float(np.mean(errors[:, 2])) * 100.0
    check(abs(t_rel - val) <= CLI_T_REL_ATOL,
          f"the CLI's t_rel {t_rel} differs from phase 7's validate() {val}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evaluate_cli.main(["--result_dir", result, "--gt_dir", gt_dir,
                                "--eva_seqs", f"{KITTI_SEQ:02d}"])
    lines = out.getvalue().splitlines()
    check(rc == 0 and len(lines) == 2 and lines[0].startswith(f"seq{KITTI_SEQ:02d} "),
          f"evaluate_cli printed {lines}")
    check(float(lines[0].split()[2]) == round(t_rel, 2), f"evaluate_cli: {lines[0]}, t_rel {t_rel}")
    return {"t_rel": t_rel, "validate_t_rel": val, "tolerance": CLI_T_REL_ATOL,
            "cli_s": cli_s, "evaluate_cli": lines}


def profiled(fn, calls):
    """``calls`` calls of ``fn`` under torch.profiler (CPU + CUDA activity):
    per call, the CUDA kernels and their ms, and the TOP_HOST_OPS host
    operators by self CPU time as [name, ms, count]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    check(cuda, "the profiler saw no CUDA kernel")
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:TOP_HOST_OPS]
    return {"kernels_per_call": sum(e.count for e in cuda) / calls,
            "kernel_ms_per_call": sum(e.self_device_time_total for e in cuda) / 1e3 / calls,
            "top_host_ops": [[e.key, e.self_cpu_time_total / 1e3 / calls, e.count / calls]
                             for e in host]}


def dtype_profiles(cfgs, tcfg, scans, batches, dev):
    """Phase 10f: for each config (float32, bfloat16), PROFILED_CALLS pushes
    and PROFILED_CALLS train steps under ``profiled``, each after 2 warm-up
    calls."""
    import torch

    from efficientlo_net_torch.evaluation.streaming import OdometryStream
    from efficientlo_net_torch.pretrained import load_model
    from efficientlo_net_torch.training.step import make_train_step

    out = {"calls": PROFILED_CALLS}
    for cfg in cfgs:
        model, _ = load_model(WEIGHTS, cfg, device=dev)
        stream = OdometryStream(model, cfg, device=dev)
        for scan in scans[:2]:
            stream.push(scan)
        push = profiled(lambda: stream.push(scans[2]), PROFILED_CALLS)
        del stream, model
        state, _ = fresh_train_state(cfg, tcfg, dev)
        step = make_train_step(cfg, tcfg)
        gen = torch.Generator(dev).manual_seed(SEED + 4)
        for batch in batches[1:]:
            step(state, batch, gen)
        train = profiled(lambda: step(state, batches[0], gen), PROFILED_CALLS)
        del state, step
        torch.cuda.empty_cache()
        out[cfg.compute_dtype] = {"push": push, "train_step": train}
    return out


def bf16_serving_phase(ws, nbr, cfg, tcfg, scans, f32_stream, f32_poses, batches, f32_train,
                       trained, tree, work, card, dev):
    """Phase 10: the bfloat16 stream and train step, the card export
    artifact, the weight writer, both CLIs, and float32 against bfloat16
    under the profiler.  Returns their counted
    launches for the kernels line."""
    import dataclasses

    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    stream, stream_launches = bf16_stream(ws, nbr, cfg16, scans, f32_poses, dev)
    train, train_launches = bf16_train(ws, cfg16, tcfg, batches, dev)
    export, export_launches, export_calls = export_check(ws, cfg, scans, work, dev)
    state, val = trained
    writer, weights = writer_check(state, cfg, scans, work, dev)
    clis = cli_check(cfg, tree, weights, val, work, dev)
    profiles = dtype_profiles((cfg, cfg16), tcfg, scans, batches, dev)
    emit({"phase": "bf16_serving", "config": "ModelConfig() full HDL-64 64x1800",
          "weights": WEIGHTS,
          "bf16_stream": dict(stream, f32_ms_per_push_median=f32_stream["ms_per_push_median"],
                              f32_ms_per_push_max=f32_stream["ms_per_push_max"],
                              f32_stage_ms_median=f32_stream["stage_ms_median"]),
          "bf16_train_step": dict(train, f32=f32_train),
          "export": export, "writer": writer, "cli": clis, "profiled": profiles,
          "seconds": time.perf_counter() - t0, "card": card})
    push = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    return {"bf16_stream": {"launches": stream_launches, "per_call": push, "unit": "push",
                            "calls": len(scans), "max_abs_err": stream["max_abs_err"]},
            "bf16_train_step": {"launches": train_launches,
                                "per_call": {"window_select": len(TRAIN_SELECT_SITES),
                                             "select_and_group": 0},
                                "unit": "step", "calls": TRAIN_STEPS},
            "artifact": {"launches": export_launches, "per_call": push, "unit": "call",
                         "calls": export_calls}}


# Phase 11: parallelism.  (a) The select sites of one push that the W-axis
# ring shards, replayed on the halo-widened block of every rank of a ring of
# 3 and of 5; the full config's up-conv grids (225 -> 113 columns) split over
# no ring (the JAX package keeps them replicated), so their recorded inputs
# are cropped to the nearest widths that split over both with stride 2.
RING_SIZES = (3, 5)
UP_CROP = (210, 105)
# (b) In this process, an NCCL group of one rank: the ring forward must equal
# the unsharded forward (exact expected; test_ring.py's q 1e-5, t 1e-4 bound
# it), the data-parallel step the single step (one rank: the same arithmetic,
# but for the gathers' atomics, so the TRAIN_* tolerances), the distributed
# solve the single solve, and the checkpoint must round-trip bit-equal.
RING_Q_ATOL, RING_T_ATOL = 1e-5, 1e-4
SOLVE_ATOL = 1e-4
DP_TIMED_STEPS = 3
# (c) Two gloo ranks sharing the card, B=4 each of the B=8 batch, against the
# single step.  Each rank's weight gradient sums its ~460k rows of a level-0
# layer and the ranks' sums are added: another order of a float32 sum of
# ~920k terms that cancel.  ``split_sum_reading`` redoes exactly that in one
# process, on the single step's own layer inputs and output gradients; a
# fault of the data-parallel step is planted (``planted_fault``: batch
# statistics reduced in the forward but not in the backward) and read too.
# On an H100 the summation order alone moved down_l0.mlp.dense_2.weight by
# 9.27e-5 of its scale (the gloo step by 9.47e-5) and the fault moved a
# gradient by 6.36 of its scale (PERF.md): GLOO_GRAD_REL is twice the
# order's reading and the gathers' atomics (under 1e-5, phase 11b), far
# below the fault.  A bound of 1e-5 of scale would sit below the order's own
# reading.  Batch statistics are held to GLOO_STATS_REL of each statistic's
# largest entry (an absolute 1e-6 is below a float32 ulp of the level-0
# variances, 2^-17 in [64, 128)), beside the TRAIN_* tolerances; losses keep
# TRAIN_LOSS_ATOL.
GLOO_RANKS = 2
GLOO_GRAD_REL = 2e-4
GLOO_STATS_REL = 1e-6
# (d) The ring in training.  (a) In the NCCL group of one rank: the ring's
# training forward, ``total_loss`` and backward on phase 6's batch against the
# unsharded pass from one state and generator seed (a ring of one: the
# autograd functions' one-rank branch), held to the TRAIN_* tolerances (the
# gathers' atomics set the gap), 23 + 0 launches; ms per pass of each, timed
# in turns over RING_TRAIN_REPS passes at a time, then one pass of each
# under ``profiled`` (kernels, kernel ms and the top host operators).  (b) The training select on
# every rank's widened block for RING_SIZES at the level-0 DownConv geometry
# of one push: idx and mask exact against the plain block version and the
# unsharded kernel's sector, and the gradient of a random upstream through
# the block gathers, folded onto the sectors by ``fold_halo_grad``, within
# RING_TRAIN_GRAD_REL of the unsharded autograd gradient's scale (the bound
# set by scatter-add order); each block's select and its grouping launch
# ``window_select`` once each and ``select_and_group`` never.
RING_TRAIN_REPS = 2
RING_TRAIN_GRAD_REL = 1e-6


def ring_block_phase(ws, cases, calls):
    """Phase 11a: every ring-sharded select site of one push on the widened
    block of every rank, for each ring size (``torch_parallel_cases``'s
    block checks: the kernel exact against the plain block version and the
    unsharded kernel's sector); the block calls' launches (the
    ``ring_blocks`` path) and calls by kernel, the largest differences, and
    each call's device ms beside the unsharded call's."""
    rows, errors = [], {"window_select": 0.0, "select_and_group": 0.0}
    launched, n_calls = dict.fromkeys(errors, 0), dict.fromkeys(errors, 0)
    for site, group, args in ring_block_cases(calls):
        name = "select_and_group" if group else "window_select"
        kernel = getattr(ws, name)
        whole = kernel(*args)
        whole_ms = graph_ms(lambda: kernel(*args))
        block = cases.select_and_group_block if group else cases.window_select_block
        for ring_size in RING_SIZES:
            for r in range(ring_size):
                before = ws.launches[name]
                call, plain, unsharded = block(args, ring_size, r, whole)
                launched[name] += ws.launches[name] - before
                n_calls[name] += 1
                check(plain == 0.0, f"{name} block of {site} (ring {ring_size}, rank {r}) "
                                    f"differs from the plain block version by {plain}")
                check(unsharded == 0.0, f"{name} block of {site} (ring {ring_size}, rank {r}) "
                                        f"differs from the unsharded kernel by {unsharded}")
                errors[name] = max(errors[name], plain, unsharded)
                rows.append({"site": site, "kernel": name, "ring": ring_size, "rank": r,
                             "device_ms": graph_ms(call), "unsharded_device_ms": whole_ms})
    return rows, launched, errors, n_calls


def ring_block_cases(calls):
    """Phase 11a's sites: the recorded calls of one push, down_l0 with a
    random scan permutation, the up-conv cropped (UP_CROP)."""
    import torch

    rng = np.random.default_rng(SEED + 8)
    g = list(calls["select_and_group"][GROUP_SITES.index("down_l0")])
    g[7] = torch.as_tensor(rng.permutation(g[2][0] * g[2][1]), device=g[0].device)
    cases = [("down_l0", True, tuple(g))]
    for site in ("cv.knn_l0", "cv.self_l0"):
        cases.append((site, False, calls["window_select"][SELECT_SITES.index(site)]))
    up = list(calls["window_select"][SELECT_SITES.index("up_w_l0")])
    up[0] = up[0][:, :, :UP_CROP[0]].contiguous()
    up[1] = up[1][:, :, :UP_CROP[1]].contiguous()
    cases.append(("up_w_l0", False, tuple(up)))
    return cases


def dp_train_step(ws, cfg, tcfg, batch, dev, mesh):
    """``one_step`` through ``make_sharded_train_step`` on this rank's rows:
    (the new state, (losses, gradients, new batch statistics, launches))."""
    import torch

    from efficientlo_net_torch.parallel.data_parallel import make_sharded_train_step
    from efficientlo_net_torch.parallel.mesh import shard_batch

    state, _ = fresh_train_state(cfg, tcfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    before = dict(ws.launches)
    state, metrics = make_sharded_train_step(cfg, tcfg, mesh)(state, shard_batch(mesh, batch), gen)
    torch.cuda.synchronize()
    launched = {k: ws.launches[k] - before[k] for k in before}
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    grads.update(w_x=state.w_x.grad, w_q=state.w_q.grad)
    stats = {k: v for k, v in state.model.state_dict().items() if k.endswith((".mean", ".var"))}
    return state, ({k: float(v) for k, v in metrics.items()}, grads, stats, launched)


def timed_steps(ws, step, state, batch, gen):
    """One warm-up and DP_TIMED_STEPS timed steps on one batch (CUDA events):
    ``run_train``'s record of each, the warm-up first."""
    state, warm = run_train(ws, step, state, [batch], gen)
    state, steps = run_train(ws, step, state, [batch] * DP_TIMED_STEPS, gen)
    return state, warm + steps


def checked_step_launches(per_step, what):
    """Each step's launches, as measured, against a train step's
    (len(TRAIN_SELECT_SITES) window selects, no select_and_group).  Returns
    the launches of one step."""
    expected = {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0}
    for i, launched in enumerate(per_step):
        check(launched == expected, f"{what} step {i} launched {launched}, expected {expected}")
    return dict(per_step[0])


def circle_solve_inputs(dev):
    """The circle graph of tests/test_multiprocess.py (16 factors, 2 scan
    pairs of 64 points) on ``dev``: (poses0, factors, scan factors)."""
    import torch

    from efficientlo_net_torch.backend import pose_graph as pg
    from efficientlo_net_torch.backend import scan_factors as sfm
    from efficientlo_net_torch.ops import se3
    from torch_parallel_cases import circle_graph

    gt, src, dst, meas, noise, pairs, (p, q, nrm) = circle_graph()
    poses0 = torch.as_tensor(gt, dtype=torch.float32, device=dev) @ se3.se3_exp(
        torch.as_tensor(noise, device=dev))
    factors = pg.make_factors(src, dst, meas, num_nodes=len(gt), capacity=16, device=dev)
    scan = sfm.make_scan_factors(pairs, [
        sfm.Correspondences(p_j=torch.as_tensor(p[i], device=dev),
                            q_i=torch.as_tensor(q[i], device=dev),
                            n_i=torch.as_tensor(nrm[i], device=dev),
                            w=torch.ones(p.shape[1], device=dev))
        for i in range(len(pairs))])
    return poses0, factors, scan


def nccl_phase(ws, nbr, cfg, tcfg, scans, batch, single, dev, work):
    """Phase 11b and 11d(a): an NCCL group of one rank in this process,
    joined by ``initialize_distributed`` from the environment torchrun would
    set.  Returns (its record, the ring forward's launches, the DP steps'
    launches, their launches per step, the ring training pass's launches)."""
    import torch
    import torch.distributed as dist

    from efficientlo_net_torch.backend import pose_graph as pg
    from efficientlo_net_torch.ops.projection import crop_and_project
    from efficientlo_net_torch.parallel.data_parallel import make_sharded_train_step
    from efficientlo_net_torch.parallel.distributed import initialize_distributed
    from efficientlo_net_torch.parallel.mesh import make_mesh, shard_batch
    from efficientlo_net_torch.pretrained import load_model
    from efficientlo_net_torch.training.checkpoint import CheckpointManager
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step
    from torch_parallel_cases import free_port

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    check(initialize_distributed(device="cuda"), "initialize_distributed did not join a group")
    try:
        out = {"backend": str(dist.get_backend()), "world": dist.get_world_size()}
        check(out["backend"] == "nccl", f"the card's group runs {out['backend']}, not NCCL")
        mesh, ring_mesh = make_mesh(), make_mesh((1, 1))
        out["meshes"] = [str(mesh), str(ring_mesh)]

        # the ring eval forward, the 50-epoch weights, two B=2 pairs of scans
        model, _ = load_model(WEIGHTS, cfg, device=dev)
        points = torch.as_tensor(np.stack(scans[:3]), device=dev)
        proj = crop_and_project(points, cfg.sensor)
        p1, p2 = proj[:2].contiguous(), proj[1:3].contiguous()
        with torch.no_grad():
            ws.reset_launches()
            ring_out = model(p1, p2, ring_group=ring_mesh)
            torch.cuda.synchronize()
            ring_launches = dict(ws.launches)
            plain_out = model(p1, p2)
            ring_ms, _ = time_ms(lambda: model(p1, p2, ring_group=ring_mesh), reps=3, repeats=3)
            plain_ms, _ = time_ms(lambda: model(p1, p2), reps=3, repeats=3)
        dq = max(float((a - b).abs().max()) for a, b in zip(ring_out["q"], plain_out["q"]))
        dt = max(float((a - b).abs().max()) for a, b in zip(ring_out["t"], plain_out["t"]))
        check(dq <= RING_Q_ATOL and dt <= RING_T_ATOL,
              f"ring forward differs from the unsharded forward (q {dq}, t {dt})")
        check(ring_launches == {"window_select": len(SELECT_SITES),
                                "select_and_group": len(GROUP_SITES)},
              f"the ring forward launched {ring_launches}")
        out["ring_forward"] = {"q_max_abs_diff": dq, "t_max_abs_diff": dt,
                               "launches": ring_launches, "ms": ring_ms, "plain_ms": plain_ms,
                               "batch": int(p1.shape[0])}

        # the data-parallel step against the single step, from one state and
        # seed, then a warm-up and the timed steps: every step's launches
        ws.reset_launches()
        state, dp = dp_train_step(ws, cfg, tcfg, batch, dev, mesh)
        out["dp_step"] = compare_steps(dp, single, ("NCCL DP step", "single-process step"))
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        _, steps = timed_steps(ws, make_sharded_train_step(cfg, tcfg, mesh),
                               fresh_train_state(cfg, tcfg, dev)[0], shard_batch(mesh, batch), gen)
        dp_launches = dict(ws.launches)
        per_step = [dp[3]] + [s["launches"] for s in steps]
        dp_per_step = checked_step_launches(per_step, "NCCL DP")
        check(dp_launches == {k: sum(p[k] for p in per_step) for k in dp_launches},
              f"the NCCL DP steps launched {dp_launches} in all, outside their steps too")
        _, plain_steps = timed_steps(ws, make_train_step(cfg, tcfg),
                                     fresh_train_state(cfg, tcfg, dev)[0], batch, gen)
        out["dp_step"].update(ms_per_step=[s["ms"] for s in steps[1:]],
                              plain_ms_per_step=[s["ms"] for s in plain_steps[1:]],
                              launches=dp_launches, launches_per_step=dp_per_step,
                              steps=len(per_step))

        # the checkpoint of the DP state, through _barrier and _is_primary
        ckpt = CheckpointManager(os.path.join(work, "nccl_ckpt"))
        ckpt.save(state, epoch=0)
        model2, _ = load_model(WEIGHTS, cfg, device=dev)
        restored = ckpt.restore(create_train_state(model2, tcfg, device=dev))
        got, want = state_tensors(restored), state_tensors(state)
        same = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        check(same, "the DP state's checkpoint did not round-trip bit-equal")
        out["checkpoint_bit_equal"] = same

        # the distributed solve against the single solve
        poses0, factors, scan = circle_solve_inputs(dev)
        gn = pg.GaussNewtonConfig(iterations=12)
        grouped, hist = pg.optimize(poses0, factors, gn, scan_factors=scan, group=mesh)
        alone, hist1 = pg.optimize(poses0, factors, gn, scan_factors=scan)
        err = float((grouped - alone).abs().max())
        check(err <= SOLVE_ATOL, f"optimize(group=) differs from optimize() by {err}")
        out["optimize"] = {"max_abs_diff": err, "chi2": float(hist[-1]),
                           "chi2_single": float(hist1[-1])}

        # phase 11d(a): the ring in training, on the same group
        out["ring_train"], ring_train_launches = ring_train_phase(ws, cfg, tcfg, batch, dev,
                                                                  ring_mesh)
    finally:
        dist.destroy_process_group()
        for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(name, None)
    return out, ring_launches, dp_launches, dp_per_step, ring_train_launches


def train_pass(tcfg, ring_group=None):
    """A train step with no update, as ``one_step``'s ``step``: the training
    forward of (p1, p2, q_gt, t_gt) inputs (both towers, a scan permutation
    per first-K select and dropout from the generator, step 0's bn
    momentum) with its level-0 select on ``ring_group`` (None: unsharded),
    ``total_loss`` and backward."""
    import torch

    from efficientlo_net_torch.models.losses import total_loss

    def step(state, inputs, generator):
        p1, p2, q_gt, t_gt = inputs
        momentum = torch.tensor(tcfg.bn_momentum(0), dtype=torch.float32, device=p1.device)
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model.train()(p1, p2, bn_momentum=momentum, stochastic=True,
                                  generator=generator, ring_group=ring_group)
        loss, metrics = total_loss(out, q_gt, t_gt, state.w_x, state.w_q)
        loss.backward()
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def ring_train_phase(ws, cfg, tcfg, batch, dev, ring_mesh):
    """Phase 11d(a): the ring's training pass on ``ring_mesh`` against the
    unsharded one on ``batch``'s projected inputs, counted, timed and
    profiled.  Returns (its record, the ring pass's launches)."""
    import torch

    from efficientlo_net_torch.training.step import _forward_inputs

    inputs = _forward_inputs(batch, cfg.sensor, dev)
    steps = {"ring": train_pass(tcfg, ring_mesh), "plain": train_pass(tcfg)}
    ring = one_step(ws, None, cfg, tcfg, inputs, dev, step=steps["ring"])
    launches = ring[3]
    check(launches == {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0},
          f"the ring training pass launched {launches}")
    single = one_step(ws, None, cfg, tcfg, inputs, dev, step=steps["plain"])
    out = compare_steps(ring, single, ("ring training pass", "unsharded training pass"))
    # each pass again on a state of its own; in turns (ring, plain, plain,
    # ring, twice) after an untimed round: the card and host drift, and the
    # first timed block ran slow (PERF.md)
    runs = {name: functools.partial(step, fresh_train_state(cfg, tcfg, dev)[0], inputs,
                                    torch.Generator(dev).manual_seed(SEED + 3))
            for name, step in steps.items()}
    for run in runs.values():
        run()
    times = {name: [] for name in runs}
    for name in ("ring", "plain", "plain", "ring") * 2:
        times[name].append(time_ms(runs[name], reps=RING_TRAIN_REPS, repeats=1))
    out.update(launches=launches, losses_ring=ring[0], losses_single=single[0],
               batch=tcfg.batch_size, ms_turns=times,
               ms=statistics.median(t[0] for t in times["ring"]),
               host_ms=statistics.median(t[1] for t in times["ring"]),
               plain_ms=statistics.median(t[0] for t in times["plain"]),
               plain_host_ms=statistics.median(t[1] for t in times["plain"]),
               profile={name: profiled(runs[name], 1) for name in runs})
    return out, launches


def ring_train_block_phase(ws, cases, down_args):
    """Phase 11d(b): the ring's training select (the ``window_select`` kernel
    on each rank's widened block, as ``ring._group_on_block`` runs it
    unfused) at ``down_args``, the level-0 DownConv call of one push with
    phase 11a's random scan permutation, given random features of the call's
    width, for every rank of each ring size (``torch_parallel_cases``'
    checks).  Every kernel's launches are counted around each block call and
    each ring's gradient: one ``window_select`` for the checked select and
    one in the grouping a block, no ``select_and_group``.
    Returns (rows: each block's device ms beside the unsharded call's, the
    blocks' launches by kernel, the largest differences, the blocks)."""
    import torch

    xyz, feats, kernel, k, distance, cs, mode, perm = down_args
    gen = torch.Generator(xyz.device).manual_seed(SEED + 9)
    feats = torch.randn(feats.shape, generator=gen, device=xyz.device)
    gargs = (xyz, feats, kernel, k, distance, cs, mode, perm)
    sargs = (xyz, xyz, kernel, k, distance, cs, (1, 1), mode, perm)
    whole_select = ws.window_select(*sargs)
    whole_ms = graph_ms(lambda: ws.window_select(*sargs))
    n = whole_select[0].shape[1]
    upstream = torch.randn((xyz.shape[0], n, k, 3 + feats.shape[-1]), generator=gen,
                           device=xyz.device)
    whole = cases.unsharded_group_grads(gargs, upstream)
    rows, n_blocks = [], 0
    launched = dict.fromkeys(ws.launches, 0)

    def counted(fn, *args):
        before = dict(ws.launches)
        out = fn(*args)
        torch.cuda.synchronize()
        for name in launched:
            launched[name] += ws.launches[name] - before[name]
        return out

    errors = {"select": 0.0, "groups": 0.0, "grad_xyz_rel": 0.0, "grad_feats_rel": 0.0}
    for ring_size in RING_SIZES:
        for r in range(ring_size):
            call, plain, unsharded = counted(cases.window_select_block, sargs, ring_size, r,
                                             whole_select)
            n_blocks += 1
            check(plain == 0.0 and unsharded == 0.0,
                  f"training select block (ring {ring_size}, rank {r}) differs from the plain "
                  f"block version by {plain}, from the unsharded kernel by {unsharded}")
            errors["select"] = max(errors["select"], plain, unsharded)
            rows.append({"ring": ring_size, "rank": r, "device_ms": graph_ms(call),
                         "unsharded_device_ms": whole_ms})
        groups, grad_xyz, grad_feats = counted(cases.train_block_grads, gargs, ring_size,
                                               upstream, whole)
        check(groups == 0.0,
              f"ring {ring_size}: block groups differ from the unsharded by {groups}")
        check(grad_xyz <= RING_TRAIN_GRAD_REL and grad_feats <= RING_TRAIN_GRAD_REL,
              f"ring {ring_size}: folded block gradients differ from the unsharded by "
              f"{grad_xyz:.3g} (xyz), {grad_feats:.3g} (feats) of their scale")
        errors.update(groups=max(errors["groups"], groups),
                      grad_xyz_rel=max(errors["grad_xyz_rel"], grad_xyz),
                      grad_feats_rel=max(errors["grad_feats_rel"], grad_feats))
    expected = {"window_select": 2 * n_blocks, "select_and_group": 0}
    check(launched == expected, f"the training blocks launched {launched}, expected {expected}")
    return rows, launched, errors, n_blocks


def split_sum_reading(cfg, tcfg, batch, dev):
    """The gloo step's gradient gap from summation order alone, in one
    process: one single-process step (``one_step``'s state and seed) keeps
    the input and the output gradient of every ``nn.Linear`` call, and each
    layer's weight and bias gradient is summed again twice: over the whole
    batch by one GEMM per call (as autograd does), and as the GLOO_RANKS
    data-parallel step sums it (one GEMM per call over each rank's rows of
    the batch, then the ranks' sums added).  Each is held against the
    step's own gradient, relative to its scale as ``step_errors`` holds
    gradients."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    state, _ = fresh_train_state(cfg, tcfg, dev)
    calls = {}

    def keep(name):
        def hook(module, inputs, output):
            x = inputs[0].detach()
            output.register_hook(lambda g: calls.setdefault(name, []).append((x, g.detach())))
        return hook

    linears = {n: m for n, m in state.model.named_modules() if isinstance(m, torch.nn.Linear)}
    handles = [m.register_forward_hook(keep(n)) for n, m in linears.items()]
    try:
        make_train_step(cfg, tcfg)(state, batch, torch.Generator(dev).manual_seed(SEED + 3))
    finally:
        for h in handles:
            h.remove()
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    b, share = tcfg.batch_size, tcfg.batch_size // GLOO_RANKS

    def rel(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), TRAIN_GRAD_FLOOR * top)

    whole, split, skipped = {}, {}, []
    with torch.no_grad():
        for name, pairs in calls.items():
            if any(x.shape[0] % b for x, _ in pairs):
                skipped.append(name)
                continue
            w_whole = sum(g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
                          for x, g in pairs)
            b_whole = sum(g.reshape(-1, g.shape[-1]).sum(0) for _, g in pairs)
            w_split, b_split = 0, 0
            for r in range(GLOO_RANKS):
                w_rank, b_rank = 0, 0
                for x, g in pairs:
                    # rank r's rows: the samples r*share..(r+1)*share of each
                    # batch-sized block of the leading axis (both frames)
                    rows = [i for i in range(x.shape[0]) if (i % b) // share == r]
                    xr = x[rows].reshape(-1, x.shape[-1])
                    gr = g[rows].reshape(-1, g.shape[-1])
                    w_rank = w_rank + gr.T @ xr
                    b_rank = b_rank + gr.sum(0)
                w_split, b_split = w_split + w_rank, b_split + b_rank
            for suffix, w_sum, s_sum in (("weight", w_whole, w_split), ("bias", b_whole, b_split)):
                key = f"{name}.{suffix}"
                if key in grads:
                    whole[key] = rel(w_sum, grads[key])
                    split[key] = rel(s_sum, grads[key])
    worst = max(split, key=split.get)
    return {"split_max_rel_err": split[worst], "split_worst": worst,
            "whole_max_rel_err": max(whole.values()), "parameters": len(split),
            "skipped_layers": skipped}


@contextlib.contextmanager
def planted_fault():
    """A fault of the data-parallel step, planted while the block runs, for
    the gradient check's reading: batch statistics summed over the group in
    the forward, but each rank's gradient left unsummed in the backward
    (``layers.all_reduce_sum`` without its backward all-reduce)."""
    import torch

    from efficientlo_net_torch.models import layers
    from efficientlo_net_torch.parallel.distributed import all_reduce_

    class ForwardOnlySum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            return all_reduce_(x.clone(), group)

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    original = layers.all_reduce_sum
    layers.all_reduce_sum = ForwardOnlySum.apply
    try:
        yield
    finally:
        layers.all_reduce_sum = original


def _gloo_rank(rank, world, port, batch_path, out_dir):
    """Phase 11c's rank: one data-parallel step from the fresh state and
    seed of ``one_step`` on its B=4 rows, over gloo, on the shared card;
    then a warm-up and DP_TIMED_STEPS timed steps; then, uncounted, the
    step with a planted fault (``planted_fault``)."""
    import torch
    import torch.distributed as dist

    from efficientlo_net_torch.config import ModelConfig, TrainConfig
    from efficientlo_net_torch.ops import window_select as ws
    from efficientlo_net_torch.parallel.data_parallel import make_sharded_train_step
    from efficientlo_net_torch.parallel.mesh import make_mesh, shard_batch

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo, not NCCL: NCCL puts no two ranks on one card
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        dev = torch.device("cuda")
        cfg, tcfg = ModelConfig(), TrainConfig(host_projection=False)
        batch = dict(np.load(batch_path))
        mesh = make_mesh(device_type="cuda")
        ws.reset_launches()
        state, (losses, grads, stats, launched) = dp_train_step(ws, cfg, tcfg, batch, dev, mesh)
        _, steps = timed_steps(ws, make_sharded_train_step(cfg, tcfg, mesh),
                               fresh_train_state(cfg, tcfg, dev)[0], shard_batch(mesh, batch),
                               torch.Generator(dev).manual_seed(SEED + 1))
        counted = dict(ws.launches)
        with planted_fault():
            _, (f_losses, f_grads, f_stats, _) = dp_train_step(ws, cfg, tcfg, batch, dev, mesh)

        def host(tensors):
            return {k: v.cpu() for k, v in tensors.items()}

        torch.save({"losses": losses, "grads": host(grads), "stats": host(stats),
                    "params": torch.cat([p.detach().reshape(-1) for p in state.parameters()]).cpu(),
                    "ms_per_step": [s["ms"] for s in steps[1:]],
                    "per_step_launches": [launched] + [s["launches"] for s in steps],
                    "launches": counted, "backend": str(dist.get_backend()),
                    "fault": {"losses": f_losses, "grads": host(f_grads), "stats": host(f_stats)}},
                   os.path.join(out_dir, f"gloo_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_phase(cfg, tcfg, batch, single, dev, work):
    """Phase 11c: GLOO_RANKS spawned processes, gloo on the one card, each
    B/GLOO_RANKS of the batch; their step against the single B=8 step,
    beside the summation-order reading and the planted fault's.  Returns
    (its record, the launches of one rank's step)."""
    import torch
    import torch.multiprocessing as mp
    from torch_parallel_cases import free_port

    batch_path = os.path.join(work, "gloo_batch.npz")
    np.savez(batch_path, **batch)
    t0 = time.perf_counter()
    mp.start_processes(_gloo_rank, args=(GLOO_RANKS, free_port(), batch_path, work),
                       nprocs=GLOO_RANKS, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"gloo_rank{r}.pt")) for r in range(GLOO_RANKS)]
    single_host = (single[0], {k: v.cpu() for k, v in single[1].items()},
                   {k: v.cpu() for k, v in single[2].items()}, None)
    reading = split_sum_reading(cfg, tcfg, batch, dev)
    fault = ranks[0]["fault"]
    fault = step_errors((fault["losses"], fault["grads"], fault["stats"], None), single_host)
    got = (ranks[0]["losses"], ranks[0]["grads"], ranks[0]["stats"], None)
    # the readings first, so that a failed check below still shows them
    emit({"phase": "parallel_gloo_readings", "dp_vs_single": step_errors(got, single_host),
          "summation_order": reading, "planted_fault": fault, "grad_rel": GLOO_GRAD_REL})
    check(all(torch.equal(ranks[0]["params"], r["params"]) for r in ranks[1:]),
          "parameters after the update differ across the gloo ranks")
    check(fault["grad_max_rel_err"] > GLOO_GRAD_REL,
          f"the planted fault moves the gradients by {fault['grad_max_rel_err']:.3g} of their "
          f"scale, within GLOO_GRAD_REL {GLOO_GRAD_REL}")
    check(reading["split_max_rel_err"] <= GLOO_GRAD_REL,
          f"summation order alone moves {reading['split_worst']} by "
          f"{reading['split_max_rel_err']:.3g} of its scale, beyond GLOO_GRAD_REL")
    per_step = [p for r in ranks for p in r["per_step_launches"]]
    per_rank_step = checked_step_launches(per_step, "gloo DP")
    for i, r in enumerate(ranks):
        check(r["launches"] == {k: sum(p[k] for p in r["per_step_launches"]) for k in r["launches"]},
              f"gloo rank {i} launched {r['launches']} in all, outside its steps too")
    out = compare_steps(got, single_host, ("gloo DP step", "single-process B=8 step"),
                        grad_rel=GLOO_GRAD_REL, stats_rel=GLOO_STATS_REL)
    out.update(ranks=GLOO_RANKS, backend=ranks[0]["backend"], params_bit_equal=True,
               ms_per_step=[r["ms_per_step"] for r in ranks],
               launches=[r["launches"] for r in ranks], launches_per_rank_step=per_rank_step,
               rank_steps=len(per_step), summation_order=reading, planted_fault=fault,
               seconds=seconds)
    return out, per_rank_step


def parallel_phase(ws, nbr, cfg, tcfg, scans, batches, calls, card, dev, work):
    """Phase 11: the ring's block kernels, the NCCL group of one rank and
    two gloo ranks on the card.  Returns the counted paths for the kernels
    line."""
    # the block checks, the circle graph and a free port come from
    # tests/torch_parallel_cases.py (bare name, as phase 7 imports torch_cases)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_parallel_cases as cases

    t0 = time.perf_counter()
    ws.reset_launches()
    rows, block_launches, block_errors, n_blocks = ring_block_phase(ws, cases, calls)
    single = one_step(ws, nbr, cfg, tcfg, batches[0], dev)
    nccl, ring_launches, dp_launches, dp_per_step, ring_train_launches = nccl_phase(
        ws, nbr, cfg, tcfg, scans, batches[0], single, dev, work)
    gloo, gloo_per_step = gloo_phase(cfg, tcfg, batches[0], single, dev, work)
    t1 = time.perf_counter()
    train_rows, train_block_launches, train_block_errors, n_train_blocks = \
        ring_train_block_phase(ws, cases, ring_block_cases(calls)[0][2])
    emit({"phase": "parallel", "config": "ModelConfig() full HDL-64 64x1800",
          "weights": WEIGHTS, "ring_blocks": rows, "ring_block_calls": n_blocks,
          "ring_block_launches": block_launches, "up_conv_crop": list(UP_CROP),
          "nccl_one_rank": nccl, "gloo_two_ranks": gloo,
          "ring_train_blocks": train_rows, "ring_train_block_calls": n_train_blocks,
          "ring_train_block_launches": train_block_launches,
          "ring_train_block_errors": train_block_errors,
          "ring_train_blocks_seconds": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "card": card})
    push = {"window_select": len(SELECT_SITES), "select_and_group": len(GROUP_SITES)}
    per_block = {k: block_launches[k] / max(1, n_blocks[k]) for k in push}
    return {"ring_blocks": {"launches": block_launches, "per_call": per_block,
                            "unit": "block", "calls": n_blocks, "max_abs_err": block_errors},
            "ring_forward": {"launches": ring_launches, "per_call": ring_launches,
                             "unit": "forward", "calls": 1},
            "ring_train": {"launches": ring_train_launches, "per_call": ring_train_launches,
                           "unit": "forward_backward", "calls": 1},
            # select_and_group made no call here, so it has no error to report
            "ring_train_blocks": {
                "launches": train_block_launches,
                "per_call": {k: v / n_train_blocks for k, v in train_block_launches.items()},
                "unit": "block", "calls": {"window_select": n_train_blocks, "select_and_group": 0},
                "max_abs_err": {"window_select": train_block_errors["select"]}},
            "dp_step_nccl": {"launches": dp_launches, "per_call": dp_per_step, "unit": "step",
                             "calls": nccl["dp_step"]["steps"]},
            "dp_step_gloo": {"launches": {k: sum(r[k] for r in gloo["launches"]) for k in push},
                             "per_call": gloo_per_step, "unit": "rank_step",
                             "calls": gloo["rank_steps"]}}


def main():
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    import concurrent.futures
    import tempfile

    from efficientlo_net_torch.config import ModelConfig, TrainConfig
    from efficientlo_net_torch.data import native_io
    from efficientlo_net_torch.evaluation.streaming import OdometryStream
    from efficientlo_net_torch.ops import cuda_build
    from efficientlo_net_torch.ops import neighbors as nbr
    from efficientlo_net_torch.ops import window_select as ws
    from efficientlo_net_torch.pretrained import load_model

    # ---- 1. device -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # ---- 2. build: the CUDA kernels and, beside them, the native library -------
    def timed_native_build():
        t = time.perf_counter()
        built = native_io.build()
        return {"library": built.name, "compiler": native_io.compiler(),
                "seconds": time.perf_counter() - t}

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_future = pool.submit(timed_native_build)
        cuda_build.build()
        native_build = native_future.result()
    ptxas = {src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for src, log in cuda_build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(cuda_build.SOURCES), "ptxas": ptxas, "native": native_build})

    # ---- 3.-4. stream kernels, stream ------------------------------------------
    cfg = ModelConfig()
    model, meta = load_model(WEIGHTS, cfg, device="cuda")
    stream = OdometryStream(model, cfg, device="cuda")
    scans = make_scans(cfg.sensor, N_SCANS)
    stream_sites, stream_calls = kernel_phase(ws, nbr, stream, scans)
    stream_launches, stream_poses, stream_times = stream_phase(ws, nbr, stream, scans, meta, card)
    del stream, model

    # ---- 5.-6. train kernels, train -------------------------------------------
    dev = torch.device("cuda")
    # device projection, as before host projection became the default where
    # the native library loads; phase 9 runs the host-projected paths
    tcfg = TrainConfig(host_projection=False)
    batches = train_batches(cfg.sensor, tcfg.batch_size)
    train_sites = train_kernel_phase(ws, nbr, cfg, tcfg, batches[0], dev)
    train_launches, train_times = train_phase(ws, nbr, cfg, tcfg, batches, card, dev)

    # ---- 7.-12. trainer and sequence eval, SLAM, host projection, bf16 and
    # serving, parallelism, kernels line ------------------------------------------
    with tempfile.TemporaryDirectory() as work:
        tree = kitti_tree(cfg, work)
        counted, device_trainer, trained = trainer_eval_phase(ws, nbr, cfg, tcfg, card, dev, tree,
                                                              os.path.join(work, "log"))
        model, _ = load_model(WEIGHTS, cfg, device="cuda")
        counted.update(slam_phase(ws, nbr, cfg, model, card, dev))
        del model
        counted.update(host_projection_phase(ws, nbr, cfg, tcfg, scans, stream_poses, batches,
                                             tree, work, device_trainer, native_build, card,
                                             dev))
        counted.update(bf16_serving_phase(ws, nbr, cfg, tcfg, scans, stream_times, stream_poses,
                                          batches, train_times, trained, tree, work, card, dev))
        counted.update(parallel_phase(ws, nbr, cfg, tcfg, scans, batches, stream_calls, card, dev,
                                      work))
    emit(kernels_line({"stream": (stream_sites, stream_launches),
                       "train": (train_sites, train_launches)}, counted, card))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
