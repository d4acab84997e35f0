#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (efficientlo_net_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``efficientlo_net_torch/ops/csrc`` and drives
the port's two main paths at the full HDL-64 width (64x1800 range images of
150k-point scans), from the 50-epoch weights in
``pretrained/synthetic_drive_50ep.msgpack``: eval-mode streaming odometry,
and the train step at ``TrainConfig().batch_size`` = 8.  Phases, each
printing JSON lines:

1. device: the card (and its ``nvidia-smi`` name and power limit); TF32 is
   switched off for matmuls and convolutions, so float32 stays float32;
2. build: the kernels' build time and ptxas report;
3. kernels: every select call of one push (14 ``window_select`` and 5
   ``select_and_group`` launches) is replayed on its recorded inputs through
   the kernel and through its plain PyTorch version: K sets and masks must be
   equal exactly, and each centre's grouped (xyz, feature) rows exactly, as
   multisets; plus one FIRST_K case with a random scan permutation per
   kernel.  Each call site is timed beside its bound: back-to-back calls
   (CUDA events, median; and the host's time to make the calls), and the
   kernel alone (the replay of a CUDA graph that captured the calls);
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
7. the ``kernels`` line (each kernel's launches, times and bound, per path
   and summed), then the card line, then the result line.

Exits non-zero, printing no result, when no CUDA device is present or any
check fails.
"""

from __future__ import annotations

import contextlib
import json
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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
    device_ms = graph_ms(lambda: ws.window_select(*args))
    plain_ms, _ = time_ms(lambda: nbr.select_neighbors_plain(*args))
    b_ms, b_by = bound(select_bytes(args, idx, mask),
                       FLOPS_PER_CANDIDATE * examined(nbr, args, group=False))
    return dict(site=site, **describe(args, False), ms=ms, host_ms=host_ms,
                device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0.0, same_order=same)


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
        device_ms = graph_ms(lambda: ws.select_and_group(*args))
        plain_ms, _ = time_ms(lambda: nbr.select_and_group_plain(*args))
        b_ms, b_by = bound(nbytes(args[0], args[1], *outs),
                           FLOPS_PER_CANDIDATE * examined(nbr, args, group=True))
        sites["select_and_group"].append(dict(
            site=site, **describe(args, True), ms=ms, host_ms=host_ms, device_ms=device_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            same_order=same))
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
    return sites


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
    projection, the feature tower, correlation + refinement."""
    import torch

    model = stream.model
    stages = {"projection": [], "tower": [], "correlation_refinement": []}
    prev = None
    with torch.no_grad():
        for s in scans:
            pts = torch.as_tensor(s, device=stream.device)[None]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            proj = stream.project(pts)
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
    """Phase 4: the main path.  Returns the launches of each kernel in it."""
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
    return launches


def summed(rows, launches):
    """A kernel's sites on one path: launches in the path's counted run,
    launches per call of the path, and times and bound per call, summed over
    the sites."""
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {"launches": launches, "launches_per_call": len(rows),
            "ms": sum(r["ms"] for r in rows), "device_ms": sum(r["device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": t_bytes + t_ops,
            "bound_by": None if not rows else "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0)}


def kernels_line(paths, card):
    """Phase 7: one entry per kernel.  ``paths`` maps a path ("stream": one
    push, "train": one train step) to (its sites by kernel, its launches by
    kernel).  Top-level times and bound are one call of each path, summed;
    ``launches`` is the sum of the paths' counted runs."""
    source = "efficientlo_net_torch/ops/csrc/window_select.cu"
    replaces = {"window_select": "efficientlo_net_tpu/ops/pallas_select.py:48",
                "select_and_group": "efficientlo_net_tpu/ops/pallas_select.py:98"}
    kernels = []
    for name, where in replaces.items():
        per = {path: summed(sites[name], launches[name])
               for path, (sites, launches) in paths.items()}
        rows = [r for sites, _ in paths.values() for r in sites[name]]
        total = summed(rows, sum(p["launches"] for p in per.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": where,
            **{k: total[k] for k in ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "library_ms": None, "per": "one push plus one train step, summed over call sites",
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


def train_vs_plain(ws, nbr, cfg, tcfg, batch, dev):
    """One step through the kernel and one through the plain selects, each
    from a fresh state and the same generator seed.  Returns the largest
    differences (losses, gradients relative to their scale, statistics)."""
    import torch

    from efficientlo_net_torch.training.step import make_train_step

    runs = []
    for plain in (False, True):
        state, _ = fresh_train_state(cfg, tcfg, dev)
        gen = torch.Generator(dev).manual_seed(SEED + 3)
        with plain_selects(ws, nbr) if plain else contextlib.nullcontext():
            before = dict(ws.launches)
            state, metrics = make_train_step(cfg, tcfg)(state, batch, gen)
            torch.cuda.synchronize()
            launched = {k: ws.launches[k] - before[k] for k in before}
        grads = {k: p.grad for k, p in state.model.named_parameters()}
        grads.update(w_x=state.w_x.grad, w_q=state.w_q.grad)
        stats = {k: v for k, v in state.model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, stats, launched))
    (m_k, g_k, s_k, l_k), (m_p, g_p, s_p, l_p) = runs
    check(l_k == {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0},
          f"the kernel step launched {l_k}")
    check(not any(l_p.values()), f"the plain-select step launched {l_p}")
    loss_err = max(abs(m_k[k] - m_p[k]) for k in m_p)
    check(loss_err <= TRAIN_LOSS_ATOL, f"kernel step losses {m_k} differ from plain {m_p}")
    top = max(float(g.abs().max()) for g in g_p.values())
    grad_err = 0.0
    for k, g in g_p.items():
        scale = max(float(g.abs().max()), TRAIN_GRAD_FLOOR * top)
        err = float((g_k[k] - g).abs().max()) / scale
        check(err <= TRAIN_GRAD_REL, f"gradient of {k}: kernel step differs from plain by "
                                     f"{err:.3g} of its scale")
        grad_err = max(grad_err, err)
    stats_err = 0.0
    for k, v in s_p.items():
        check(torch.allclose(s_k[k], v, **TRAIN_STATS_TOL), f"batch statistic {k} differs")
        stats_err = max(stats_err, float((s_k[k] - v).abs().max()))
    return {"loss_max_abs_err": loss_err, "grad_max_rel_err": grad_err,
            "stats_max_abs_err": stats_err, "losses_kernel": m_k, "losses_plain": m_p,
            "tolerance": {"loss_atol": TRAIN_LOSS_ATOL, "grad_rel": TRAIN_GRAD_REL,
                          "grad_floor": TRAIN_GRAD_FLOOR, "stats": TRAIN_STATS_TOL}}


def train_phase(ws, nbr, cfg, tcfg, batches, card, dev):
    """Phase 6: the train path.  Returns the launches of each kernel in its
    counted run."""
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
    expected = {"window_select": len(TRAIN_SELECT_SITES), "select_and_group": 0}
    for i, s in enumerate(steps):
        check(s["launches"] == expected, f"train step {i} launched {s['launches']}, "
                                         f"expected {expected}")
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
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from efficientlo_net_torch.config import ModelConfig, TrainConfig
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

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    ptxas = {src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for src, log in cuda_build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(cuda_build.SOURCES), "ptxas": ptxas})

    # ---- 3.-4. stream kernels, stream ------------------------------------------
    cfg = ModelConfig()
    model, meta = load_model(WEIGHTS, cfg, device="cuda")
    stream = OdometryStream(model, cfg, device="cuda")
    scans = make_scans(cfg.sensor, N_SCANS)
    stream_sites = kernel_phase(ws, nbr, stream, scans)
    stream_launches = stream_phase(ws, nbr, stream, scans, meta, card)
    del stream, model

    # ---- 5.-7. train kernels, train, kernels line ---------------------------------
    dev = torch.device("cuda")
    tcfg = TrainConfig()
    batches = train_batches(cfg.sensor, tcfg.batch_size)
    train_sites = train_kernel_phase(ws, nbr, cfg, tcfg, batches[0], dev)
    train_launches = train_phase(ws, nbr, cfg, tcfg, batches, card, dev)
    emit(kernels_line({"stream": (stream_sites, stream_launches),
                       "train": (train_sites, train_launches)}, card))
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
