"""Cases and rank bodies of the parallelism tests (tests/test_torch_parallel.py,
tests/test_torch_ring_training.py).

Numpy and the port only, with no JAX import: the rank processes, spawned by
``spawn`` with ``torch.multiprocessing`` on 127.0.0.1, import this module by
bare name (``tests/`` is on their ``sys.path``), and the card tests
(tests/test_torch_parallel_cases.py) run where JAX is not installed.  Each
rank pins torch to one thread, joins a gloo group, runs its job and leaves
what the parent compares in ``<out_dir>/<job>_rank<r>.pt``; the parent
prepares the inputs a job reads (weights, images, graphs) in ``out_dir``.
"""

import contextlib
import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_cases import KITTI_SEQ, make_grids

FIRST_K, KNN = "first_k", "knn"

# tests/test_ring.py's geometries, at full width:
# name -> (grid1 hw, grid2 hw, kernel, k, distance, centre stride, source stride, mode, ring)
GEOMETRIES = {
    "down_l0": ((64, 1800), (64, 1800), (9, 15), 32, 0.5, (4, 8), (1, 1), FIRST_K, 3),
    "down_l0_r5": ((64, 1800), (64, 1800), (9, 15), 32, 0.5, (4, 8), (1, 1), FIRST_K, 5),
    "cv_l0_knn": ((16, 225), (16, 225), (11, 41), 6, 1000.0, (1, 1), (1, 1), KNN, 3),
    "cv_l0_agg": ((16, 225), (16, 225), (3, 5), 4, 1.0, (1, 1), (1, 1), FIRST_K, 5),
    "cv_l2_knn": ((4, 57), (4, 57), (5, 15), 6, 1000.0, (1, 1), (1, 1), KNN, 3),
    # dense (8, 90) centres querying a (4, 45) coarse grid: the up-conv path
    "up_conv": ((8, 90), (4, 45), (3, 5), 3, 6.0, (1, 1), (2, 2), FIRST_K, 3),
    # points at the azimuth seam: neighbours cross the ring boundary
    "seam": ((4, 12), (4, 12), (3, 7), 5, 1000.0, (1, 1), (1, 1), KNN, 4),
}
# The data-parallel steps' B=4 batches, by numpy seed.  The step is held to
# JAX's sharded step on seeds 10-17 but 11, 12 and 14, where the float order
# of the warps' re-projection picks other pixel winners (see
# tests/test_torch_train.py) with no data parallelism involved: on 11 and 12
# JAX's own sharded and unsharded gradients of the tiny network differ by
# 3.0e-3 and 1.0e-3 of their scale, and on 14 the port's single-process step
# differs from JAX's by 5.1e-4, above the 1e-4 the test holds to.  On the
# five seeds kept all three agree within 5.7e-5.
DP_JAX_SEEDS = (10, 13, 15, 16, 17)
# the batch of the step held to the port's single-process step
DP_BATCH_SEED = 13
# the SLAM drive over the group: a biased square of 4 legs of this many steps,
# 33 keyframes and 7 closures: 39 factors in the global pass, padded to 40
SLAM_STEPS = 36
# select_and_group: feature channels, kernel, k, distance, centre stride, ring
GROUP_CASE = dict(hw=(8, 24), channels=5, kernel=(3, 5), k=4, distance=2.0, stride=(2, 2), ring=3)
# The ring functions' gradients: tests/test_ring.py's two grouping geometries
# (the down-conv centre stride; KNN windows across the azimuth seam), widened
# so that rings of 2 to 5 split them: name -> (hw, channels, kernel, k,
# distance, centre stride, mode)
GRAD_CASES = {
    "down_stride": ((8, 120), 5, (3, 5), 4, 2.0, (2, 2), FIRST_K),
    "seam": ((4, 60), 5, (3, 7), 5, 1000.0, (1, 1), KNN),
}
GRAD_RINGS = (2, 3, 4, 5)
# the ring in training: the B=4 batch's numpy seed (one of DP_JAX_SEEDS, on
# which the port's single step and JAX's agree) and the generator's seed
RING_TRAIN_SEED = 13
RING_TRAIN_GEN_SEED = 5


def ring_inputs(name):
    """(g1, g2, perm) of a geometry, from a seed of its own; a centre-strided
    case selects on its own grid, as DownConv does."""
    hw1, hw2, kernel, _, _, cs, _, mode, _ = GEOMETRIES[name]
    rng = np.random.default_rng(list(GEOMETRIES).index(name))
    if name == "seam":
        g1, g2 = make_grids(rng, b=1, h1=4, w1=12, h2=4, w2=12, invalid_frac=0.0)
    else:
        g1, _ = make_grids(rng, b=2, h1=hw1[0], w1=hw1[1], h2=4, w2=6)
        _, g2 = make_grids(rng, b=2, h1=4, w1=6, h2=hw2[0], w2=hw2[1])
    if hw1 == hw2 and cs != (1, 1):
        g2 = g1
    perm = rng.permutation(kernel[0] * kernel[1]) if mode == FIRST_K else None
    return g1, g2, perm


def group_inputs():
    """(xyz, feats, perm) of the select_and_group case."""
    rng = np.random.default_rng(100)
    h, w = GROUP_CASE["hw"]
    g1, _ = make_grids(rng, b=2, h1=h, w1=w)
    feats = rng.standard_normal((2, h, w, GROUP_CASE["channels"])).astype(np.float32)
    kh, kw = GROUP_CASE["kernel"]
    return g1, feats, rng.permutation(kh * kw)


def grad_inputs(name):
    """(xyz, feats, perm, upstream) of a GRAD_CASES case, from a seed of its
    own: B=2 grids, and the upstream gradient of the groups (B, N, K, 3 + C)."""
    (h, w), c, kernel, k, _, cs, mode = GRAD_CASES[name]
    rng = np.random.default_rng(200 + list(GRAD_CASES).index(name))
    xyz, _ = make_grids(rng, b=2, h1=h, w1=w, invalid_frac=0.0 if name == "seam" else 0.3)
    feats = rng.standard_normal((2, h, w, c)).astype(np.float32)
    perm = rng.permutation(kernel[0] * kernel[1]) if mode == FIRST_K else None
    n = -(-h // cs[0]) * -(-w // cs[1])
    return xyz, feats, perm, rng.standard_normal((2, n, k, 3 + c)).astype(np.float32)


def widened_block(g, ring_index, ring_size, halo):
    """Grid g's sector ``ring_index`` of ``ring_size``, widened by ``halo``
    columns from each neighbour sector (W wraps): what the halo exchange
    gives that rank.  A numpy array or a tensor, returned as the same."""
    w = g.shape[2]
    w_loc = w // ring_size
    cols = np.arange(ring_index * w_loc - halo, (ring_index + 1) * w_loc + halo) % w
    if torch.is_tensor(g):
        return g[:, :, torch.as_tensor(cols, device=g.device)]
    return np.take(g, cols, axis=2)


def _max_diff(got, want):
    """Largest absolute difference of two tensors of one shape (0 for equal)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return float(diff.max()) if diff.numel() else 0.0


def _sector(x, n_h, n_w, ring_index, n_w_loc):
    """Centres of sector ``ring_index`` of a (B, n_h * n_w, K, ...) output,
    as (B, n_h, n_w_loc, K, ...)."""
    x = x.reshape(x.shape[0], n_h, n_w, *x.shape[2:])
    return x[:, :, ring_index * n_w_loc:(ring_index + 1) * n_w_loc]


def window_select_block(args, ring_size, ring_index, whole):
    """One rank's ``window_select`` kernel call on its block, for the
    whole-grid call ``args`` (the wrapper's positional arguments, on the
    card): centres from the rank's sector of grid 1, windows on its sector
    of grid 2 widened by the halo.  Held against the plain block version
    (``ring._select_on_block``: block-local and global idx, mask) and,
    after the global-index mapping, against the rank's sector of ``whole``,
    the unsharded kernel's (idx, mask).  Returns (the block call, the
    largest difference from the plain block version, the largest
    difference from the unsharded sector); 0 where equal."""
    from efficientlo_net_torch.ops import window_select as ws
    from efficientlo_net_torch.parallel import ring

    xyz1, xyz2, kernel, k, distance, cs, ss, mode, perm = args
    b, h1, w1, _ = xyz1.shape
    h2, w2 = xyz2.shape[1:3]
    n_h, n_w = -(-h1 // cs[0]), -(-w1 // cs[1])
    halo = ring._validate(w1, w2, n_w, cs[1], ss[1], kernel[1], ring_size)
    n_w_loc, w1_loc = n_w // ring_size, w1 // ring_size
    blk = xyz1[:, :, ring_index * w1_loc:(ring_index + 1) * w1_loc].contiguous()
    wide = widened_block(xyz2, ring_index, ring_size, halo)

    def call():
        return ws.window_select(blk, wide, kernel, k, distance, cs, ss, mode, perm,
                                centre_col_offset=0, source_col_offset=halo, n_w=n_w_loc)

    idx_local, mask = call()
    want_idx, want_mask, want_local = ring._select_on_block(
        blk, wide, ring_index, kernel_size=kernel, k=k, distance=distance, center_stride=cs,
        source_stride=ss, halo=halo, w1=w1, w2=w2, h2=h2, mode=mode, perm=perm)
    idx = ring._global_index(idx_local, mask, wide.shape[2], w2, halo, ring_index)
    idx, mask = idx.reshape(want_idx.shape), mask.reshape(want_mask.shape)
    plain = max(_max_diff(idx_local, want_local), _max_diff(idx, want_idx),
                _max_diff(mask, want_mask))
    unsharded = max(_max_diff(idx, _sector(whole[0], n_h, n_w, ring_index, n_w_loc)),
                    _max_diff(mask, _sector(whole[1], n_h, n_w, ring_index, n_w_loc)))
    return call, plain, unsharded


def select_and_group_block(args, ring_size, ring_index, whole):
    """One rank's ``select_and_group`` kernel call on its widened block
    (centres and source both from it), for the whole-grid call ``args``:
    held against the plain block version (``ring._select_on_block`` and a
    gather from the block) and against the rank's sector of ``whole``, the
    unsharded kernel's (xyz, feats, mask).  Returns (the block call, the
    largest difference from the plain block version, the largest
    difference from the unsharded sector); 0 where equal."""
    from efficientlo_net_torch.ops import window_select as ws
    from efficientlo_net_torch.parallel import ring

    xyz, feats, kernel, k, distance, cs, mode, perm = args
    b, h, w, _ = xyz.shape
    c = feats.shape[-1]
    n_h, n_w = -(-h // cs[0]), -(-w // cs[1])
    halo = ring._validate(w, w, n_w, cs[1], 1, kernel[1], ring_size)
    n_w_loc, w_loc = n_w // ring_size, w // ring_size
    wide = widened_block(xyz, ring_index, ring_size, halo)
    wide_f = widened_block(feats, ring_index, ring_size, halo)

    def call():
        return ws.select_and_group(wide, wide_f, kernel, k, distance, cs, mode, perm,
                                   centre_col_offset=halo, source_col_offset=halo, n_w=n_w_loc)

    got = call()
    blk = xyz[:, :, ring_index * w_loc:(ring_index + 1) * w_loc].contiguous()
    _, mask5, local = ring._select_on_block(
        blk, wide, ring_index, kernel_size=kernel, k=k, distance=distance, center_stride=cs,
        source_stride=(1, 1), halo=halo, w1=w, w2=w, h2=h, mode=mode, perm=perm)
    src = torch.cat([wide, wide_f], -1).reshape(b, -1, 3 + c)
    plain = torch.gather(src, 1, local.reshape(b, -1, 1).long().expand(-1, -1, 3 + c))
    plain = plain.reshape(b, -1, k, 3 + c) * mask5.reshape(b, -1, k, 1)
    grouped = torch.cat(got[:2], -1)
    plain_diff = max(_max_diff(grouped, plain), _max_diff(got[2].reshape(mask5.shape), mask5))
    unsharded = max(_max_diff(g.reshape(b, n_h, n_w_loc, k, -1),
                              _sector(u, n_h, n_w, ring_index, n_w_loc))
                    for g, u in zip(got, whole))
    return call, plain_diff, unsharded


def _max_rel(got, want):
    """Largest absolute difference relative to the largest entry of ``want``."""
    return _max_diff(got, want) / max(float(want.abs().max()), 1e-30)


def unsharded_group_grads(args, upstream):
    """The unsharded ``neighbors.select_and_group(fused=False)`` of a
    ``select_and_group`` call's (xyz, feats, kernel, k, distance, centre
    stride, mode, perm), and the autograd gradient of sum(upstream *
    groups), ``upstream`` (B, N, K, 3 + C): (groups, grad xyz, grad feats)."""
    from efficientlo_net_torch.ops import neighbors

    xyz, feats, kernel, k, distance, cs, mode, perm = args
    leaves = xyz.detach().requires_grad_(), feats.detach().requires_grad_()
    gx, gf, _ = neighbors.select_and_group(*leaves, kernel, k, distance, center_stride=cs,
                                           mode=mode, perm=perm, fused=False)
    groups = torch.cat([gx, gf], -1)
    grad_xyz, grad_feats = torch.autograd.grad(groups, leaves, upstream)
    return groups.detach(), grad_xyz, grad_feats


def train_block_grads(args, ring_size, upstream, whole):
    """The ring's training select and grouping (``ring._group_on_block``,
    unfused: the ``window_select`` kernel on CUDA tensors) on the widened
    [xyz | feats] block of every rank of a ring of ``ring_size``, emulated in
    one process, and its backward: the gradient of sum(upstream * groups)
    through each block's gather, folded back onto the sectors with
    ``ring.fold_halo_grad`` (each halo's gradient added to the edge columns
    of the neighbour that owns them) and put back in raster order.  ``args``
    and ``upstream`` as ``unsharded_group_grads`` takes them, ``whole`` what
    it returned.  Returns the largest difference of the groups from the
    unsharded ones, and of the gradients of xyz and of feats from the
    unsharded ones, relative to their largest entry."""
    from efficientlo_net_torch.parallel import ring

    xyz, feats, kernel, k, distance, cs, mode, perm = args
    b, h, w, _ = xyz.shape
    c = feats.shape[-1]
    n_h, n_w = -(-h // cs[0]), -(-w // cs[1])
    halo = ring._validate(w, w, n_w, cs[1], 1, kernel[1], ring_size)
    n_w_loc, w_loc = n_w // ring_size, w // ring_size
    src = torch.cat([xyz, feats], -1).detach()
    up = upstream.reshape(b, n_h, n_w, k, 3 + c)
    groups, wide_grads = [], []
    for r in range(ring_size):
        wide = widened_block(src, r, ring_size, halo).requires_grad_()
        gx, gf, _ = ring._group_on_block(
            xyz[:, :, r * w_loc:(r + 1) * w_loc], wide, r, kernel_size=kernel, k=k,
            distance=distance, center_stride=cs, mode=mode, perm=perm, halo=halo, w=w, h=h,
            fused=False)
        grouped = torch.cat([gx, gf], -1)
        groups.append(grouped.detach())
        wide_grads.append(torch.autograd.grad(
            grouped, wide, up[:, :, r * n_w_loc:(r + 1) * n_w_loc])[0])
    folded = torch.cat([ring.fold_halo_grad(g, halo, wide_grads[(r - 1) % ring_size][:, :, -halo:],
                                            wide_grads[(r + 1) % ring_size][:, :, :halo])
                        for r, g in enumerate(wide_grads)], 2)
    want_groups, want_xyz, want_feats = whole
    return (_max_diff(torch.cat(groups, 2).reshape(want_groups.shape), want_groups),
            _max_rel(folded[..., :3], want_xyz), _max_rel(folded[..., 3:], want_feats))


def circle_graph():
    """A noisy circle of 12 poses with a chain, 2 closures (16 factors of
    capacity) and 2 scan pairs of 64 point-to-plane correspondences each,
    zero residual at the ground truth: tests/test_multiprocess.py's PG_CHILD
    graph, as numpy.  Returns (gt (12, 4, 4), src, dst, meas, noise (12, 6),
    scan pairs, scan arrays (p_j, q_i, n_i) each (2, 64, 3))."""
    rng = np.random.default_rng(0)
    n = 12
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        m = np.eye(4)
        m[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        m[:3, 3] = [10 * np.cos(a), 10 * np.sin(a), 0.1 * k]
        gt.append(m)

    def rel(i, j):
        return np.linalg.inv(gt[i]) @ gt[j]

    src = list(range(n - 1)) + [0, 2]
    dst = list(range(1, n)) + [n - 1, 7]
    meas = np.stack([rel(i, j) for i, j in zip(src, dst)]).astype(np.float32)
    noise = 0.05 * rng.standard_normal((n, 6)).astype(np.float32)
    pairs = [(0, 1), (5, 6)]
    p, q, nrm = [], [], []
    for i, j in pairs:
        qi = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
        ni = rng.standard_normal((64, 3)).astype(np.float32)
        ni /= np.linalg.norm(ni, axis=-1, keepdims=True)
        t_ij = rel(i, j)
        p.append(((qi - t_ij[:3, 3]) @ t_ij[:3, :3]).astype(np.float32))
        q.append(qi)
        nrm.append(ni)
    return np.stack(gt), src, dst, meas, noise, pairs, (np.stack(p), np.stack(q), np.stack(nrm))


# ---------------------------------------------------------------------------
# spawning


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Spawned:
    """Rank jobs by name and world size, all started at once;
    ``result(job, rank)`` waits for the job and reads what that rank left."""

    def __init__(self, out_dir, jobs):
        self.out_dir = str(out_dir)
        self.contexts = {job: spawn(job, world, out_dir) for job, world in jobs.items()}
        self.joined = set()

    def result(self, job, rank=0):
        if job not in self.joined:
            join(self.contexts[job])
            self.joined.add(job)
        return torch.load(os.path.join(self.out_dir, f"{job}_rank{rank}.pt"), weights_only=False)

    def close(self):
        for job, context in self.contexts.items():
            if job not in self.joined:
                for process in context.processes:
                    process.kill()
                context.join(timeout=60)


def spawn(job: str, world: int, out_dir: str):
    """Start ``world`` rank processes of ``job``; returns the context to
    ``join``."""
    return mp.start_processes(_entry, args=(world, free_port(), job, str(out_dir)),
                              nprocs=world, join=False, start_method="spawn")


def join(context, timeout: float = 300.0) -> None:
    """Wait for every rank; raises (with the rank's traceback) if one failed."""
    while not context.join(timeout=timeout):
        pass


def _entry(rank, world, port, job, out_dir):
    torch.set_num_threads(1)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    JOBS[job](rank, world, port, out_dir)
    if dist.is_initialized():
        dist.destroy_process_group()


def _save(out_dir, job, rank, obj):
    torch.save(obj, os.path.join(out_dir, f"{job}_rank{rank}.pt"))


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# job "ring" (6 ranks): ring selects on a (2, 3) mesh and on rings of 4 and 5,
# the ring eval forward and the distributed pose-graph solve on 4 ranks


def _ring_job(rank, world, port, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from efficientlo_net_torch.parallel import ring
    from efficientlo_net_torch.parallel.distributed import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh23 = init_device_mesh("cpu", (2, 3), mesh_dim_names=("data", "ring"))
    rings = {3: mesh23, 4: dist.new_group([0, 1, 2, 3]), 5: dist.new_group([0, 1, 2, 3, 4])}
    out = {}
    for name, (_, _, kernel, k, distance, cs, ss, mode, ring_size) in GEOMETRIES.items():
        if rank >= ring_size * (2 if ring_size == 3 else 1):
            continue
        mesh = rings[ring_size]
        g1, g2, perm = ring_inputs(name)
        idx, mask = ring.ring_select_neighbors(
            ring.shard_w(torch.from_numpy(g1), mesh), ring.shard_w(torch.from_numpy(g2), mesh),
            kernel, k, distance, mesh=mesh, center_stride=cs, source_stride=ss, mode=mode,
            perm=None if perm is None else torch.from_numpy(perm))
        b = g1.shape[0]
        out[name] = (_np(ring.gather_w(idx, mesh, batch=b).reshape(b, -1, k)),
                     _np(ring.gather_w(mask, mesh, batch=b).reshape(b, -1, k, 1)))
    xyz, feats, perm = group_inputs()
    c = GROUP_CASE
    out["select_and_group"] = [_np(t) for t in ring.ring_select_and_group_replicated(
        torch.from_numpy(xyz), torch.from_numpy(feats), c["kernel"], c["k"], c["distance"],
        mesh=mesh23, center_stride=c["stride"], mode=FIRST_K, perm=torch.from_numpy(perm))]
    if rank < 4:
        out["forward"] = _ring_forward(rings[4], out_dir)
        out["optimize"] = _distributed_optimize(rings[4], out_dir)
    _save(out_dir, "ring", rank, out)


def _ring_forward(group, out_dir):
    """The tiny network's eval forward with its level-0 select on the ring,
    and without; (q, t) at l0..l3 of each."""
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.models.pwclo import PWCLONet

    model = PWCLONet(tiny_model_config())
    model.load_state_dict(torch.load(os.path.join(out_dir, "forward_weights.pt")), strict=True)
    model.eval()
    p1, p2 = (torch.from_numpy(np.load(os.path.join(out_dir, f"forward_{n}.npy")))
              for n in ("p1", "p2"))
    with torch.no_grad():
        got = model(p1, p2, ring_group=group)
        plain = model(p1, p2)
    return {k: ([_np(v) for v in got[k]], [_np(v) for v in plain[k]]) for k in ("q", "t")}


def _distributed_optimize(group, out_dir):
    """``optimize(group=)`` with scan factors on the circle graph, and the
    single-process solve."""
    from efficientlo_net_torch.backend import pose_graph as pg
    from efficientlo_net_torch.backend import scan_factors as sfm

    _, src, dst, meas, _, pairs, (p, q, nrm) = circle_graph()
    poses0 = torch.from_numpy(np.load(os.path.join(out_dir, "circle_poses0.npy")))
    factors = pg.make_factors(src, dst, meas, num_nodes=12, capacity=16, device="cpu")
    scan = sfm.make_scan_factors(pairs, [
        sfm.Correspondences(p_j=torch.from_numpy(p[i]), q_i=torch.from_numpy(q[i]),
                            n_i=torch.from_numpy(nrm[i]), w=torch.ones(64))
        for i in range(len(pairs))])
    cfg = pg.GaussNewtonConfig(iterations=12)
    opt, hist = pg.optimize(poses0, factors, cfg, scan_factors=scan, group=group)
    single, single_hist = pg.optimize(poses0, factors, cfg, scan_factors=scan)
    return {"opt": _np(opt), "hist": _np(hist), "single": _np(single),
            "single_hist": _np(single_hist)}


# ---------------------------------------------------------------------------
# job "dp" (2 ranks): the CLI with --coordinator in test mode (which joins the
# group), host-sharded evaluation, checkpoints, data-parallel train steps, the
# data-parallel trainer and its restore, SLAM with its solves over the group


@contextlib.contextmanager
def tiny_cli_config():
    """``config.ModelConfig`` returns the tiny config (the CLI builds the full
    one from its flags) while the block runs."""
    from efficientlo_net_torch import config

    original, tiny = config.ModelConfig, config.tiny_model_config()
    config.ModelConfig = lambda sensor, compute_dtype: dataclasses.replace(
        tiny, compute_dtype=compute_dtype)
    try:
        yield
    finally:
        config.ModelConfig = original


def _dp_job(rank, world, port, out_dir):
    from efficientlo_net_torch import cli
    from efficientlo_net_torch.parallel.distributed import (aggregate_mean_t_rel, process_count,
                                                            shard_sequences_by_host)

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    root, gt_dir = (os.path.join(out_dir, "kitti", d) for d in ("dataset", "ground_truth_pose"))
    with tiny_cli_config():
        cli.main(["--mode", "test", "--coordinator", f"127.0.0.1:{port}", "--device", "cpu",
                  "--data_root", root, "--gt_dir", gt_dir, "--test_list", str(KITTI_SEQ),
                  "--batch_size", "8", "--no_host_projection",
                  "--log_dir", os.path.join(out_dir, "cli_log"),
                  "--result_dir", os.path.join(out_dir, f"cli_result{rank}")])
    out = {"world": process_count()}

    class Result:
        def __init__(self, t_rel):
            self.t_rel = t_rel

    local = shard_sequences_by_host([7, 8, 9, 10])
    vals = {7: 1.0, 8: 2.0, 9: 3.0, 10: 6.0}
    out["sequences"] = local
    out["mean_t_rel"] = aggregate_mean_t_rel({s: Result(vals[s]) for s in local})
    out["checkpoint"] = _checkpoints(rank, os.path.join(out_dir, "ckpt"))
    out["dp_vs_jax"] = {seed: _dp_step(rank, out_dir, scan_order=True, seed=seed)
                        for seed in DP_JAX_SEEDS}
    out["dp_vs_single"] = _dp_step(rank, out_dir, scan_order=False, seed=DP_BATCH_SEED)
    out["trainer"] = _dp_trainer(rank, out_dir)
    out["slam"] = _slam_drives(rank, dist.group.WORLD)
    _save(out_dir, "dp", rank, out)


def _tiny_state(w, seed):
    """A train state whose network is one 4x4 dense layer filled with ``w``
    at ``seed`` steps: the checkpoint round trip of tests/test_multiprocess.py."""
    from efficientlo_net_torch.config import TrainConfig
    from efficientlo_net_torch.training.state import create_train_state

    layer = torch.nn.Linear(4, 4)
    with torch.no_grad():
        layer.weight.fill_(w)
    state = create_train_state(layer, TrainConfig(), device="cpu", w_x=0.0, w_q=-2.5)
    state.step = seed
    return state


def _checkpoints(rank, ckpt_dir):
    """tests/test_multiprocess.py's CHILD on the port: rank 0 writes, every
    rank restores, the metadata and the best marking."""
    from efficientlo_net_torch.training.checkpoint import CheckpointManager

    state = _tiny_state(1.5, 7)
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.save(state, metrics={"val_t_rel": 2.5}, epoch=4) == 7
    restored = mgr.restore(_tiny_state(0.0, 0))
    meta = mgr.metadata()
    first = mgr.maybe_save_best(state, 2.0, epoch=4)
    best = mgr.best_error()
    second = mgr.maybe_save_best(state, 3.0, epoch=5)
    return {"step": restored.step, "w": float(restored.model.weight[0, 0]),
            "w_q": float(restored.w_q), "meta": meta, "first_best": first, "best": best,
            "second_best": second}


def _step_result(state, metrics):
    """What the parent compares of a train step: the metrics, the gradients
    (``w_x`` and ``w_q`` too), the new batch statistics and the parameters
    after the update, flat."""
    grads = {k: _np(p.grad) for k, p in state.model.named_parameters()}
    grads.update(w_x=_np(state.w_x.grad), w_q=_np(state.w_q.grad))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "stats": {k: _np(v) for k, v in state.model.state_dict().items()
                      if k.endswith((".mean", ".var"))},
            "params": np.concatenate([_np(p).reshape(-1) for p in state.parameters()])}


def _dp_step(rank, out_dir, scan_order, seed):
    """One data-parallel step on this rank's rows of the B=4 batch of numpy
    ``seed``, from the parent's weights (random, near-identity pose heads), after
    ``replicate_state`` undid a perturbation of rank 1's copy.  With
    ``scan_order``: dropout 0 and no scan permutations, as the JAX reference;
    else the tiny config's dropout and a fresh permutation per first-K
    select from a seeded generator.  Rank 0's single-process step at B=4
    beside it."""
    from efficientlo_net_torch.config import TrainConfig, tiny_model_config
    from efficientlo_net_torch.data.synthetic import synthetic_batch
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.parallel.data_parallel import (make_sharded_train_step,
                                                              replicate_state)
    from efficientlo_net_torch.parallel.mesh import make_mesh, shard_batch
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step

    cfg = tiny_model_config()
    if scan_order:
        cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=4, host_projection=False)
    weights = torch.load(os.path.join(out_dir, "train_weights.pt"))
    batch = synthetic_batch(np.random.default_rng(seed), 4, cfg.sensor, training=True)

    def fresh_state():
        model = PWCLONet(cfg)
        model.load_state_dict(weights["state_dict"], strict=True)
        return create_train_state(model, tcfg, device="cpu", w_x=weights["w_x"],
                                  w_q=weights["w_q"])

    from efficientlo_net_torch.models.pwclo import PWCLONet as Net

    perm = Net.__dict__["_perm"]
    if scan_order:
        Net._perm = staticmethod(lambda kernel_size, stochastic, generator: None)
    try:
        mesh = make_mesh(device_type="cpu")
        state = fresh_state()
        if rank == 1:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(1.0)
        replicate_state(state, mesh)
        step = make_sharded_train_step(cfg, tcfg, mesh)
        out = {"dp": _step_result(*step(state, shard_batch(mesh, batch),
                                        torch.Generator().manual_seed(5)))}
        if rank == 0:
            out["single"] = _step_result(*make_train_step(cfg, tcfg)(
                fresh_state(), batch, torch.Generator().manual_seed(5)))
    finally:
        Net._perm = perm
    return out


def _dp_trainer(rank, out_dir):
    """``Trainer(use_mesh=True)`` over the group: one step of epoch 0 through
    its loader from the parent's weights, and the single-process trainer's
    step beside it.  Each trainer's step is recorded with the batch and the
    generator seed it was given, and is taken again from fresh weights by
    the step function alone: ``make_sharded_train_step`` on the data-parallel
    trainer's rows, ``make_train_step`` on the single trainer's batch.
    Then the data-parallel state is saved, and a fresh trainer on each rank
    (rank 1's parameters perturbed) restores it."""
    from efficientlo_net_torch.config import TrainConfig, tiny_model_config
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.parallel.data_parallel import make_sharded_train_step
    from efficientlo_net_torch.parallel.mesh import shard_batch
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step
    from efficientlo_net_torch.training.trainer import Trainer

    weights = torch.load(os.path.join(out_dir, "train_weights.pt"))
    root, gt_dir = (os.path.join(out_dir, "kitti", d) for d in ("dataset", "ground_truth_pose"))
    log_dir = os.path.join(out_dir, "trainer_dp")
    cfg, tcfg = tiny_model_config(), TrainConfig(batch_size=4, host_projection=False)

    def trainer(log, use_mesh):
        t = Trainer(cfg, tcfg, data_root=root, log_dir=log, gt_dir=gt_dir, train_list=[KITTI_SEQ],
                    val_list=[KITTI_SEQ], device="cpu", use_mesh=use_mesh)
        t.state.model.load_state_dict(weights["state_dict"], strict=True)
        with torch.no_grad():
            t.state.w_x.fill_(float(weights["w_x"]))
            t.state.w_q.fill_(float(weights["w_q"]))
        return t

    def one_step(t):
        """The trainer's first step: its result, batch and generator seed."""
        given = {}
        step = t.train_step

        def recorded(state, batch, generator):
            given.update(batch={k: v.clone() for k, v in batch.items()},
                         seed=generator.initial_seed())
            return step(state, batch, generator)

        t.train_step = recorded
        loss = t.train_one_epoch(0, limit_batches=1)
        return _step_result(t.state, {"loss": torch.tensor(loss)}), given["batch"], given["seed"]

    def fresh_state():
        model = PWCLONet(cfg)
        model.load_state_dict(weights["state_dict"], strict=True)
        return create_train_state(model, tcfg, device="cpu", w_x=weights["w_x"],
                                  w_q=weights["w_q"])

    dp = trainer(log_dir, use_mesh=True)
    out = {"mesh": dp.mesh is not None}
    out["dp"], dp_batch, dp_seed = one_step(dp)
    # every rank builds and steps it: its checkpoint manager's barrier is collective
    out["single"], batch, seed = one_step(trainer(os.path.join(out_dir, "trainer_single"),
                                                  use_mesh=False))
    rows = shard_batch(dp.mesh, batch)
    out["rows_equal"] = dp_batch.keys() == rows.keys() and all(
        torch.equal(dp_batch[k], rows[k]) for k in rows)
    out["seeds"] = (dp_seed, seed)
    out["dp_step"] = _step_result(*make_sharded_train_step(cfg, tcfg, dp.mesh)(
        fresh_state(), dp_batch, torch.Generator().manual_seed(dp_seed)))
    out["single_step"] = _step_result(*make_train_step(cfg, tcfg)(
        fresh_state(), batch, torch.Generator().manual_seed(seed)))
    out["saved_step"] = dp.ckpt.save(dp.state, epoch=0)
    fresh = trainer(log_dir, use_mesh=True)
    if rank == 1:
        with torch.no_grad():
            for p in fresh.state.model.parameters():
                p.add_(1.0)
    fresh.restore()
    out["restored"] = {"step": fresh.state.step, "start_epoch": fresh.start_epoch,
                       "params": np.concatenate([_np(p).reshape(-1)
                                                 for p in fresh.state.parameters()])}
    return out


def _slam_drives(rank, group):
    """``SlidingWindowSLAM(group=)`` on every rank, and on rank 0 the same
    drive without a group: a biased square whose closures come from the
    ground truth, window solves along the way, then the global pass over
    every keyframe, whose factors (chain and closures) the group's size
    does not divide, so it pads them.  The keyframe poses after the window
    solves and after the global pass, and the global pass's factor count."""
    from efficientlo_net_torch.backend.slam import SlidingWindowSLAM
    from test_torch_slam_cases import biased_square_gt, cfg, drive_biased_square, gt_oracle

    gt = biased_square_gt(steps=SLAM_STEPS)
    out = {}
    for name, g in (("group", group), ("single", None)):
        if g is None and rank != 0:
            continue
        slam = SlidingWindowSLAM(
            cfg(keyframe_distance=2.0, window_size=12, optimize_every=5, closure_radius=4.0,
                closure_min_gap=10, closure_search_all=True),
            closure_fn=gt_oracle(gt), group=g)
        drive_biased_square(slam, steps=SLAM_STEPS)
        slam.optimize_window()
        window = np.stack(slam.kf_poses)
        slam.global_optimize()
        out[name] = {"window": window, "global": np.stack(slam.kf_poses),
                     "closures": len(slam.closed_pairs),
                     "global_factors": len(slam.kf_poses) - 1 + len(slam.closure_archive)}
    return out


# ---------------------------------------------------------------------------
# job "ring_train" (8 ranks): the ring functions' gradients on (2, R) meshes,
# the tiny network in training on a ring of 4 and on a (2, 2) mesh


def _grad_mesh(ring_size, world):
    """A (2, R) ("data", "ring") mesh over the first 2R ranks where the
    world has them, else (1, R), as tests/test_ring.py's ``ring_mesh``
    falls back on its 8 devices.  Every rank must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    data = 2 if 2 * ring_size <= world else 1
    return DeviceMesh("cpu", torch.arange(data * ring_size).reshape(data, ring_size),
                      mesh_dim_names=("data", "ring"))


def _ring_grads(name, mesh):
    """``ring_select_and_group_replicated`` (unfused) on a GRAD_CASES case
    and the gradient of sum(upstream * groups) in xyz and feats: (the
    groups, grad xyz, grad feats)."""
    from efficientlo_net_torch.parallel import ring

    _, _, kernel, k, distance, cs, mode = GRAD_CASES[name]
    xyz, feats, perm, up = grad_inputs(name)
    leaves = torch.from_numpy(xyz).requires_grad_(), torch.from_numpy(feats).requires_grad_()
    gx, gf, _ = ring.ring_select_and_group_replicated(
        *leaves, kernel, k, distance, mesh=mesh, center_stride=cs, mode=mode,
        perm=None if perm is None else torch.from_numpy(perm))
    grouped = torch.cat([gx, gf], -1)
    grads = torch.autograd.grad(grouped, leaves, torch.from_numpy(up))
    return _np(grouped), _np(grads[0]), _np(grads[1])


def _ring_train_pass(out_dir, stochastic, group):
    """The tiny network's training forward, ``total_loss`` and backward on the
    RING_TRAIN_SEED batch from the parent's weights, with the generator seed
    RING_TRAIN_GEN_SEED and bn momentum of step 0, its level-0 select on
    ``group`` (None: unsharded).  ``stochastic``: the tiny config's dropout
    and a scan permutation per first-K select; else dropout 0 in scan order
    (the JAX reference's).  ``_step_result``'s record, with q and t."""
    from efficientlo_net_torch.config import TrainConfig, tiny_model_config
    from efficientlo_net_torch.data.synthetic import synthetic_batch
    from efficientlo_net_torch.models.losses import total_loss
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import _forward_inputs

    cfg = tiny_model_config()
    if not stochastic:
        cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=4, host_projection=False)
    weights = torch.load(os.path.join(out_dir, "train_weights.pt"))
    model = PWCLONet(cfg)
    model.load_state_dict(weights["state_dict"], strict=True)
    state = create_train_state(model, tcfg, device="cpu", w_x=weights["w_x"], w_q=weights["w_q"])
    batch = synthetic_batch(np.random.default_rng(RING_TRAIN_SEED), 4, cfg.sensor, training=True)
    p1, p2, q_gt, t_gt = _forward_inputs(batch, cfg.sensor, "cpu")
    momentum = torch.tensor(tcfg.bn_momentum(0), dtype=torch.float32)
    out = state.model.train()(p1, p2, bn_momentum=momentum, stochastic=stochastic,
                              generator=torch.Generator().manual_seed(RING_TRAIN_GEN_SEED),
                              ring_group=group)
    loss, metrics = total_loss(out, q_gt, t_gt, state.w_x, state.w_q)
    loss.backward()
    return {**_step_result(state, metrics), "q": [_np(q) for q in out["q"]],
            "t": [_np(t) for t in out["t"]]}


def _ring_train_job(rank, world, port, out_dir):
    from efficientlo_net_torch.parallel.distributed import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    meshes = {r: _grad_mesh(r, world) for r in GRAD_RINGS}
    ring4 = dist.new_group([0, 1, 2, 3])
    out = {"grads": {}, "network": {}}
    for name in GRAD_CASES:
        for r, mesh in meshes.items():
            if rank < mesh.mesh.numel():
                out["grads"][name, r] = _ring_grads(name, mesh)
    if rank < 4:
        for which, group in (("ring4", ring4), ("mesh22", meshes[2])):
            for stochastic in (False, True):
                out["network"][which, stochastic] = _ring_train_pass(out_dir, stochastic, group)
    if rank == 0:
        for stochastic in (False, True):
            out["network"]["unsharded", stochastic] = _ring_train_pass(out_dir, stochastic, None)
    _save(out_dir, "ring_train", rank, out)


JOBS = {"ring": _ring_job, "dp": _dp_job, "ring_train": _ring_train_job}
