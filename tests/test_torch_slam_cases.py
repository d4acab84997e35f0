"""The port's sliding-window SLAM by behaviour, on the CPU, and a
loop-closure measurement on the card.

The assertions of the JAX package's tests/test_slam.py, run on torch alone
with the solver on the CPU (``solver_device="cpu"``).  Where a JAX test
drives once only to learn the ground truth that its closure oracle reads,
the ground truth is computed here directly (the same poses).  The ``cuda``
case measures a pair with ``OdometryStream.measure_relative`` through the
kernels and checks its launches.  No JAX import:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_slam_cases.py
"""

import numpy as np
import pytest
import torch

from efficientlo_net_torch.backend.slam import SlamConfig, SlidingWindowSLAM
from efficientlo_net_torch.config import SensorConfig
from efficientlo_net_torch.ops import se3
from efficientlo_net_torch.ops.projection import project_to_range_image
from efficientlo_net_torch.ops.quaternion import mat_to_quat

TURN = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, and the suite
    runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg(**kw):
    return SlamConfig(solver_device="cpu", **kw)


def exp(xi):
    return se3.se3_exp(torch.as_tensor(np.asarray(xi), dtype=torch.float32)).double().numpy()


def quat(m):
    return mat_to_quat(torch.as_tensor(m[:3, :3], dtype=torch.float32)).numpy()


def step(dx=0.5):
    rel = np.eye(4)
    rel[0, 3] = dx
    return rel


def turn():
    rel = np.eye(4)
    rel[:3, :3] = TURN
    return rel


def drive_square(slam, side=20.0, noise=0.0, rng=None, payloads=False):
    """A square loop of 0.5 m steps with 90-degree turns; returns GT poses.
    ``payloads=True`` attaches a dummy payload to every frame (so keyframes
    become loop-closure candidates)."""
    gt = [np.eye(4)]
    pl = (lambda: np.zeros((2, 2, 3))) if payloads else None

    def feed(rel):
        gt.append(gt[-1] @ rel)
        slam.add_frame(quat(rel), rel[:3, 3], payload=pl)

    for _ in range(4):
        for _ in range(int(side / 0.5)):
            rel = step()
            if noise and rng is not None:
                rel = rel @ exp(rng.standard_normal(6) * noise)
            feed(rel)
        feed(turn())
    return np.stack(gt)


def biased_square_gt(legs=4, steps=40):
    gt = [np.eye(4)]
    for _ in range(legs):
        for _ in range(steps):
            gt.append(gt[-1] @ step())
        gt.append(gt[-1] @ turn())
    return np.stack(gt)


def drive_biased_square(slam, legs=4, steps=40, bias_yaw=0.002, first=0):
    """Square loop with a systematic yaw bias in odometry; each frame's
    payload is its GT index (offset by ``first``)."""
    bias = exp([0, 0, 0, 0, 0, bias_yaw])
    k = first
    for _ in range(legs):
        for _ in range(steps):
            noisy = step() @ bias
            k += 1
            slam.add_frame(quat(noisy), noisy[:3, 3], payload=k)
        k += 1
        slam.add_frame(quat(turn()), np.zeros(3), payload=k)


def gt_oracle(gt):
    """Closure function returning the true relative pose of two payloads
    (GT indices), as a perfect odometry network would."""
    return lambda payload_j, payload_i: np.linalg.inv(gt[payload_j]) @ gt[payload_i]


def end_error(slam, gt_end):
    return float(np.linalg.norm(slam.kf_poses[-1][:3, 3] - gt_end[:3, 3]))


def test_keyframe_promotion_and_trajectory():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, optimize_every=1000))
    gt = drive_square(slam)
    assert 20 < len(slam.kf_poses) < 80
    traj = np.stack(slam.full_trajectory)
    assert traj.shape[0] == gt.shape[0]
    np.testing.assert_allclose(traj[-1], gt[-1], atol=1e-6)


def test_window_optimization_runs_and_is_consistent():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=10, optimize_every=3))
    drive_square(slam, noise=0.002, rng=np.random.default_rng(0))
    assert np.isfinite(slam.optimize_window())
    for p in slam.kf_poses:
        np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-4)


def test_loop_closure_improves_endpoint():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=200, optimize_every=10**9))
    drive_biased_square(slam)
    gt = biased_square_gt()
    before = end_error(slam, gt[-1])
    slam.add_loop_closure(0, len(slam.kf_poses) - 1, np.linalg.inv(gt[0]) @ gt[-1], weight=100.0)
    slam.optimize_window()
    assert end_error(slam, gt[-1]) < before * 0.5


def test_window_limits_graph_size():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=1.0, window_size=5, optimize_every=2))
    drive_square(slam, side=30.0)
    assert len(slam.kf_poses) > 5
    assert len(slam._window_ids()) == 5


def test_marginalization_prior_preserves_closure_information():
    """A strong factor to a node that then leaves the window keeps
    constraining the window through the Schur prior; without
    marginalization it is dropped."""
    gt = biased_square_gt(legs=2, steps=30)

    def run(marginalize):
        slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=6, optimize_every=3,
                                     marginalize=marginalize))
        drive_biased_square(slam, legs=2, steps=30, bias_yaw=0.004)
        f2, f10 = slam.kf_frame_ids[2], slam.kf_frame_ids[10]
        slam.add_loop_closure(2, 10, np.linalg.inv(gt[f2]) @ gt[f10], weight=200.0)
        slam.optimize_window()
        drive_biased_square(slam, legs=2, steps=30, bias_yaw=0.004, first=len(gt) - 1)
        slam.optimize_window()
        return slam

    with_prior, without = run(True), run(False)
    assert with_prior._prior is not None
    assert len(with_prior._prior.node_ids) >= 1
    gt_end = biased_square_gt(legs=4, steps=30)[-1]
    assert end_error(with_prior, gt_end) <= end_error(without, gt_end) * 1.05


def test_automatic_loop_closure_detection():
    """Re-entering the start area, the detector finds the closure by itself
    and corrects the drift."""
    gt = biased_square_gt()

    def run(with_detection):
        slam = SlidingWindowSLAM(
            cfg(keyframe_distance=2.0, window_size=100, optimize_every=5, closure_radius=4.0,
                closure_min_gap=10),
            closure_fn=gt_oracle(gt) if with_detection else None)
        drive_biased_square(slam)
        return slam

    off, on = run(False), run(True)
    assert len(on.closed_pairs) >= 1
    assert end_error(on, gt[-1]) < end_error(off, gt[-1]) * 0.5


def test_loop_closure_beyond_window():
    """A loop longer than the window: whole-history search finds the revisit
    and the closure to the frozen keyframe reaches the window through the
    prior (closure_to_frozen="window")."""
    gt = biased_square_gt()

    def run(search_all):
        slam = SlidingWindowSLAM(
            cfg(keyframe_distance=2.0, window_size=12, optimize_every=5, closure_radius=4.0,
                closure_min_gap=10, closure_search_all=search_all, closure_to_frozen="window"),
            closure_fn=gt_oracle(gt) if search_all else None)
        drive_biased_square(slam)
        return slam

    off, on = run(False), run(True)
    assert len(on.closed_pairs) >= 1
    assert end_error(on, gt[-1]) < end_error(off, gt[-1]) * 0.6


def test_lazy_payload_resolved_only_on_promotion():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, optimize_every=1000))
    calls = []

    def make_payload(i):
        def thunk():
            calls.append(i)
            return f"payload-{i}"
        return thunk

    for i in range(6):
        slam.add_frame(np.array([1.0, 0, 0, 0]), np.array([0.5, 0, 0]), payload=make_payload(i))
    assert calls == [3]  # frame 3 crossed 2.0 m; later frames unresolved
    assert slam.kf_payloads[1] == "payload-3"


def test_window_optimization_is_noop_on_pure_chain():
    """With only odometry factors the composed chain is the exact optimum:
    repeated window optimization and marginalization leave every keyframe
    where raw integration put it (the JAX package lost 8.5 m here on a TPU
    before it forced full-precision matmuls)."""
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=12, optimize_every=4))
    yaw = 0.004
    m = exp([0.0, 0, 0, 0, 0, yaw])
    m[:3, 3] = [0.5, 0, 0]
    raw = [np.eye(4)]
    for _ in range(240):
        slam.add_frame(np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]), np.array([0.5, 0, 0]))
        raw.append(raw[-1] @ m)
    slam.optimize_window()
    errs = [np.linalg.norm(slam.kf_poses[k][:3, 3] - raw[f][:3, 3])
            for k, f in enumerate(slam.kf_frame_ids)]
    assert max(errs) < 1e-3, f"chain no-op violated: max drift {max(errs)} m"


def test_global_optimize_spreads_late_closure():
    gt = biased_square_gt()
    slam = SlidingWindowSLAM(
        cfg(keyframe_distance=2.0, window_size=12, optimize_every=5, closure_radius=4.0,
            closure_min_gap=10, closure_search_all=True),
        closure_fn=gt_oracle(gt))
    drive_biased_square(slam)
    slam.optimize_window()
    assert len(slam.closed_pairs) >= 1

    def mean_ate():
        kf = np.stack(slam.kf_poses)
        return float(np.linalg.norm(kf[:, :3, 3] - gt[np.asarray(slam.kf_frame_ids)][:, :3, 3],
                                    axis=1).mean())

    ate_window = mean_ate()
    slam.global_optimize()
    assert mean_ate() < ate_window * 0.6


def test_global_optimize_is_noop_without_new_information():
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=12, optimize_every=4))
    drive_square(slam, noise=0.004, rng=np.random.default_rng(5))
    slam.optimize_window()
    before = np.stack(slam.kf_poses)
    slam.global_optimize()
    err = np.linalg.norm(before[:, :3, 3] - np.stack(slam.kf_poses)[:, :3, 3], axis=1).max()
    assert err < 1e-3, err


def test_global_optimize_keeps_prior_consistent():
    """The global pass transports the prior's linearization points by each
    node's own correction, so the prior's local deltas are invariant."""
    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, window_size=8, optimize_every=3))
    drive_square(slam, noise=0.01, rng=np.random.default_rng(2))
    assert slam._prior is not None
    n = len(slam.kf_poses)
    rel = np.linalg.inv(slam.kf_poses[0]) @ slam.kf_poses[n - 1]
    rel[:3, 3] += [0.5, -0.3, 0.1]
    slam.add_loop_closure(0, n - 1, rel)

    def prior_deltas():
        lin = slam._prior.lin_poses.double().numpy()
        d = [np.linalg.inv(lin[k]) @ slam.kf_poses[g] for k, g in enumerate(slam._prior.node_ids)]
        return se3.se3_log(torch.as_tensor(np.stack(d), dtype=torch.float32)).numpy()

    before = prior_deltas()
    pre = [p.copy() for p in slam.kf_poses]
    slam.global_optimize()
    assert max(np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(pre, slam.kf_poses)) > 0.05
    np.testing.assert_allclose(prior_deltas(), before, atol=1e-5)


def test_closure_icp_polish_and_gate():
    sensor = SensorConfig(height=16, width=256, num_points=8192)
    rng = np.random.default_rng(3)
    m = 16 * 8192 // 4
    pts = [np.column_stack([rng.uniform(-8, 8, size=(m, 2)), np.full(m, -1.5)])]
    for wall in ((6.0, None), (None, -5.0), (None, 7.0)):
        a, z = rng.uniform(-8, 8, m), rng.uniform(-1.2, 1.2, m)
        pts.append(np.column_stack([np.full(m, wall[0]), a, z]) if wall[0] is not None
                   else np.column_stack([a, np.full(m, wall[1]), z]))
    world = np.concatenate(pts).astype(np.float32)

    def scan_from(pose):
        local = (world - pose[:3, 3]) @ pose[:3, :3]
        local = local[np.linalg.norm(local[:, :2], axis=1) < 12.0]
        img, _ = project_to_range_image(torch.as_tensor(local, dtype=torch.float32)[None], None,
                                        sensor.height, sensor.width, sensor,
                                        method="packed")
        return img[0].numpy()

    t_true = np.eye(4)
    c, s = np.cos(0.03), np.sin(0.03)
    t_true[:2, :2] = [[c, -s], [s, c]]
    t_true[:3, 3] = [0.4, 0.15, 0.02]
    slam = SlidingWindowSLAM(cfg(closure_icp=True, scan_max_dist=1.0, closure_icp_min_inliers=0.2,
                                 closure_icp_max_rms=0.05), scan_sensor=sensor)
    slam.kf_poses = [np.eye(4), t_true.copy()]
    slam.kf_payloads = [scan_from(np.eye(4)), scan_from(t_true)]
    pert = np.eye(4)
    pert[:3, 3] = [0.08, -0.05, 0.02]
    polished = slam._icp_polish(0, 1, t_true @ pert)
    assert polished is not None
    err0 = np.linalg.norm((t_true @ pert)[:3, 3] - t_true[:3, 3])
    assert np.linalg.norm(polished[:3, 3] - t_true[:3, 3]) < 0.25 * err0
    far = np.eye(4)
    far[:3, 3] = [40.0, 0.0, 0.0]  # associates nothing: gated out
    assert slam._icp_polish(0, 1, far) is None


def test_detect_loop_closures_seeds_rel_init():
    seen = []

    def closure_fn(pj, pi, rel_init=None):
        seen.append(rel_init)
        return rel_init

    slam = SlidingWindowSLAM(cfg(keyframe_distance=2.0, optimize_every=1000, closure_radius=6.0,
                                 closure_min_gap=5, closure_search_all=True),
                             closure_fn=closure_fn)
    slam.set_initial_payload(np.zeros((2, 2, 3)))
    drive_square(slam, side=12.0, payloads=True)
    assert len(seen) > 0
    assert all(r is not None and r.shape == (4, 4) for r in seen)
    assert len(slam.closed_pairs) > 0


def test_slam_refuses_missing_cuda():
    """The solver defaults to the card and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlidingWindowSLAM(SlamConfig())


@pytest.mark.cuda
def test_measure_relative_on_the_card_launches_both_kernels():
    """measure_relative with and without a seed, tiny config on the card:
    1 + r towers and r correlation passes with a seed (14 window_select per
    pass, 4 select_and_group per tower and 1 per pass), one more of each
    without; the same result through the plain selects."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.data.synthetic import synthetic_pair
    from efficientlo_net_torch.evaluation.streaming import OdometryStream
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.ops import neighbors as nbr
    from efficientlo_net_torch.ops import window_select as ws

    tiny = tiny_model_config()
    torch.manual_seed(0)
    stream = OdometryStream(PWCLONet(tiny), tiny, device="cuda")
    pc1, pc2, _ = synthetic_pair(np.random.default_rng(0), tiny.sensor)
    imgs = [stream.project(torch.as_tensor(p, device="cuda")[None]) for p in (pc1, pc2)]
    seed = np.eye(4)
    seed[0, 3] = 0.3
    r = 2
    for t_init, towers, passes in ((seed, 1 + r, r), (None, 2 + r, r + 1)):
        ws.reset_launches()
        got = stream.measure_relative(imgs[0], imgs[1], t_init=t_init, refinements=r)
        assert ws.launches == {"window_select": 14 * passes,
                               "select_and_group": 4 * towers + passes}
        assert got.shape == (4, 4) and got.dtype == np.float64 and np.all(np.isfinite(got))
        kernel_sites = ws.window_select, ws.select_and_group
        ws.window_select, ws.select_and_group = (nbr.select_neighbors_plain,
                                                 nbr.select_and_group_plain)
        try:
            plain = stream.measure_relative(imgs[0], imgs[1], t_init=t_init, refinements=r)
        finally:
            ws.window_select, ws.select_and_group = kernel_sites
        np.testing.assert_allclose(got, plain, atol=1e-5)
