"""The port's SE(3) maps, pose-graph solver and scan factors by behaviour, on
the CPU, and card-against-CPU cases.

The assertions of the JAX package's tests/test_se3.py, test_pose_graph.py and
test_scan_factors.py (not their mesh cases, which belong to the parallelism
slice), run on torch alone.  The ``cuda`` cases run the solver, ICP and the
scan-factor assembly on the card from the CPU's inputs, the solver under
``torch.set_float32_matmul_precision("high")``: the port must keep float32
there.  No JAX import, so the card cases run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_backend_cases.py
"""

import numpy as np
import pytest
import torch

from efficientlo_net_torch.backend import pose_graph as pg
from efficientlo_net_torch.backend import scan_factors as sfm
from efficientlo_net_torch.config import SensorConfig
from efficientlo_net_torch.ops import se3
from efficientlo_net_torch.ops.projection import project_to_range_image

SENSOR = SensorConfig(height=16, width=256, num_points=8192)
# Card against CPU: float32 solves and reductions in another summation order
# (atomics and cuBLAS on the card); Gauss-Newton and ICP contract rounding
# differences, so the poses agree to 1e-4 (0.1 mm, 0.1 mrad).  The chi2
# history to 1e-3 relative: after the first step (a cost of ~180 falls to
# ~1) each cost is a small difference of large terms.  The scan assembly's
# H entries reach ~1e4: relative 1e-5, absolute 1e-3.
CARD_POSE_ATOL = 1e-4
CARD_CHI2_RTOL = 1e-3
CARD_H_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, and the suite
    runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def exp(xi):
    return se3.se3_exp(torch.as_tensor(np.asarray(xi), dtype=torch.float32)).double().numpy()


# ---- se3 (tests/test_se3.py) ------------------------------------------------------

def random_twists(rng, n, scale=1.0):
    return torch.as_tensor((rng.standard_normal((n, 6)) * scale).astype(np.float32))


def test_exp_log_roundtrip():
    xi = random_twists(np.random.default_rng(0), 20, scale=0.8)
    np.testing.assert_allclose(se3.se3_log(se3.se3_exp(xi)).numpy(), xi.numpy(), atol=1e-4)


def test_exp_log_small_angles():
    xi = random_twists(np.random.default_rng(1), 10, scale=1e-6)
    np.testing.assert_allclose(se3.se3_log(se3.se3_exp(xi)).numpy(), xi.numpy(), atol=1e-8)


def test_exp_is_rigid():
    m = se3.se3_exp(random_twists(np.random.default_rng(2), 5)).numpy()
    for mm in m:
        r = mm[:3, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)
        np.testing.assert_allclose(mm[3], [0, 0, 0, 1], atol=0)


def test_inverse():
    m = se3.se3_exp(random_twists(np.random.default_rng(3), 5))
    np.testing.assert_allclose((m @ se3.se3_inv(m)).numpy(), np.tile(np.eye(4), (5, 1, 1)),
                               atol=1e-5)


def test_exp_matches_matrix_exponential():
    from scipy.linalg import expm

    xi = random_twists(np.random.default_rng(4), 5, scale=0.5).double().numpy()
    for x in xi:
        gen = np.zeros((4, 4))
        gen[:3, :3] = se3.hat(torch.as_tensor(x[3:])).numpy()
        gen[:3, 3] = x[:3]
        np.testing.assert_allclose(exp(x), expm(gen), atol=1e-5)


def test_jacobian_at_the_zero_twist_is_finite_and_the_identity():
    """Every factor Jacobian is taken at the zero twist: the Taylor branches
    must give finite forward-mode derivatives there, and d Log(Exp(d)) / dd
    is the identity."""
    zero = torch.zeros(6)
    jac = torch.func.jacfwd(lambda d: se3.se3_log(se3.se3_exp(d)))(zero)
    np.testing.assert_allclose(jac.numpy(), np.eye(6), atol=1e-6)
    for fn in (se3.se3_exp, lambda d: se3.so3_exp(d[3:]),
               lambda d: se3.so3_log(se3.se3_exp(d)[:3, :3])):
        assert torch.isfinite(torch.func.jacfwd(fn)(zero)).all()


# ---- pose graph (tests/test_pose_graph.py) ----------------------------------------

def make_chain(rng, n, drift=0.05):
    """GT poses along a curve + noisy odometry measurements."""
    gt = [np.eye(4)]
    for _ in range(1, n):
        xi = np.array([1.0, 0, 0, 0, 0, 0.1]) + rng.standard_normal(6) * 0.01
        gt.append(gt[-1] @ exp(xi))
    gt = np.stack(gt)
    meas = [np.linalg.inv(gt[i]) @ gt[i + 1] @ exp(rng.standard_normal(6) * drift)
            for i in range(n - 1)]
    return gt, np.arange(n - 1), np.arange(1, n), np.stack(meas)


def integrate(meas, n):
    poses = [np.eye(4)]
    for z in meas:
        poses.append(poses[-1] @ z)
    return torch.as_tensor(np.stack(poses)[:n], dtype=torch.float32)


def pose_rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a)[:, :3, 3] - b[:, :3, 3]) ** 2)))


def factors(*args, **kw):
    return pg.make_factors(*args, device="cpu", **kw)


def test_loop_closure_reduces_drift():
    rng = np.random.default_rng(0)
    n = 30
    gt, src, dst, meas = make_chain(rng, n, drift=0.03)
    z_loop = np.linalg.inv(gt[0]) @ gt[-1]
    src, dst = np.append(src, 0), np.append(dst, n - 1)
    meas = np.concatenate([meas, z_loop[None]])
    weight = np.ones(len(src), dtype=np.float32)
    weight[-1] = 100.0  # trust the loop closure
    init = integrate(meas[: n - 1], n)
    opt, history = pg.optimize(init, factors(src, dst, meas, weight, num_nodes=n),
                               pg.GaussNewtonConfig(iterations=15))
    assert pose_rmse(opt, gt) < pose_rmse(init, gt) * 0.7
    r = pg.factor_residual(opt[0], opt[-1], torch.as_tensor(z_loop, dtype=torch.float32))
    assert float(torch.linalg.vector_norm(r)) < 0.05
    assert history[-1] <= history[1]  # chi2 non-increasing overall


def test_perfect_measurements_zero_residual():
    gt, src, dst, meas = make_chain(np.random.default_rng(1), 10, drift=0.0)
    f = factors(src, dst, meas, num_nodes=10)
    opt, _ = pg.optimize(torch.as_tensor(gt, dtype=torch.float32), f,
                         pg.GaussNewtonConfig(iterations=3))
    assert float(pg.assemble_system(opt, f)[2]) < 1e-6


def test_padded_factors_are_ignored():
    gt, src, dst, meas = make_chain(np.random.default_rng(2), 8, drift=0.02)
    init = integrate(meas, 8)
    cfg = pg.GaussNewtonConfig(iterations=5)
    o1, _ = pg.optimize(init, factors(src, dst, meas, num_nodes=8), cfg)
    o2, _ = pg.optimize(init, factors(src, dst, meas, num_nodes=8, capacity=32), cfg)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-4)


def test_gm_rejects_false_closure():
    """A grossly wrong loop closure must not corrupt the solution under the
    redescending Geman-McClure kernel, and must visibly corrupt it when
    robustification is off (otherwise the test proves nothing)."""
    n = 30
    gt, src, dst, meas = make_chain(np.random.default_rng(5), n, drift=0.01)
    src, dst = np.append(src, 0), np.append(dst, n - 1)
    meas = np.concatenate([meas, np.eye(4)[None]])  # claims node 0 and n-1 coincide
    weight = np.ones(len(src), dtype=np.float32)
    weight[-1] = 100.0
    init = integrate(meas[: n - 1], n)
    f = factors(src, dst, meas, weight, num_nodes=n)
    naive, _ = pg.optimize(init, f, pg.GaussNewtonConfig(iterations=15))
    robust, _ = pg.optimize(init, f, pg.GaussNewtonConfig(iterations=15, robust_delta=1.0,
                                                          robust_kernel="gm"))
    err_naive, err_robust = pose_rmse(naive, gt), pose_rmse(robust, gt)
    err_init = pose_rmse(init, gt)
    assert err_naive > 3.0
    assert err_robust < err_naive * 0.2
    assert err_robust < err_init + 0.1


def test_huber_inactive_within_band():
    gt, src, dst, meas = make_chain(np.random.default_rng(6), 12, drift=0.01)
    f = factors(src, dst, meas, num_nodes=12)
    init = integrate(meas, 12)
    o1, _ = pg.optimize(init, f, pg.GaussNewtonConfig(iterations=5))
    o2, _ = pg.optimize(init, f, pg.GaussNewtonConfig(iterations=5, robust_delta=10.0))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5)


def test_marginalization_preserves_information():
    """Schur-eliminating a node gives the kept nodes the solution of the
    full system."""
    n = 6
    gt, src, dst, meas = make_chain(np.random.default_rng(4), n, drift=0.05)
    h, b, _ = pg.assemble_system(integrate(meas, n), factors(src, dst, meas, num_nodes=n))
    gauge = torch.zeros(6 * n)
    gauge[:6] = 1e6
    h = h + torch.diag(gauge) + 1e-6 * torch.eye(6 * n)
    full_delta = torch.linalg.solve(h, -b).numpy()
    keep, drop = np.arange(1, n), np.array([0])
    h_red, b_red = pg.marginalize(h, b, keep, drop)
    red_delta = torch.linalg.solve(h_red, -b_red).numpy()
    np.testing.assert_allclose(red_delta, full_delta[6:], atol=1e-3)


def test_robust_mask_limits_kernel_to_closures():
    """GM deweights only robust-masked factors (loop closures); chain factors
    with moderate residuals stay quadratic."""
    poses = torch.eye(4).expand(2, 4, 4).contiguous()
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [3.0, 0, 0]
    h, _, _ = pg._accumulate(poses, factors([0, 0], [1, 1], np.stack([bad, bad]), num_nodes=2,
                                            robust_mask=[0.0, 1.0]), robust=("gm", 1.0))
    h_ref, _, _ = pg._accumulate(poses, factors([0], [1], bad[None], num_nodes=2))
    ratio = h[6:, 6:].diagonal() / h_ref[6:, 6:].diagonal().clamp(min=1e-9)
    assert bool(((ratio > 1.0) & (ratio < 1.05)).all()), ratio


def test_solver_restores_the_callers_matmul_precision():
    previous = torch.get_float32_matmul_precision()
    gt, src, dst, meas = make_chain(np.random.default_rng(7), 5)
    try:
        torch.set_float32_matmul_precision("high")
        pg.optimize(integrate(meas, 5), factors(src, dst, meas, num_nodes=5),
                    pg.GaussNewtonConfig(iterations=1))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)


def test_make_factors_refuses_missing_cuda():
    """The solver's tensors default to the card and never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.make_factors([0], [1], np.eye(4)[None])


# ---- scan factors (tests/test_scan_factors.py) ------------------------------------

def boxy_scene(rng, n=8192):
    """Points on a few axis-aligned planes around the origin (walls+floor)."""
    m = n // 4
    xy = rng.uniform(-8, 8, size=(m, 2))
    yz = np.column_stack([rng.uniform(-8, 8, m), rng.uniform(-1.2, 1.2, m)])
    xz = np.column_stack([rng.uniform(-8, 8, m), rng.uniform(-1.2, 1.2, m)])
    return np.concatenate([
        np.column_stack([xy, np.full(m, -1.5)]),             # floor z = -1.5
        np.column_stack([np.full(m, 6.0), yz]),              # wall x = 6
        np.column_stack([xz[:, 0], np.full(m, -5.0), xz[:, 1]]),   # wall y = -5
        np.column_stack([xz[:, 0], np.full(m, 7.0), xz[:, 1]]),    # wall y = 7
    ]).astype(np.float32)


def project(points):
    img, _ = project_to_range_image(torch.as_tensor(points, dtype=torch.float32)[None], None,
                                    SENSOR.height, SENSOR.width, SENSOR, method="packed")
    return img[0]


def view(world, pose, radius=None):
    """``world`` seen from ``pose`` (world_T_sensor), optionally cropped."""
    local = (world - pose[:3, 3]) @ pose[:3, :3]
    if radius is not None:
        local = local[np.linalg.norm(local[:, :2], axis=1) < radius]
    return project(local)


def icp_pair():
    """Dense boxy scans from the origin and from t_true (i_T_j), and a
    perturbed initial guess."""
    world = boxy_scene(np.random.default_rng(3), n=16 * 8192)
    t_true = np.eye(4)
    c, s = np.cos(0.03), np.sin(0.03)
    t_true[:2, :2] = [[c, -s], [s, c]]
    t_true[:3, 3] = [0.4, 0.15, 0.02]
    pert = np.eye(4)
    c, s = np.cos(0.01), np.sin(0.01)
    pert[:2, :2] = [[c, -s], [s, c]]
    pert[:3, 3] = [0.08, -0.05, 0.02]
    return (view(world, np.eye(4), 12.0), view(world, t_true, 12.0), t_true,
            torch.as_tensor(t_true @ pert, dtype=torch.float32))


def test_normals_on_a_plane():
    m = 2048
    xy = np.random.default_rng(0).uniform(-8, 8, size=(m, 2))
    normals, ok = sfm.compute_normals(project(np.column_stack([xy, np.full(m, -1.5)])))
    n = normals[ok].numpy()
    assert int(ok.sum()) > 50
    np.testing.assert_allclose(np.abs(n[:, 2]), 1.0, atol=5e-2)
    assert np.all(n[:, 2] > 0)  # oriented toward the sensor


def test_association_identity():
    img = project(boxy_scene(np.random.default_rng(1)))
    normals, _ = sfm.compute_normals(img)
    corr = sfm.projective_association(img, img, normals, torch.eye(4), SENSOR, max_dist=0.5)
    assert float(corr.w.sum()) > 100
    r = torch.einsum("pc,pc->p", corr.n_i, corr.p_j - corr.q_i)
    assert float((r * corr.w).abs().max()) < 1e-5


def test_point_to_plane_recovers_pose():
    """Observe the boxy scene from two poses, start the second off by a
    perturbation: GN with scan factors recovers it."""
    scene = boxy_scene(np.random.default_rng(2))
    true_rel = np.eye(4)
    true_rel[:3, 3] = [0.4, -0.25, 0.08]
    true_rel[:3, :3] = exp([0, 0, 0, 0, 0, 0.04])[:3, :3]
    img_i, img_j = view(scene, np.eye(4)), view(scene, true_rel)
    opt = torch.eye(4).expand(2, 4, 4).contiguous()
    f = factors([0], [1], np.eye(4)[None], [1e-6], num_nodes=2)
    for _ in range(2):  # re-associate at the refined pose
        corr = sfm.correspondences_for_pair(img_i, img_j, opt[0], opt[1], SENSOR, max_dist=1.0)
        assert float(corr.w.sum()) > 100
        opt, hist = pg.optimize(opt, f, pg.GaussNewtonConfig(iterations=6),
                                scan_factors=sfm.make_scan_factors([(0, 1)], [corr]))
    rel = (se3.se3_inv(opt[0]) @ opt[1]).double().numpy()
    assert np.linalg.norm(rel[:3, 3] - true_rel[:3, 3]) < 0.05
    err_r = se3.so3_log(torch.as_tensor(rel[:3, :3] @ true_rel[:3, :3].T))
    assert float(torch.linalg.vector_norm(err_r)) < 0.01
    assert hist[-1] < hist[0]


def test_slam_scan_factors_reduce_drift():
    """Point-to-plane factors between consecutive keyframes pull a noisy
    odometry chain toward the true trajectory."""
    from efficientlo_net_torch.backend.slam import SlamConfig, SlidingWindowSLAM
    from efficientlo_net_torch.ops.quaternion import mat_to_quat

    scene = boxy_scene(np.random.default_rng(7))
    step = np.eye(4)
    step[0, 3] = 0.5
    gt = [np.eye(4)]
    for _ in range(7):
        gt.append(gt[-1] @ step)

    def run(use_scans):
        slam = SlidingWindowSLAM(
            SlamConfig(keyframe_distance=0.4, window_size=16, optimize_every=3,
                       use_scan_factors=use_scans, scan_max_dist=1.0,
                       gn=pg.GaussNewtonConfig(iterations=5), solver_device="cpu"),
            scan_sensor=SENSOR)
        slam.kf_payloads[0] = view(scene, gt[0]).numpy()
        noise = np.random.default_rng(9)
        for k in range(1, len(gt)):
            noisy = np.linalg.inv(gt[k - 1]) @ gt[k] @ exp(noise.standard_normal(6) * 0.02)
            q = mat_to_quat(torch.as_tensor(noisy[:3, :3], dtype=torch.float32)).numpy()
            slam.add_frame(q, noisy[:3, 3], payload=view(scene, gt[k]).numpy())
        slam.optimize_window()
        est = np.stack(slam.kf_poses)
        return np.mean([np.linalg.norm(est[i][:3, 3] - gt[i][:3, 3])
                        for i in range(min(len(est), len(gt)))])

    e_scan, e_odo = run(True), run(False)
    assert e_scan < e_odo * 0.7, (e_scan, e_odo)


def test_icp_refine_recovers_pose():
    """icp_refine polishes a perturbed guess to ~cm on a dense,
    well-constrained scene (walls in 3 directions + floor)."""
    img_i, img_j, t_true, t0 = icp_pair()
    t, inlier_frac, rms = sfm.icp_refine(img_i, img_j, t0, SENSOR, iters=10, max_dist=1.0,
                                         subsample=1)
    t = t.double().numpy()
    assert np.linalg.norm(t[:3, 3] - t_true[:3, 3]) < 0.02
    cos = np.clip((np.trace(t[:3, :3].T @ t_true[:3, :3]) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)) < 0.2
    assert float(inlier_frac) > 0.2
    assert float(rms) < 0.05


# ---- the card against the CPU ------------------------------------------------------

@pytest.mark.cuda
def test_optimize_on_the_card_keeps_float32_under_tf32(card):
    """A window solve with odometry, a closure, a prior and scan factors on
    the card, with the caller allowing TF32, agrees with the CPU; the
    caller's precision is restored."""
    rng = np.random.default_rng(11)
    n = 12
    gt, src, dst, meas = make_chain(rng, n, drift=0.02)
    src, dst = np.append(src, 0), np.append(dst, n - 1)
    meas = np.concatenate([meas, (np.linalg.inv(gt[0]) @ gt[-1])[None]])
    weight = np.r_[np.ones(n - 1), 50.0].astype(np.float32)
    init = integrate(meas[: n - 1], n)
    h = torch.as_tensor(np.diag(rng.uniform(1.0, 10.0, 12)), dtype=torch.float32)
    prior = pg.PriorFactor(node_ids=np.array([3, 4]), h=h, b=torch.zeros(12),
                           lin_poses=init[3:5].clone())
    scene = boxy_scene(np.random.default_rng(2))
    moved = exp([0.2, 0.1, 0.0, 0.0, 0.0, 0.02])
    corr = sfm.correspondences_for_pair(view(scene, np.eye(4)), view(scene, moved),
                                        torch.eye(4), torch.eye(4), SENSOR)
    sf = sfm.make_scan_factors([(5, 6)], [corr])
    cfg = pg.GaussNewtonConfig(iterations=6)
    cpu_poses, cpu_hist = pg.optimize(init, factors(src, dst, meas, weight, num_nodes=n), cfg,
                                      prior=prior, scan_factors=sf)
    previous = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        on = lambda x: x.to(card)
        card_prior = pg.PriorFactor(node_ids=prior.node_ids, h=on(prior.h), b=on(prior.b),
                                    lin_poses=on(prior.lin_poses))
        card_sf = sfm.ScanFactorSet(*(on(getattr(sf, k)) for k in ("src", "dst", "p_j", "q_i",
                                                                    "n_i", "w")))
        poses, hist = pg.optimize(on(init), pg.make_factors(src, dst, meas, weight, num_nodes=n,
                                                            device=card),
                                  cfg, prior=card_prior, scan_factors=card_sf)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)
    np.testing.assert_allclose(poses.cpu().numpy(), cpu_poses.numpy(), atol=CARD_POSE_ATOL)
    np.testing.assert_allclose(hist.cpu().numpy(), cpu_hist.numpy(), rtol=CARD_CHI2_RTOL)


@pytest.mark.cuda
def test_icp_refine_on_the_card_matches_the_cpu(card):
    img_i, img_j, _, t0 = icp_pair()
    cpu = sfm.icp_refine(img_i, img_j, t0, SENSOR, iters=10, max_dist=1.0, subsample=1)
    got = sfm.icp_refine(img_i.to(card), img_j.to(card), t0.to(card), SENSOR, iters=10,
                         max_dist=1.0, subsample=1)
    np.testing.assert_allclose(got[0].cpu().numpy(), cpu[0].numpy(), atol=CARD_POSE_ATOL)
    np.testing.assert_allclose([float(x) for x in got[1:]], [float(x) for x in cpu[1:]],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_scan_factor_assembly_on_the_card_matches_the_cpu(card):
    scene = boxy_scene(np.random.default_rng(3))
    img = project(scene)
    corr = sfm.correspondences_for_pair(img, img, torch.eye(4), torch.eye(4), SENSOR)
    sf = sfm.make_scan_factors([(0, 1)], [corr])
    poses = torch.stack([torch.eye(4), torch.as_tensor(
        exp([0.1, -0.05, 0.02, 0.01, 0.0, 0.03]), dtype=torch.float32)])
    h, b, chi2 = sfm.accumulate_scan_factors(poses, sf)
    card_sf = sfm.ScanFactorSet(*(getattr(sf, k).to(card) for k in ("src", "dst", "p_j", "q_i",
                                                                      "n_i", "w")))
    h_c, b_c, chi2_c = sfm.accumulate_scan_factors(poses.to(card), card_sf)
    np.testing.assert_allclose(h_c.cpu().numpy(), h.numpy(), **CARD_H_TOL)
    np.testing.assert_allclose(b_c.cpu().numpy(), b.numpy(), **CARD_H_TOL)
    np.testing.assert_allclose(float(chi2_c), float(chi2), rtol=1e-5)
