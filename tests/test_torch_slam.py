"""The port's drive world, loop-closure measurement and sliding-window SLAM
against the JAX package's, on the CPU.

* The drive world is numpy and scipy in both packages: the same seed gives
  equal trajectories (every kind), worlds, moving objects and rendered
  scans, here at a reduced render size (16 x 128).
* ``OdometryStream.measure_relative`` with and without a seed, tiny config,
  the same random weights with near-identity pose heads (random heads are
  chaotic: ROADMAP Queue 3): the (4, 4) results agree to 1e-4, as the
  stream's poses do (tests/test_torch_streaming.py).
* One short SLAM drive through both packages: a circle in a boxy scene
  with range-image payloads, scan factors, marginalization (window 8), a
  ground-truth closure function and ``global_optimize``; the same odometry
  and payloads go into both.  Keyframes, closures and the prior's nodes are
  equal; keyframe poses agree to 1e-4 (float32 solves with sums in another
  order, before and after the global pass), and the prior's information to
  1e-4 (the information of a unit-weight factor is 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.backend import pose_graph as TP
from efficientlo_net_torch.backend.slam import SlamConfig as TSlamConfig
from efficientlo_net_torch.backend.slam import SlidingWindowSLAM as TSLAM
from efficientlo_net_torch.config import SensorConfig as TSensor
from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data import synthetic as TD
from efficientlo_net_torch.evaluation.streaming import OdometryStream as TStream
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_tpu.backend import pose_graph as JP
from efficientlo_net_tpu.backend.slam import SlamConfig as JSlamConfig
from efficientlo_net_tpu.backend.slam import SlidingWindowSLAM as JSLAM
from efficientlo_net_tpu.config import SensorConfig as JSensor
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import synthetic as JD
from efficientlo_net_tpu.evaluation.streaming import OdometryStream as JStream
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops import quaternion as JQ
from efficientlo_net_tpu.ops import se3 as JSE3
from efficientlo_net_tpu.ops.projection import project_to_range_image
from tests.test_scan_factors import boxy_scene
from tests.torch_parity import near_identity_heads, randomize_batch_stats, to_torch_module

MEASURE_ATOL = 1e-4
SLAM_POSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the drive world ---------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [("wander", {}), ("loop", dict(speed=0.6, radius=4.0)),
                                     ("highway", dict(speed=2.2))])
def test_trajectory_matches_jax(kind, kw):
    a = TD.synthetic_trajectory(90, np.random.default_rng(5), kind=kind, **kw)
    b = JD.synthetic_trajectory(90, np.random.default_rng(5), kind=kind, **kw)
    assert a.shape == (90, 4, 4)
    np.testing.assert_array_equal(a, b)


def test_world_objects_and_scans_match_jax():
    def drive(mod):
        rng = np.random.default_rng(9)
        traj = mod.synthetic_trajectory(60, rng, kind="loop", speed=0.6, radius=4.0)
        world = mod.build_world(traj, rng)
        dynamics = mod.make_dynamic_objects(traj, rng, 4)
        renderer = mod.DriveRenderer(world, height=16, width=128, dynamics=dynamics)
        scans = [renderer.render(traj[i], 2048, rng, frame=i) for i in (0, 31)]
        scans.append(renderer.render(traj[45], 2048, rng))  # static world only
        return world, dynamics, scans

    (wt, dt, st), (wj, dj, sj) = drive(TD), drive(JD)
    np.testing.assert_array_equal(wt, wj)
    assert len(dt) == len(dj) == 4
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a["pts"], b["pts"])
        np.testing.assert_array_equal(a["poses"], b["poses"])
    for a, b in zip(st, sj):
        assert a.dtype == np.float32 and np.any(a != 0)
        np.testing.assert_array_equal(a, b)


# ---- measure_relative ------------------------------------------------------------

@pytest.fixture(scope="module")
def streams():
    cfg = j_tiny()
    pc1, pc2, _ = JD.synthetic_pair(np.random.default_rng(3), cfg.sensor)
    h, w = cfg.sensor.height, cfg.sensor.width
    imgs = [np.asarray(project_to_range_image(jnp.asarray(p[None]), None, h, w, cfg.sensor)[0][0])
            for p in (pc1, pc2)]
    model = JNet(cfg)
    p0 = jnp.asarray(imgs[0][None])
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p0, p0, training=False)
    variables = randomize_batch_stats(variables)
    variables = {"params": near_identity_heads(variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    j_stream = JStream(model, variables, cfg)
    t_stream = TStream(to_torch_module(TNet(t_tiny()), variables), t_tiny(), device="cpu")
    return j_stream, t_stream, imgs


@pytest.mark.parametrize("seeded", [True, False])
def test_measure_relative_matches_jax(streams, seeded):
    j_stream, t_stream, (img_i, img_j) = streams
    seed = None
    if seeded:
        seed = np.asarray(JSE3.se3_exp(jnp.asarray([0.6, 0.1, 0.0, 0.0, 0.0, 0.05])), np.float64)
    want = j_stream.measure_relative(img_i, img_j, t_init=seed, refinements=2)
    got = t_stream.measure_relative(img_i, img_j, t_init=seed, refinements=2)
    assert got.shape == (4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=MEASURE_ATOL)
    # (1, H, W, 3) tensors give the same as (H, W, 3) numpy arrays
    again = t_stream.measure_relative(torch.as_tensor(img_i)[None], torch.as_tensor(img_j)[None],
                                      t_init=seed, refinements=2)
    np.testing.assert_array_equal(again, got)


# ---- one SLAM drive through both packages -----------------------------------------

def test_slam_drive_matches_jax():
    sensor = dict(height=16, width=256, num_points=8192)
    j_sensor, t_sensor = JSensor(**sensor), TSensor(**sensor)
    world = boxy_scene(np.random.default_rng(3), n=16 * 8192)
    # a circle of radius 1.5 m in 24 steps, back to the start
    n = 25
    ang = np.arange(n) * 2 * np.pi / 24
    gt = []
    for a in ang:
        p = np.eye(4)
        p[:3, :3] = np.asarray(JSE3.so3_exp(jnp.asarray([0.0, 0.0, a + np.pi / 2], jnp.float32)))
        p[:3, 3] = [1.5 * np.cos(a), 1.0 + 1.5 * np.sin(a), 0.0]
        gt.append(p)

    def image(pose):
        local = (world - pose[:3, 3]) @ pose[:3, :3]
        local = local[np.linalg.norm(local[:, :2], axis=1) < 12.0].astype(np.float32)
        img, _ = project_to_range_image(jnp.asarray(local[None]), None, 16, 256, j_sensor)
        return np.asarray(img[0])

    payloads = [image(p) for p in gt]
    noise = np.random.default_rng(4)
    odometry = []
    for k in range(1, n):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        xi = (noise.standard_normal(6) * 0.01).astype(np.float32)
        rel = rel @ np.asarray(JSE3.se3_exp(jnp.asarray(xi)), np.float64)
        odometry.append((np.asarray(JQ.mat_to_quat(jnp.asarray(rel[:3, :3], jnp.float32))),
                         rel[:3, 3].copy()))

    def closure_fn(pj, pi):  # payloads here are frame indices into gt
        return np.linalg.inv(gt[pj]) @ gt[pi]

    # optimizations at full windows only, so that the JAX package compiles
    # few shapes: its eager marginalization compiles every op per shape
    common = dict(keyframe_distance=2.0, window_size=8, optimize_every=7, closure_radius=0.35,
                  closure_min_gap=12, closure_search_all=True, use_scan_factors=True)

    def run(slam_cls, cfg):
        images = {}
        slam = slam_cls(cfg, closure_fn=lambda pj, pi: closure_fn(images[id(pj)], images[id(pi)]),
                        scan_sensor=j_sensor if slam_cls is JSLAM else t_sensor)
        images[id(payloads[0])] = 0
        slam.set_initial_payload(payloads[0])
        for k, (q, t) in enumerate(odometry, start=1):
            images[id(payloads[k])] = k
            slam.add_frame(q, t, payload=payloads[k])
        slam.optimize_window()
        window = np.stack(slam.kf_poses)
        slam.global_optimize(iterations=10)
        return slam, window

    j_slam, j_window = run(JSLAM, JSlamConfig(solver_device="cpu",
                                             gn=JP.GaussNewtonConfig(iterations=5), **common))
    t_slam, t_window = run(TSLAM, TSlamConfig(solver_device="cpu",
                                             gn=TP.GaussNewtonConfig(iterations=5), **common))
    assert t_slam.kf_frame_ids == j_slam.kf_frame_ids and len(t_slam.kf_poses) == n
    assert t_slam.closed_pairs == j_slam.closed_pairs and len(t_slam.closed_pairs) >= 1
    np.testing.assert_array_equal(t_slam._prior.node_ids, j_slam._prior.node_ids)
    assert t_slam._frozen_ids == j_slam._frozen_ids and len(t_slam._frozen_ids) > 0
    np.testing.assert_allclose(t_window, j_window, atol=SLAM_POSE_ATOL)
    np.testing.assert_allclose(np.stack(t_slam.kf_poses), np.stack(j_slam.kf_poses),
                               atol=SLAM_POSE_ATOL)
    # the prior in the units of a unit-weight factor's information
    np.testing.assert_allclose(t_slam._prior.h.numpy(), np.asarray(j_slam._prior.h), atol=1e-4)
