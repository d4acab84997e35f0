"""Synthetic LiDAR scans for tests and the on-card smoke run.

The port's own copy of ``random_scene`` and ``synthetic_pair`` from
``efficientlo_net_tpu/data/synthetic.py``: random structured point sets
inside the sensor FOV and the planar crop, and pairs related by a known
rigid motion.  Numpy only, so a seed gives the same scans in both packages.
"""

from __future__ import annotations

import numpy as np

from ..config import SensorConfig


def random_scene(rng: np.random.Generator, n: int, sensor: SensorConfig) -> np.ndarray:
    """(n, 3) scan covering the sensor FOV, inside the planar crop radius."""
    az = rng.uniform(-np.pi, np.pi, n)
    beta = rng.uniform(
        np.deg2rad(sensor.vertical_fov_down_deg),
        np.deg2rad(sensor.vertical_fov_up_deg),
        n,
    )
    r = rng.uniform(2.0, sensor.max_planar_radius - 2.0, n)
    pts = np.stack(
        [
            r * np.cos(beta) * np.cos(az),
            r * np.cos(beta) * np.sin(az),
            r * np.sin(beta),
        ],
        axis=-1,
    )
    return pts.astype(np.float32)


def synthetic_pair(rng: np.random.Generator, sensor: SensorConfig, motion: np.ndarray = None):
    """Returns (pc1, pc2, T_gt): scene S is pc2 and pc1 = R^T (S - t), so
    transforming pc1 by T_gt aligns it with pc2."""
    if motion is None:
        motion = np.eye(4, dtype=np.float32)
        yaw = rng.uniform(-0.02, 0.02)
        motion[:3, :3] = np.array(
            [
                [np.cos(yaw), -np.sin(yaw), 0],
                [np.sin(yaw), np.cos(yaw), 0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
        motion[:3, 3] = [rng.uniform(0.5, 1.5), rng.uniform(-0.1, 0.1), 0.0]

    scene = random_scene(rng, sensor.num_points, sensor)
    pc2 = scene
    r, t = motion[:3, :3], motion[:3, 3]
    pc1 = (scene - t) @ r  # == R^T (S - t)
    return pc1.astype(np.float32), pc2.astype(np.float32), motion.astype(np.float32)
