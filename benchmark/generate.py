"""Inputs of every traffic mix, made from the run's seed.

The benchmark's own copy of the synthetic-scan generators the program
ships (``random_scene``, ``synthetic_pair``'s motions, ``random_se3``,
``augmentation_batch``, and the drive world of random_scene blocks), so
that no change to the program can change the traffic.  Seeded with
``np.random.default_rng(seed)``; what is large (the training scenes, the
sequence's scans cut from the world) is made with torch on the device and
copied to the host, where the program's entries take it from.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def random_scene(rng: np.random.Generator, n: int, sensor: Dict) -> np.ndarray:
    """(n, 3) points over the sensor's vertical field of view, at planar
    ranges 2 m to the crop radius less 2 m."""
    az = rng.uniform(-np.pi, np.pi, n)
    beta = rng.uniform(np.deg2rad(sensor["vertical_fov_down_deg"]),
                       np.deg2rad(sensor["vertical_fov_up_deg"]), n)
    r = rng.uniform(2.0, sensor["max_planar_radius"] - 2.0, n)
    pts = np.stack([r * np.cos(beta) * np.cos(az), r * np.cos(beta) * np.sin(az),
                    r * np.sin(beta)], axis=-1)
    return pts.astype(np.float32)


def random_se3(rng: np.random.Generator) -> np.ndarray:
    """One training perturbation: small roll and pitch, a larger yaw, a
    clipped Gaussian translation."""
    ax = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    ay = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    az = np.clip(0.05 * rng.standard_normal(), -0.1, 0.1) * np.pi / 4.0
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = rx @ ry @ rz
    T[:3, 3] = [np.clip(0.5 * rng.standard_normal(), -1.0, 1.0),
                np.clip(0.1 * rng.standard_normal(), -0.2, 0.2),
                np.clip(0.05 * rng.standard_normal(), -0.15, 0.15)]
    return T.astype(np.float32)


def augmentation_batch(rng: np.random.Generator, batch_size: int):
    """(T_trans, T_trans_inv, aug_frame) of a training batch."""
    T = np.stack([random_se3(rng) for _ in range(batch_size)])
    return T, np.linalg.inv(T).astype(np.float32), \
        rng.integers(1, 3, size=batch_size).astype(np.int32)


def train_batches(seed: int, sensor: Dict, traffic: Dict, device) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` distinct host batches of ``traffic["batch_size"]``
    synthetic pairs with training augmentation.  The pairs are
    ``synthetic_pair``'s: the motions and the augmentation drawn with numpy,
    pair after pair; the scenes' points (``random_scene``'s distributions)
    drawn on ``device`` from a ``torch.Generator`` seeded alike, all pairs
    in one call, then copied to the host."""
    import torch

    rng = np.random.default_rng(seed)
    b, n = traffic["batch_size"], sensor["num_points"]
    count = traffic["pool"] * b
    motions = np.tile(np.eye(4, dtype=np.float32), (count, 1, 1))
    for m in motions:
        yaw = rng.uniform(-0.02, 0.02)
        m[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        m[:3, 3] = [rng.uniform(0.5, 1.5), rng.uniform(-0.1, 0.1), 0.0]
    augment = [augmentation_batch(rng, b) for _ in range(traffic["pool"])]

    gen = torch.Generator(device).manual_seed(seed)
    u = torch.rand((3, count, n), generator=gen, device=device, dtype=torch.float64)
    az = (2.0 * u[0] - 1.0) * np.pi
    lo, hi = np.deg2rad(sensor["vertical_fov_down_deg"]), np.deg2rad(sensor["vertical_fov_up_deg"])
    beta = lo + (hi - lo) * u[1]
    r = 2.0 + (sensor["max_planar_radius"] - 4.0) * u[2]
    scene = torch.stack([r * torch.cos(beta) * torch.cos(az), r * torch.cos(beta) * torch.sin(az),
                         r * torch.sin(beta)], dim=-1).to(torch.float32)
    del u, az, beta, r
    m = torch.as_tensor(motions, device=device)
    pc1 = torch.matmul(scene - m[:, None, :3, 3], m[:, :3, :3])  # R^T (S - t), as row vectors
    pc1, pc2 = pc1.cpu().numpy(), scene.cpu().numpy()
    out = []
    for i, (T, T_inv, aug) in enumerate(augment):
        rows = slice(i * b, (i + 1) * b)
        out.append({"pc1": pc1[rows], "pc2": pc2[rows], "T_gt": motions[rows],
                    "T_trans": T, "T_trans_inv": T_inv, "aug_frame": aug})
    return out


def drive(seed: int, sensor: Dict, traffic: Dict):
    """A drive through a static world: poses (n, 3) of (x, y, yaw), frames
    ``spacing_m`` apart with a yaw step of up to ``yaw_step_rad`` each, and
    the world (M, 3): a ``random_scene`` block of ``num_points`` points
    every ``block_spacing_m`` m along the path, shuffled, so that the first
    points of a scan sample the blocks in view uniformly."""
    rng = np.random.default_rng(seed)
    n = traffic["frames"]
    step = rng.uniform(*traffic["spacing_m"], n - 1)
    yaw = np.concatenate([[0.0], np.cumsum(rng.uniform(-1.0, 1.0, n - 1)
                                           * traffic["yaw_step_rad"])])
    x = np.concatenate([[0.0], np.cumsum(step * np.cos(yaw[1:]))])
    y = np.concatenate([[0.0], np.cumsum(step * np.sin(yaw[1:]))])
    arc = np.concatenate([[0.0], np.cumsum(step)])
    marks = np.arange(0.0, arc[-1] + traffic["block_spacing_m"], traffic["block_spacing_m"])
    centres = np.stack([np.interp(marks, arc, x), np.interp(marks, arc, y),
                        np.zeros_like(marks)], axis=-1).astype(np.float32)
    world = np.concatenate([random_scene(rng, sensor["num_points"], sensor) + c for c in centres])
    return np.stack([x, y, yaw], axis=-1), world[rng.permutation(len(world))]


def render(poses: np.ndarray, world: np.ndarray, sensor: Dict, device) -> np.ndarray:
    """(n, num_points, 3) float32 scans: the world in each pose's frame,
    the points within the crop radius in the plane, the first
    ``num_points`` of them, zero-padded."""
    import torch

    w = torch.as_tensor(world, device=device)
    out = torch.zeros((len(poses), sensor["num_points"], 3), dtype=torch.float32, device=device)
    for i, (x, y, yaw) in enumerate(poses):
        c, s = float(np.cos(yaw)), float(np.sin(yaw))
        dx, dy = w[:, 0] - float(x), w[:, 1] - float(y)
        local = torch.stack([c * dx + s * dy, -s * dx + c * dy, w[:, 2]], dim=-1)
        keep = local[torch.hypot(local[:, 0], local[:, 1]) <= sensor["max_planar_radius"]]
        m = min(len(keep), sensor["num_points"])
        out[i, :m] = keep[:m]
    return out.cpu().numpy()
