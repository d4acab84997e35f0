"""Per-sample SE(3) training augmentation (host-side numpy).

The port's own copy of ``random_se3`` and ``augmentation_batch`` from
``efficientlo_net_tpu/data/augmentation.py``: small random roll and pitch, a
larger yaw and a clipped Gaussian translation, applied to one randomly
chosen frame of each pair.  Numpy only, so a seed gives the same arrays in
both packages.
"""

from __future__ import annotations

import numpy as np


def random_se3(rng: np.random.Generator) -> np.ndarray:
    """One random perturbation as a (4, 4) float32 transform."""
    anglex = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    angley = np.clip(0.01 * rng.standard_normal(), -0.02, 0.02) * np.pi / 4.0
    anglez = np.clip(0.05 * rng.standard_normal(), -0.1, 0.1) * np.pi / 4.0

    cx, sx = np.cos(anglex), np.sin(anglex)
    cy, sy = np.cos(angley), np.sin(angley)
    cz, sz = np.cos(anglez), np.sin(anglez)

    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])

    t = np.array(
        [
            np.clip(0.5 * rng.standard_normal(), -1.0, 1.0),
            np.clip(0.1 * rng.standard_normal(), -0.2, 0.2),
            np.clip(0.05 * rng.standard_normal(), -0.15, 0.15),
        ]
    )
    T = np.eye(4)
    T[:3, :3] = rx @ ry @ rz
    T[:3, 3] = t
    return T.astype(np.float32)


def augmentation_batch(rng: np.random.Generator, batch_size: int, training: bool):
    """Returns (T_trans, T_trans_inv, aug_frame) arrays for a batch; the
    identity (and frame 1) when not training."""
    if not training:
        eye = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
        return eye, eye.copy(), np.ones((batch_size,), dtype=np.int32)
    T = np.stack([random_se3(rng) for _ in range(batch_size)])
    T_inv = np.linalg.inv(T).astype(np.float32)
    aug_frame = rng.integers(1, 3, size=batch_size).astype(np.int32)
    return T, T_inv, aug_frame
