"""Per-sample SE(3) training augmentation (host-side numpy).

The port's own copy of ``random_se3``, ``augmentation_batch`` and
``mirror_batch`` from ``efficientlo_net_tpu/data/augmentation.py``: small
random roll and pitch, a larger yaw and a clipped Gaussian translation,
applied to one randomly chosen frame of each pair, and a y-reflection of
about half the pairs.  Numpy only, so a seed gives the same arrays in both
packages.
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


_MIRROR4 = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def mirror_batch(batch: dict, rng: np.random.Generator, clouds: bool = True) -> dict:
    """Reflect about half the samples across the x-z plane (y -> -y) and
    conjugate their ground truth, ``T' = M T M``, which keeps each pair
    aligned.  Driving data turns one way more than the other; the reflection
    makes the yaw distribution the network sees symmetric.

    With ``clouds=False`` the clouds stay as they are and the per-sample
    sign comes back as ``batch["mirror_sign"]``: the host-projected loader
    folds the reflection into the fused native pass
    (``host_preprocess.augment_project_batch``).  The random draw is the
    same in both modes, so both pipelines see the same samples."""
    pc1, pc2, T_gt = batch["pc1"], batch["pc2"], batch["T_gt"]
    flip = rng.random(len(pc1)) < 0.5
    if not np.any(flip):
        return batch
    sign = np.where(flip, -1.0, 1.0).astype(pc1.dtype)
    T_gt = T_gt.copy()
    T_gt[flip] = _MIRROR4 @ T_gt[flip] @ _MIRROR4
    if not clouds:
        return dict(batch, T_gt=T_gt.astype(np.float32), mirror_sign=sign)
    pc1 = pc1.copy()
    pc2 = pc2.copy()
    pc1[..., 1] *= sign[:, None]
    pc2[..., 1] *= sign[:, None]
    return dict(batch, pc1=pc1, pc2=pc2, T_gt=T_gt.astype(np.float32))


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
