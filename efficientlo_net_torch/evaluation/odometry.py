"""Trajectory integration from per-pair relative poses (numpy).

The port's copy of ``efficientlo_net_tpu/evaluation/odometry.py``: each
pair's (q, t) becomes a 4x4 transform, is moved into the camera frame with
the sequence's calibration (``Tr @ T @ Tr^-1``) and right-multiplied onto the
running pose; rows are KITTI's 12 values (3x4, row-major).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """Rotation matrix of a quaternion (w, x, y, z) that need not be unit;
    the identity below norm 1e-8."""
    w, x, y, z = q
    nq = w * w + x * x + y * y + z * z
    if nq < 1e-8:
        return np.eye(3)
    s = 2.0 / nq
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    return np.array(
        [
            [1.0 - (yY + zZ), xY - wZ, xZ + wY],
            [xY + wZ, 1.0 - (xX + zZ), yZ - wX],
            [xZ - wY, yZ + wX, 1.0 - (xX + yY)],
        ]
    )


def integrate_sequence(quats: np.ndarray, trans: np.ndarray,
                       tr: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 4) quaternions and (N, 3) translations of frame i relative to
    i-1, in the LiDAR frame, to (N, 12) absolute camera-frame KITTI rows; the
    first row is the first pair's transform.  ``tr`` is the 4x4 LiDAR-to-
    camera calibration (identity if None)."""
    n = quats.shape[0]
    if tr is None:
        tr = np.eye(4)
    tr_inv = np.linalg.inv(tr)
    out = np.zeros((n, 12))
    t_final = np.eye(4)
    for i in range(n):
        tt = np.eye(4)
        tt[:3, :3] = quat_to_mat_np(np.asarray(quats[i], dtype=np.float64))
        tt[:3, 3] = trans[i]
        tt = tr @ tt @ tr_inv
        t_final = t_final @ tt
        out[i] = t_final[:3, :].reshape(12)
    return out


def save_kitti_trajectory(path: str, poses_12: np.ndarray) -> None:
    np.savetxt(path, poses_12, fmt="%.08f")


def load_kitti_trajectory(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1, 12)
