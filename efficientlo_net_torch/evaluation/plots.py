"""Trajectory and error plots (matplotlib, Agg backend).

The port's copy of ``efficientlo_net_tpu/evaluation/plots.py``: per sequence
the path in three planes, x/y/z and roll/pitch/yaw over time, and the errors
against segment length and speed, written as ``<seq>_path.png``,
``<seq>_xyz.png``, ``<seq>_rpy.png`` and ``<seq>_errors.png``.  matplotlib is
imported at the first plot, so the module imports where it is missing.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def euler_zyx_from_matrix(m: np.ndarray):
    """Rotation matrix -> (roll, pitch, yaw) zyx euler angles."""
    sy = math.sqrt(m[0, 0] ** 2 + m[1, 0] ** 2)
    if sy > 1e-6:
        roll = math.atan2(m[2, 1], m[2, 2])
        pitch = math.atan2(-m[2, 0], sy)
        yaw = math.atan2(m[1, 0], m[0, 0])
    else:
        roll = math.atan2(-m[1, 2], m[1, 1])
        pitch = math.atan2(-m[2, 0], sy)
        yaw = 0.0
    return roll, pitch, yaw


def _positions(poses: Sequence[np.ndarray]) -> np.ndarray:
    return np.stack([p[:3, 3] for p in poses])


def plot_path_2d(seq: str, poses_gt, poses_pred, out_dir: str) -> str:
    """XZ / XY / YZ plane paths."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    pred = _positions(poses_pred)
    gt = _positions(poses_gt) if poses_gt else None
    planes = [(0, 2, "x (m)", "z (m)"), (0, 1, "x (m)", "y (m)"), (1, 2, "y (m)", "z (m)")]
    for ax, (i, j, xl, yl) in zip(axes, planes):
        if gt is not None:
            ax.plot(gt[:, i], gt[:, j], "r-", label="Ground Truth")
        ax.plot(pred[:, i], pred[:, j], "b-", label="Ours")
        ax.plot([0], [0], "ko", label="Start")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.legend(loc="upper right")
        ax.set_aspect("equal", adjustable="datalim")
    path = os.path.join(out_dir, f"{seq}_path.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_xyz_over_time(seq: str, poses_gt, poses_pred, out_dir: str) -> str:
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(16, 8), sharex=True)
    pred = _positions(poses_pred)
    gt = _positions(poses_gt) if poses_gt else None
    for i, lab in enumerate(["x (m)", "y (m)", "z (m)"]):
        axes[i].plot(pred[:, i], "b-", label="Ours")
        if gt is not None:
            axes[i].plot(gt[:, i], "r-", label="GT")
        axes[i].set_ylabel(lab)
        axes[i].legend(loc="upper right")
    axes[-1].set_xlabel("frame")
    path = os.path.join(out_dir, f"{seq}_xyz.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_rpy_over_time(seq: str, poses_gt, poses_pred, out_dir: str) -> str:
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(16, 8), sharex=True)
    pred = np.rad2deg([euler_zyx_from_matrix(p[:3, :3]) for p in poses_pred])
    gt = (
        np.rad2deg([euler_zyx_from_matrix(p[:3, :3]) for p in poses_gt])
        if poses_gt
        else None
    )
    for i, lab in enumerate(["roll (deg)", "pitch (deg)", "yaw (deg)"]):
        axes[i].plot(pred[:, i], "b-", label="Ours")
        if gt is not None:
            axes[i].plot(gt[:, i], "r-", label="GT")
        axes[i].set_ylabel(lab)
        axes[i].legend(loc="upper right")
    axes[-1].set_xlabel("frame")
    path = os.path.join(out_dir, f"{seq}_rpy.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_error_tables(seq: str, segment_table: Dict, speed_table: Dict, out_dir: str) -> str:
    """Error vs segment length and vs speed."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(14, 9))

    xs = [k for k, v in segment_table.items() if v is not None]
    t = [segment_table[k][0] * 100 for k in xs]
    r = [segment_table[k][1] / np.pi * 180 for k in xs]
    axes[0, 0].plot(xs, t, "ks-")
    axes[0, 0].set_xlabel("Path Length (m)")
    axes[0, 0].set_ylabel("Translation Error (%)")
    axes[0, 1].plot(xs, r, "ks-")
    axes[0, 1].set_xlabel("Path Length (m)")
    axes[0, 1].set_ylabel("Rotation Error (deg/m)")

    xs = [k * 3.6 for k, v in speed_table.items() if v is not None]
    keys = [k for k, v in speed_table.items() if v is not None]
    t = [speed_table[k][0] * 100 for k in keys]
    r = [speed_table[k][1] / np.pi * 180 for k in keys]
    axes[1, 0].plot(xs, t, "ks-")
    axes[1, 0].set_xlabel("Speed (km/h)")
    axes[1, 0].set_ylabel("Translation Error (%)")
    axes[1, 1].plot(xs, r, "ks-")
    axes[1, 1].set_xlabel("Speed (km/h)")
    axes[1, 1].set_ylabel("Rotation Error (deg/m)")

    path = os.path.join(out_dir, f"{seq}_errors.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def write_all_plots(
    seq: str,
    poses_gt: Optional[Sequence[np.ndarray]],
    poses_pred: Sequence[np.ndarray],
    errors,
    out_dir: str,
) -> None:
    from .kitti_metrics import segment_error_table, speed_error_table

    os.makedirs(out_dir, exist_ok=True)
    plot_path_2d(seq, poses_gt, poses_pred, out_dir)
    plot_xyz_over_time(seq, poses_gt, poses_pred, out_dir)
    plot_rpy_over_time(seq, poses_gt, poses_pred, out_dir)
    if errors:
        plot_error_tables(
            seq, segment_error_table(errors), speed_error_table(errors), out_dir
        )
