"""KITTI odometry relative pose error (RPE) and ATE (numpy).

The port's copy of ``efficientlo_net_tpu/evaluation/kitti_metrics.py``, the
KITTI devkit's protocol: from every 10th frame and for each segment length
of 100-800 m along the ground-truth path, the pose error
``E = (P_res^-1 P_res')^-1 (P_gt^-1 P_gt')``, as translation error per metre
and rotation angle per metre.

  t_rel (%)        = 100 * mean(t_err / length)
  r_rel (deg/100m) = 100 * mean(r_err / length) * 180 / pi
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
STEP_SIZE = 10  # every second at KITTI's 10 Hz

# camera <-> LiDAR axis permutation, for trajectories written in LiDAR axes
R_C2L = np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)


def to_camera_coord(pose: np.ndarray) -> np.ndarray:
    return np.linalg.inv(R_C2L) @ pose @ R_C2L


def poses_from_rows(rows: np.ndarray, to_camera: bool = False) -> List[np.ndarray]:
    """(N, 12) KITTI rows -> list of 4x4 poses."""
    poses = []
    for r in rows:
        p = np.eye(4)
        p[:3, :] = r.reshape(3, 4)
        poses.append(to_camera_coord(p) if to_camera else p)
    return poses


def load_poses(path: str, to_camera: bool = False) -> List[np.ndarray]:
    """Rows of 12 values, or of an index and 12 values."""
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None]
    if raw.shape[1] == 13:
        raw = raw[:, 1:]
    return poses_from_rows(raw, to_camera)


def trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    """Cumulative path length at each pose."""
    dist = [0.0]
    for i in range(len(poses) - 1):
        delta = poses[i + 1][:3, 3] - poses[i][:3, 3]
        dist.append(dist[-1] + float(np.linalg.norm(delta)))
    return np.asarray(dist)


def rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(max(min(d, 1.0), -1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def _last_frame_for_segment(dist: np.ndarray, first: int, length: float) -> int:
    for i in range(first, len(dist)):
        if dist[i] > dist[first] + length:
            return i
    return -1


@dataclasses.dataclass
class SegmentError:
    first_frame: int
    r_err: float  # rad per metre
    t_err: float  # fraction of the length
    length: float
    speed: float


def sequence_errors(poses_gt: Sequence[np.ndarray],
                    poses_result: Sequence[np.ndarray]) -> List[SegmentError]:
    errors = []
    dist = trajectory_distances(poses_gt)
    n = min(len(poses_gt), len(poses_result))
    for first in range(0, len(poses_gt), STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _last_frame_for_segment(dist, first, length)
            if last == -1 or last >= n or first >= n:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_res = np.linalg.inv(poses_result[first]) @ poses_result[last]
            err = np.linalg.inv(delta_res) @ delta_gt
            num_frames = last - first + 1.0
            errors.append(SegmentError(
                first_frame=first,
                r_err=rotation_error(err) / length,
                t_err=translation_error(err) / length,
                length=length,
                speed=length / (0.1 * num_frames),
            ))
    return errors


def overall_error(errors: Sequence[SegmentError]):
    """(mean t_err, mean r_err) in the devkit's units (fraction, rad/m)."""
    if not errors:
        return float("nan"), float("nan")
    return float(np.mean([e.t_err for e in errors])), float(np.mean([e.r_err for e in errors]))


def _mean_errors(sel: Sequence[SegmentError]) -> Optional[tuple]:
    if not sel:
        return None
    return float(np.mean([e.t_err for e in sel])), float(np.mean([e.r_err for e in sel]))


def segment_error_table(errors: Sequence[SegmentError]) -> Dict[int, Optional[tuple]]:
    return {length: _mean_errors([e for e in errors if e.length == length])
            for length in SEGMENT_LENGTHS}


def speed_error_table(errors: Sequence[SegmentError]) -> Dict[int, Optional[tuple]]:
    return {s: _mean_errors([e for e in errors if abs(e.speed - s) < 2.0])
            for s in range(2, 25, 2)}


@dataclasses.dataclass
class SequenceResult:
    seq: str
    t_rel: float  # percent
    r_rel: float  # deg per 100 m
    errors: List[SegmentError]
    ate_m: float = float("nan")  # RMS ATE, unaligned

    def summary(self) -> str:
        return f"seq{self.seq} Average_t_error {self.t_rel:.2f} Average_r_error {self.r_rel:.2f}"


def save_sequence_errors(errors: Sequence[SegmentError], path: str) -> None:
    """One line per segment: ``first_frame r_err t_err length speed``, the
    devkit's ``saveSequenceErrors`` rows."""
    with open(path, "w") as f:
        for e in errors:
            f.write(f"{e.first_frame} {e.r_err} {e.t_err} {e.length} {e.speed}\n")


def absolute_trajectory_error(poses_gt: Sequence[np.ndarray], poses_result: Sequence[np.ndarray],
                              align: bool = True) -> float:
    """RMS absolute trajectory error (m) of the positions; ``align`` first
    fits a rigid (SE(3), no scale) Horn/Umeyama alignment."""
    n = min(len(poses_gt), len(poses_result))
    gt = np.stack([np.asarray(p)[:3, 3] for p in poses_gt[:n]])
    est = np.stack([np.asarray(p)[:3, 3] for p in poses_result[:n]])
    if align and n >= 3:
        mu_g, mu_e = gt.mean(axis=0), est.mean(axis=0)
        cov = (est - mu_e).T @ (gt - mu_g) / n
        u, _, vt = np.linalg.svd(cov)
        s = np.eye(3)
        s[2, 2] = np.sign(np.linalg.det(u @ vt))
        rot = vt.T @ s @ u.T
        est = (est - mu_e) @ rot.T + mu_g
    return float(np.sqrt(np.mean(np.sum((gt - est) ** 2, axis=-1))))


def evaluate_sequence(poses_gt: Sequence[np.ndarray], poses_result: Sequence[np.ndarray],
                      seq: str = "??") -> SequenceResult:
    errs = sequence_errors(poses_gt, poses_result)
    t, r = overall_error(errs)
    return SequenceResult(seq=seq, t_rel=t * 100.0, r_rel=r / np.pi * 180.0 * 100.0, errors=errs,
                          ate_m=absolute_trajectory_error(poses_gt, poses_result, align=False))
