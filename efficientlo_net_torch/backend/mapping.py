"""Global map assembly from SLAM keyframes.

The port's own copy of ``efficientlo_net_tpu/backend/mapping.py`` (numpy
only): fuse the keyframes' range-image payloads ((H, W, 3) pixel xyz in the
keyframe's lidar frame, the same payloads the scan factors and loop-closure
re-measurement consume) into one world-frame point map using the optimized
keyframe poses.  Voxel downsampling keeps the map bounded for long drives;
PLY export makes it viewable in any standard tool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def range_image_points(img: np.ndarray) -> np.ndarray:
    """Valid pixels of an (H, W, 3) range image as an (M, 3) array
    (empty pixels are exactly (0,0,0), the framework-wide invalid code)."""
    img = np.asarray(img)
    pts = img.reshape(-1, 3)
    return pts[np.any(pts != 0.0, axis=-1)]


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one point per ``voxel``-sized cell (the centroid of its cell's
    members), deterministic in the input order."""
    if len(points) == 0 or voxel <= 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    # lexicographic cell id; bounded coordinates keep this collision-free
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    keys_s, pts_s = keys[order], points[order]
    new_cell = np.any(np.diff(keys_s, axis=0) != 0, axis=-1)
    starts = np.flatnonzero(np.concatenate([[True], new_cell]))
    ends = np.concatenate([starts[1:], [len(pts_s)]])
    sums = np.add.reduceat(pts_s, starts, axis=0)
    return sums / (ends - starts)[:, None]


def assemble_map(
    poses: Sequence[np.ndarray],
    payloads: Sequence[Optional[np.ndarray]],
    voxel: float = 0.2,
    max_range: Optional[float] = None,
) -> np.ndarray:
    """World-frame point map from keyframe (pose, range-image) pairs.

    ``poses`` are world_T_kf 4x4; keyframes with ``None`` payloads are
    skipped.  ``max_range`` optionally drops points farther than that from
    their keyframe (range-image edges are the noisiest).
    """
    parts = []
    for pose, payload in zip(poses, payloads):
        if payload is None:
            continue
        pts = range_image_points(payload).astype(np.float64)
        if max_range is not None and len(pts):
            pts = pts[np.linalg.norm(pts, axis=-1) <= max_range]
        if not len(pts):
            continue
        pose = np.asarray(pose, dtype=np.float64)
        parts.append(pts @ pose[:3, :3].T + pose[:3, 3])
    if not parts:
        return np.zeros((0, 3))
    return voxel_downsample(np.concatenate(parts), voxel)


def save_map_ply(path: str, points: np.ndarray) -> None:
    """ASCII PLY dump (viewable in CloudCompare / MeshLab / Open3D)."""
    points = np.asarray(points, dtype=np.float32)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        np.savetxt(f, points, fmt="%.4f")
