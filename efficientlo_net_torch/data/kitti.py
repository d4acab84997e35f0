"""KITTI odometry dataset (host-side numpy).

The port's copy of ``efficientlo_net_tpu/data/kitti.py``:

* a global frame index over the 22 sequences, through the cumulative length
  table;
* each item pairs frame t with frame t-1 (frame 0 of a sequence pairs with
  itself);
* scans truncated or zero-padded to ``num_points``;
* the ground truth of a pair from ``kitti_T_diff/XX_diff.npy`` (or derived
  from the devkit's absolute poses ``XX.txt``), moved into the LiDAR frame
  with the sequence's calibration: ``T_gt = Tr^-1 @ T_diff @ Tr``;
* sequences 11-21, which have no ground truth, get the identity.

``pc1`` downstream is the later frame t, ``pc2`` frame t-1.  Scans are read
through ``data/native_io.py`` (the native reader, or its numpy twin), as in
the JAX package.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from . import native_io

SEQ_LENGTH_TABLE = [
    0, 4541, 5642, 10303, 11104, 11375, 14136, 15237, 16338, 20409, 22000,
    23201, 24122, 25183, 28464, 29095, 30996, 32727, 33218, 35019, 40000,
    40831, 43552,
]
SEQ_NAMES = [f"{i:02d}" for i in range(22)]


def read_calib_file(path: str) -> dict:
    """A KITTI ``calib.txt`` as ``{key: float64 array | str}``: each line is
    ``KEY: v0 ... vN``; a payload that is not all floats stays a string."""
    entries: dict = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, _, payload = line.partition(":")
            payload = payload.strip()
            try:
                entries[key] = np.array([float(tok) for tok in payload.split()])
            except ValueError:
                entries[key] = payload
    return entries


def t_diff_from_poses(pose_path: str) -> np.ndarray:
    """Per-pair relative transforms from the devkit's absolute camera poses
    (3x4 rows): ``T_diff[i] = P_{i-1}^-1 @ P_i``, ``T_diff[0] = I``, as
    (N, 12) rows."""
    rows = np.loadtxt(pose_path, dtype=np.float64).reshape(-1, 12)
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), (rows.shape[0], 1, 4))
    mats = np.concatenate([rows.reshape(-1, 3, 4), bottom], axis=1)
    rel = np.linalg.solve(mats[:-1], mats[1:])  # P_{i-1}^-1 @ P_i
    rel = np.concatenate([np.eye(4)[None], rel], axis=0)
    return rel[:, :3, :].reshape(-1, 12)


@lru_cache(maxsize=32)
def load_tr(calib_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(Tr, Tr^-1) as 4x4 float64, the LiDAR-to-camera calibration."""
    tr = read_calib_file(calib_path)["Tr"].reshape(3, 4)
    tr = np.vstack([tr, np.array([0.0, 0.0, 0.0, 1.0])])
    return tr, np.linalg.inv(tr)


class OdometryDataset:
    """Maps a global frame index to a (pc1, pc2, T_gt) training pair.
    ``cache_scans`` keeps every decoded scan in host memory (read-only, shared
    by the loader's threads)."""

    def __init__(self, root: str, num_points: int = 150000,
                 gt_pose_dir: Optional[str] = None, cache_scans: bool = False):
        self.root = root
        self.num_points = num_points
        self.gt_pose_dir = gt_pose_dir or os.path.join(os.path.dirname(root), "ground_truth_pose")
        self._t_diff_cache = {}
        self.cache_scans = cache_scans
        self._scan_cache: dict = {}

    def __len__(self) -> int:
        return SEQ_LENGTH_TABLE[-1]

    def locate(self, index: int) -> Tuple[int, int, int]:
        """global index -> (sequence, frame t, frame t-1)."""
        for si in range(1, len(SEQ_LENGTH_TABLE)):
            if index < SEQ_LENGTH_TABLE[si]:
                f2 = index - SEQ_LENGTH_TABLE[si - 1]
                return si - 1, f2, max(f2 - 1, 0)
        raise IndexError(index)

    def _t_diff(self, seq: int) -> Optional[np.ndarray]:
        if seq > 10:
            return None
        if seq not in self._t_diff_cache:
            path = os.path.join(self.gt_pose_dir, "kitti_T_diff", f"{SEQ_NAMES[seq]}_diff.npy")
            if os.path.exists(path):
                self._t_diff_cache[seq] = np.load(path)
            else:  # a stock KITTI download has only the absolute poses
                self._t_diff_cache[seq] = t_diff_from_poses(
                    os.path.join(self.gt_pose_dir, f"{SEQ_NAMES[seq]}.txt"))
        return self._t_diff_cache[seq]

    def read_scan(self, seq: int, frame: int) -> np.ndarray:
        if self.cache_scans:
            hit = self._scan_cache.get((seq, frame))
            if hit is not None:
                return hit
        path = os.path.join(self.root, SEQ_NAMES[seq], "velodyne", f"{frame:06d}.bin")
        scan = native_io.read_scan(path, self.num_points)
        if self.cache_scans:
            scan.setflags(write=False)
            self._scan_cache[(seq, frame)] = scan
        return scan

    def __getitem__(self, index: int):
        seq, f2, f1 = self.locate(index)
        tr, tr_inv = load_tr(os.path.join(self.root, SEQ_NAMES[seq], "calib.txt"))
        pc_t = self.read_scan(seq, f2)    # frame t   ("pc1" downstream)
        pc_tm1 = self.read_scan(seq, f1)  # frame t-1 ("pc2" downstream)
        diff = self._t_diff(seq)
        if diff is None:
            t_diff = np.eye(4)
        else:
            t_diff = np.vstack([diff[f2].reshape(3, 4), np.array([0.0, 0.0, 0.0, 1.0])])
        t_gt = (tr_inv @ t_diff @ tr).astype(np.float32)
        return pc_t, pc_tm1, t_gt
