"""Select cases, comparisons and a KITTI-layout tree shared by the port's
tests (tests/test_torch_*.py).

Numpy only, with no JAX import, so the card tests (tests/test_torch_kernels.py,
tests/test_torch_trainer.py) can use it on a machine that has no JAX.
"""

import os

import numpy as np

# name -> (kernel_size, k, distance, center_stride, source_stride, grid shapes)
SELECT_CASES = {
    "plain": ((3, 5), 4, 2.0, (1, 1), (1, 1), dict(b=2, h1=8, w1=16)),
    "unbounded": ((3, 5), 6, 1000.0, (1, 1), (1, 1), dict(b=2, h1=8, w1=16)),
    "centre_stride": ((3, 5), 4, 2.0, (2, 4), (1, 1), dict(b=2, h1=8, w1=16)),
    "uneven_centre_stride": ((3, 3), 4, 100.0, (2, 3), (1, 1), dict(b=1, h1=7, w1=10)),
    "source_stride": ((3, 5), 3, 6.0, (1, 1), (2, 2), dict(b=2, h1=8, w1=16, h2=4, w2=8)),
    "uneven_source_stride": ((3, 5), 4, 6.0, (1, 1), (1, 2), dict(b=1, h1=5, w1=9, h2=5, w2=5)),
    "window_wider_than_w": ((3, 7), 3, 1000.0, (1, 1), (1, 1),
                            dict(b=1, h1=4, w1=4, h2=4, w2=4)),
    # windows of more than 32 slots, which the CUDA kernels scan in rounds of
    # 32, at the geometries of the network's call sites, on small grids
    "wide_5x35_k32_unbounded": ((5, 35), 32, 1000.0, (1, 1), (1, 1),
                                dict(b=1, h1=6, w1=40, h2=6, w2=40)),
    "wide_11x41_k6": ((11, 41), 6, 4.0, (1, 1), (1, 1),
                      dict(b=1, h1=12, w1=44, h2=12, w2=44)),
    "wide_9x15_k32_centre_stride": ((9, 15), 32, 3.0, (4, 8), (1, 1), dict(b=2, h1=16, w1=32)),
    "wide_7x15_k8_source_stride": ((7, 15), 8, 6.0, (1, 1), (2, 2),
                                   dict(b=2, h1=8, w1=16, h2=4, w2=8)),
    "wide_5x9_window_wider_than_w": ((5, 9), 8, 1000.0, (1, 1), (1, 1),
                                     dict(b=1, h1=5, w1=6, h2=5, w2=6)),
}
# (mode, with a permuted scan order)
MODES = [("first_k", False), ("first_k", True), ("knn", False)]
# select_and_group: name -> (kernel_size, k, distance, center_stride, mode,
# feature channels, grid shapes)
GROUP_CASES = {
    "one_channel": ((3, 5), 4, 2.0, (2, 4), "first_k", 1, dict(b=2, h1=8, w1=16)),
    "c64_k32": ((7, 11), 32, 3.0, (2, 2), "first_k", 64, dict(b=1, h1=8, w1=16)),
    "knn_5x9_k16": ((5, 9), 16, 1000.0, (1, 2), "knn", 8, dict(b=2, h1=6, w1=20)),
}


def make_grids(rng, b=2, h1=8, w1=16, h2=8, w2=16, invalid_frac=0.3):
    """Two random (B, H, W, 3) grids with a share of invalid (zero) pixels."""
    g1 = rng.standard_normal((b, h1, w1, 3)).astype(np.float32) * 2.0
    g2 = rng.standard_normal((b, h2, w2, 3)).astype(np.float32) * 2.0
    for g in (g1, g2):
        g[rng.random(g.shape[:-1]) < invalid_frac] = 0.0
    return g1, g2


def select_inputs(case, with_perm, seed=0):
    """(g1, g2, kernel_size, k, distance, center_stride, source_stride, perm)
    of one case; a centre-strided case searches its own grid, as DownConv does."""
    ks, k, dist, cs, ss, shapes = SELECT_CASES[case]
    rng = np.random.default_rng(seed)
    g1, g2 = make_grids(rng, **shapes)
    if cs != (1, 1):
        g2 = g1
    perm = rng.permutation(ks[0] * ks[1]) if with_perm else None
    return g1, g2, ks, k, dist, cs, ss, perm


def group_inputs(case, seed=0):
    """(xyz, feats, kernel_size, k, distance, center_stride, mode) of one
    GROUP_CASES case."""
    ks, k, dist, cs, mode, c, shapes = GROUP_CASES[case]
    rng = np.random.default_rng(seed)
    xyz, _ = make_grids(rng, **shapes)
    feats = rng.standard_normal(xyz.shape[:3] + (c,)).astype(np.float32)
    return xyz, feats, ks, k, dist, cs, mode


def sets_equal(idx_a, mask_a, idx_b, mask_b):
    """Per centre, the selected index sets and the mask counts must match;
    the order within the K slots is free."""
    idx_a, mask_a = np.asarray(idx_a), np.asarray(mask_a)[..., 0]
    idx_b, mask_b = np.asarray(idx_b), np.asarray(mask_b)[..., 0]
    np.testing.assert_array_equal(mask_a.sum(-1), mask_b.sum(-1))
    b, n, _ = idx_a.shape
    for bi in range(b):
        for ni in range(n):
            got = sorted(idx_a[bi, ni][mask_a[bi, ni] > 0].tolist())
            want = sorted(idx_b[bi, ni][mask_b[bi, ni] > 0].tolist())
            assert got == want, (bi, ni, got, want)


def rows_equal_as_multisets(got, want):
    """(B, N, K, C) values: per centre, the K rows must be equal as multisets
    (each row compared whole, so its channels stay together)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    b, n = got.shape[:2]
    for bi in range(b):
        for ni in range(n):
            g = sorted(map(tuple, got[bi, ni].tolist()))
            w = sorted(map(tuple, want[bi, ni].tolist()))
            assert g == w, (bi, ni)


KITTI_SEQ = 4  # the shortest KITTI sequence: 271 frames
KITTI_SEQ_FRAMES = 271
# LiDAR -> camera calibration of the fake tree: camera = R_C2L^-1 lidar
KITTI_TR = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], dtype=np.float64)


def build_fake_kitti(base_dir, world, num_points, step=0.5, radius=None,
                     seq=KITTI_SEQ, n_frames=KITTI_SEQ_FRAMES):
    """Write a KITTI-layout tree for one sequence under ``base_dir``:
    ``dataset/XX/calib.txt`` (with ``Tr:``), ``dataset/XX/velodyne/%06d.bin``
    (float32 N x 4), ``ground_truth_pose/XX.txt`` (camera-frame absolute
    poses) and ``ground_truth_pose/kitti_T_diff/XX_diff.npy`` (per-pair
    relative poses).  The vehicle moves ``step`` m along LiDAR +x per frame
    through the static ``world`` (M, 3); scan i is the world seen from pose
    i, only the points within ``radius`` m in the plane when given, the
    first ``num_points`` of them, zero-padded.  Returns (dataset_root,
    gt_dir, bytes written)."""
    base = str(base_dir)
    root = os.path.join(base, "dataset")
    seq_dir = os.path.join(root, f"{seq:02d}")
    velo = os.path.join(seq_dir, "velodyne")
    gt_dir = os.path.join(base, "ground_truth_pose")
    os.makedirs(velo)
    os.makedirs(os.path.join(gt_dir, "kitti_T_diff"))
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in KITTI_TR.reshape(-1)) + "\n")
    tr4 = np.eye(4)
    tr4[:3, :] = KITTI_TR
    world = np.asarray(world, dtype=np.float32)
    written = 0
    cam_poses = []
    for i in range(n_frames):
        pts = world - np.array([i * step, 0.0, 0.0], dtype=np.float32)  # the pose's frame
        if radius is not None:
            pts = pts[np.hypot(pts[:, 0], pts[:, 1]) <= radius]
        pad = np.zeros((num_points, 4), dtype=np.float32)
        m = min(len(pts), num_points)
        pad[:m, :3] = pts[:m]
        pad.tofile(os.path.join(velo, f"{i:06d}.bin"))
        written += pad.nbytes
        world_T_lidar = np.eye(4)
        world_T_lidar[0, 3] = i * step
        cam_poses.append(tr4 @ world_T_lidar @ np.linalg.inv(tr4))
    np.savetxt(os.path.join(gt_dir, f"{seq:02d}.txt"),
               np.stack([p[:3, :].reshape(-1) for p in cam_poses]))
    diffs = [np.eye(4)] + [np.linalg.inv(a) @ b for a, b in zip(cam_poses, cam_poses[1:])]
    np.save(os.path.join(gt_dir, "kitti_T_diff", f"{seq:02d}_diff.npy"),
            np.stack([d[:3, :].reshape(-1) for d in diffs]))
    return root, gt_dir, written
