"""Synthetic LiDAR scans for tests and the on-card smoke run.

The port's own copy of ``efficientlo_net_tpu/data/synthetic.py``: random
structured point sets inside the sensor FOV and the planar crop, pairs
related by a known rigid motion, training batches of them, and the drive
world (a persistent scene rendered along a trajectory, the world the
50-epoch weights were trained on).  Numpy and scipy only, so a seed gives
the same scans in both packages.
"""

from __future__ import annotations

import numpy as np

from ..config import SensorConfig
from .augmentation import augmentation_batch


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


# ---------------------------------------------------------------------------
# Synthetic drive: a persistent world sampled along a smooth trajectory.
#
# No reference counterpart (the reference assumes the real KITTI dataset).
# These functions produce structurally faithful KITTI-style sequences —
# static world, per-frame scans rendered from exact SE(3) poses — so the
# whole stack (training, sequence evaluation, RPE metrics, SLAM refinement)
# can run end-to-end at full resolution without the real data.  Scans are
# views of ONE persistent scene, so consecutive frames genuinely overlap the
# way real LiDAR pairs do (unlike ``synthetic_pair``, which re-observes the
# identical point set).

SENSOR_HEIGHT_M = 1.73  # HDL-64 mount height above ground on the KITTI car


def terrain_height(x, y):
    """Gentle large-wavelength ground undulation (meters)."""
    return 0.5 * np.sin(0.015 * x) + 0.4 * np.cos(0.021 * y + 0.7)


def terrain_gradient(x, y):
    """(dh/dx, dh/dy) of ``terrain_height`` — closed form."""
    return (
        0.5 * 0.015 * np.cos(0.015 * x),
        -0.4 * 0.021 * np.sin(0.021 * y + 0.7),
    )


def _pose_from_xy_yaw(x, y, yaw, pitch=0.0, roll=0.0):
    """world_T_lidar pose at (x, y) on the terrain.

    ``pitch``/``roll`` are EXTRA attitude on top of the terrain-slope
    coupling: the vehicle platform follows the local ground normal along
    its heading (pitch) and laterally (roll), the way a real car does —
    KITTI ground truth has continuous few-tenths-of-a-degree pitch/roll
    motion that a yaw-only generator never exhibits, leaving the network's
    rx/ry outputs supervised only by augmentation noise.
    """
    gx, gy = terrain_gradient(x, y)
    c, s = np.cos(yaw), np.sin(yaw)
    # uphill slope along heading tips the nose up (negative pitch in the
    # y-convention of Ry); lateral slope rolls toward the downhill side
    pitch = pitch - np.arctan(gx * c + gy * s)
    roll = roll + np.arctan(-gx * s + gy * c)
    cy_, sy_ = np.cos(pitch), np.sin(pitch)
    cx_, sx_ = np.cos(roll), np.sin(roll)
    rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cy_, 0.0, sy_], [0.0, 1.0, 0.0], [-sy_, 0.0, cy_]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cx_, -sx_], [0.0, sx_, cx_]])
    p = np.eye(4, dtype=np.float64)
    p[:3, :3] = rz @ ry @ rx
    p[:3, 3] = [x, y, terrain_height(x, y) + SENSOR_HEIGHT_M]
    return p


def _attitude_noise(n_frames: int, rng: np.random.Generator,
                    sigma_deg: float = 0.25, rho: float = 0.97):
    """Two slowly-varying AR(1) series (radians): suspension pitch/roll."""
    out = np.zeros((2, n_frames))
    scale = np.deg2rad(sigma_deg) * np.sqrt(1.0 - rho * rho)
    for k in range(2):
        v = 0.0
        for i in range(n_frames):
            v = rho * v + scale * rng.standard_normal()
            out[k, i] = v
    return out[0], out[1]


def synthetic_trajectory(
    n_frames: int, rng: np.random.Generator, kind: str = "wander",
    speed: float = 0.8, radius: float = 8.0,
) -> np.ndarray:
    """(n_frames, 4, 4) world_T_lidar poses (yaw-only attitude, terrain z).

    ``kind``:
      * "wander" — segment-based driving: mostly-straight cruises
        interleaved with deliberate constant-rate turns whose sharpness
        (0.5°..6°/frame) and cruise speed (0.45x..1.45x nominal) sweep the
        ranges an evaluation drive can hit.  Real driving — and KITTI — is
        predominantly straight, so a generator that turns all the time
        trains a turn prior the eval drive never exhibits;
      * "loop"  — a rounded rectangle (corner ``radius``) that closes on
        itself (loop-closure opportunities for the SLAM backend, like real
        KITTI seq 07);
      * "highway" — sustained fast cruising (use speed ~2.2 for KITTI
        seq-01-style 1.5-2.8 m/frame motion) with long sweeping
        constant-curvature curves (radius 120-420 m) instead of the
        wander kind's sharp urban corners.

    All kinds couple the platform attitude to the terrain slope and add a
    slowly-varying AR(1) pitch/roll texture (suspension motion), so GT
    inter-frame rotations exercise all three axes like real KITTI.
    """
    pn, rn = _attitude_noise(n_frames, rng)
    if kind == "loop":
        r = radius
        length = n_frames * speed
        straight = (length - 2.0 * np.pi * r) / 4.0
        if straight <= 0:
            raise ValueError("loop trajectory needs n_frames*speed > 2*pi*r")
        # piecewise arc-length parameterization of the rounded rectangle
        legs = []
        for _ in range(4):
            legs.append(("s", straight))
            legs.append(("t", np.pi * r / 2.0))
        poses, x, y, yaw = [], 0.0, 0.0, 0.0
        s_total, li, s_in_leg = 0.0, 0, 0.0
        for i in range(n_frames):
            poses.append(_pose_from_xy_yaw(x, y, yaw, pn[i], rn[i]))
            ds = speed
            while ds > 0 and li < len(legs):
                kind_l, leg_len = legs[li]
                take = min(ds, leg_len - s_in_leg)
                if kind_l == "s":
                    x += take * np.cos(yaw)
                    y += take * np.sin(yaw)
                else:
                    dyaw = take / r
                    # integrate along the arc (left turn)
                    cx = x - r * np.sin(yaw)
                    cy = y + r * np.cos(yaw)
                    yaw += dyaw
                    x = cx + r * np.sin(yaw)
                    y = cy - r * np.cos(yaw)
                s_in_leg += take
                ds -= take
                if s_in_leg >= leg_len - 1e-9:
                    li += 1
                    s_in_leg = 0.0
        return np.stack(poses)

    if kind == "highway":
        # long constant-curvature segments; yaw rate = curvature * speed
        curv = np.zeros(n_frames)
        speeds = np.full(n_frames, speed)
        i = 0
        while i < n_frames:
            seg = int(rng.integers(80, 240))
            speeds[i:i + seg] = rng.uniform(0.7, 1.25) * speed
            if rng.random() < 0.55:
                curv[i:i + seg] = rng.choice([-1.0, 1.0]) / rng.uniform(
                    120.0, 420.0)
            i += seg
        speeds = np.clip(
            speeds + 0.02 * speed * rng.standard_normal(n_frames),
            0.55 * speed, 1.3 * speed,
        )
        yaw_rate = curv * speeds + 0.0008 * rng.standard_normal(n_frames)
    else:
        # "wander": straight cruises interleaved with deliberate turns
        yaw_rate = np.zeros(n_frames)
        speeds = np.full(n_frames, speed)
        i = 0
        while i < n_frames:
            straight = int(rng.integers(40, 140))
            speeds[i:i + straight] = rng.uniform(0.45, 1.45) * speed
            i += straight
            if i >= n_frames:
                break
            dur = int(rng.integers(15, 65))
            angle = rng.choice([-1.0, 1.0]) * rng.uniform(np.pi / 5, np.pi / 2)
            yaw_rate[i:i + dur] = angle / dur
            speeds[i:i + dur] = rng.uniform(0.45, 1.2) * speed
            i += dur
        # small heading/throttle texture so straights are not perfectly rigid
        yaw_rate += 0.0015 * rng.standard_normal(n_frames)
        # clip relative to the nominal speed (an absolute clip would cap
        # fast-regime drives at the urban ceiling)
        speeds = np.clip(speeds + 0.03 * rng.standard_normal(n_frames),
                         0.25 * speed, 1.7 * speed)

    poses, x, y, yaw = [], 0.0, 0.0, 0.0
    for i in range(n_frames):
        poses.append(_pose_from_xy_yaw(x, y, yaw, pn[i], rn[i]))
        yaw += yaw_rate[i]
        x += speeds[i] * np.cos(yaw)
        y += speeds[i] * np.sin(yaw)
    return np.stack(poses)


def build_world(
    traj: np.ndarray,
    rng: np.random.Generator,
    ground_density: float = 24.0,
    corridor: float = 38.0,
    structures_per_m: float = 0.6,
) -> np.ndarray:
    """(M, 3) world points in a corridor around the trajectory.

    Ground plane (terrain-following) plus box-shaped structures (building
    faces, poles) on both sides of the path.  Density is chosen so a 35 m
    scan sees ~100k points, matching a real HDL-64 frame's order of
    magnitude.
    """
    from scipy.spatial import cKDTree

    traj_xy = traj[:, :2, 3]
    tree = cKDTree(traj_xy[::5])
    lo = traj_xy.min(axis=0) - corridor
    hi = traj_xy.max(axis=0) + corridor
    area = float(np.prod(hi - lo))

    cand = rng.uniform(lo, hi, (int(area * ground_density), 2))
    d, _ = tree.query(cand, workers=-1)
    gxy = cand[d <= corridor]
    gz = terrain_height(gxy[:, 0], gxy[:, 1]) + rng.normal(0, 0.02, len(gxy))
    parts = [np.column_stack([gxy, gz])]

    path_len = float(np.sum(np.linalg.norm(np.diff(traj_xy, axis=0), axis=1)))
    n_struct = max(4, int(path_len * structures_per_m))
    centers = rng.uniform(lo, hi, (n_struct * 4, 2))
    d, _ = tree.query(centers, workers=-1)
    centers = centers[(d > 4.0) & (d <= corridor - 2.0)][:n_struct]
    for cx, cy in centers:
        w, dep = rng.uniform(0.4, 4.0, 2)
        h = rng.uniform(1.0, 8.0)
        yaw = rng.uniform(0, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        base = terrain_height(cx, cy)
        # points on the four vertical faces, ~48 pts/m^2: the occlusion-aware
        # renderer returns at most one point per pixel, so faces need ~2x the
        # surface density of the old see-through sampler to fill their pixel
        # footprints at range
        face = _box_face_points(w, dep, h, rng)
        px = cx + c * face[:, 0] - s * face[:, 1]
        py = cy + s * face[:, 0] + c * face[:, 1]
        parts.append(np.column_stack([px, py, base + face[:, 2]]))
    world = np.concatenate(parts).astype(np.float32)
    return world


def _box_face_points(w: float, dep: float, h: float,
                     rng: np.random.Generator,
                     density: float = 48.0) -> np.ndarray:
    """(m, 3) points on the four vertical faces of a w x dep x h box
    centered at the origin, base at z=0."""
    n = max(16, int(2.0 * (w + dep) * h * density))
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(0.0, 1.0, n)
    side = rng.integers(0, 4, n)
    fx = np.where(side < 2, u * w, np.where(side == 2, -0.5, 0.5) * w)
    fy = np.where(side < 2, np.where(side == 0, -0.5, 0.5) * dep, u * dep)
    return np.column_stack([fx, fy, v * h]).astype(np.float32)


def make_dynamic_objects(
    traj: np.ndarray,
    rng: np.random.Generator,
    n_objects: int = 8,
) -> list:
    """Car-sized boxes moving on straight constant-velocity tracks near the
    ego trajectory.  Returns a list of dicts with ``pts`` (m, 3) local face
    points (base at z=0) and ``poses`` (n_frames, 4, 4) world poses.

    Real KITTI frames contain moving vehicles that violate the static-scene
    assumption the odometry network implicitly learns; the reference earns
    its accuracy bar in their presence, so the synthetic protocol must too.
    """
    n_frames = len(traj)
    objects = []
    for _ in range(n_objects):
        f0 = int(rng.integers(0, n_frames))
        anchor = traj[f0][:2, 3]
        ego_yaw = np.arctan2(traj[f0][1, 0], traj[f0][0, 0])
        # spawn offset to the side / ahead of the ego at its encounter frame
        along = rng.uniform(-10.0, 25.0)
        lateral = rng.choice([-1.0, 1.0]) * rng.uniform(2.5, 9.0)
        c, s = np.cos(ego_yaw), np.sin(ego_yaw)
        x0 = anchor[0] + c * along - s * lateral
        y0 = anchor[1] + s * along + c * lateral
        # same-direction traffic, oncoming, or crossing
        heading = ego_yaw + rng.choice(
            [0.0, np.pi, np.pi / 2, -np.pi / 2], p=[0.45, 0.35, 0.1, 0.1]
        ) + rng.normal(0.0, 0.05)
        speed = rng.uniform(0.3, 2.2)  # m/frame
        dims = (rng.uniform(1.6, 2.0), rng.uniform(3.8, 4.8),
                rng.uniform(1.4, 1.7))
        pts = _box_face_points(dims[0], dims[1], dims[2], rng)
        poses = np.tile(np.eye(4), (n_frames, 1, 1))
        ts = (np.arange(n_frames) - f0) * speed
        xs = x0 + ts * np.cos(heading)
        ys = y0 + ts * np.sin(heading)
        ch, sh = np.cos(heading), np.sin(heading)
        poses[:, 0, 0] = ch
        poses[:, 0, 1] = -sh
        poses[:, 1, 0] = sh
        poses[:, 1, 1] = ch
        poses[:, 0, 3] = xs
        poses[:, 1, 3] = ys
        poses[:, 2, 3] = terrain_height(xs, ys)
        objects.append({"pts": pts, "poses": poses})
    return objects


class DriveRenderer:
    """Occlusion-aware scan renderer: per-frame z-buffered views of a world
    (plus optional moving objects) from SE(3) poses.

    Simulates the physical sensor: candidate world points are projected to
    the sensor's own cylindrical (H, W) grid (same pixel math as the
    production projector, ``ops/projection.py`` / ``native/lidar_io.cpp``)
    and only the CLOSEST point per pixel returns — surfaces are opaque, so
    walls occlude what is behind them, exactly like a real beam's first
    return.  Points outside the vertical FOV produce no return.  A small
    per-return dropout models missing beams/absorbed returns.
    """

    def __init__(self, world: np.ndarray, max_radius: float = 35.5,
                 min_range: float = 2.2, noise: float = 0.01,
                 height: int = 64, width: int = 1800,
                 vfov_up_deg: float = 2.0, vfov_down_deg: float = -24.8,
                 drop_rate: float = 0.04, dynamics: list = None):
        from scipy.spatial import cKDTree

        self.world = world
        self.tree = cKDTree(world[:, :2])
        self.max_radius = max_radius
        self.min_range = min_range
        self.noise = noise
        self.height = height
        self.width = width
        self.vfov_up = np.deg2rad(vfov_up_deg)
        self.vfov_down = np.deg2rad(vfov_down_deg)
        self.drop_rate = drop_rate
        self.dynamics = dynamics or []

    @property
    def _grid(self):
        """(az_res, v_res, v_off) of the cylindrical grid."""
        az_res = 2.0 * np.pi / self.width
        v_res = (self.vfov_up - self.vfov_down) / (self.height - 1)
        return az_res, v_res, -self.vfov_down / v_res

    def _ray_dirs(self) -> np.ndarray:
        """(H*W, 3) unit ray directions in the lidar frame, one per pixel
        center, inverse of the projector's (row, col) mapping."""
        if not hasattr(self, "_rays"):
            az_res, v_res, v_off = self._grid
            rows, cols = np.meshgrid(
                np.arange(self.height), np.arange(self.width), indexing="ij"
            )
            beta = (self.height - rows + 0.5 - v_off) * v_res
            az = np.pi - (cols + 0.5) * az_res
            cb = np.cos(beta)
            self._rays = np.stack(
                [cb * np.cos(az), cb * np.sin(az), np.sin(beta)], axis=-1
            ).reshape(-1, 3)
        return self._rays

    def _zbuffer_points(self, local: np.ndarray):
        """Closest candidate point per pixel: (pix, r, xyz) arrays."""
        r = np.linalg.norm(local, axis=-1)
        keep = (r >= self.min_range) & (
            np.linalg.norm(local[:, :2], axis=-1) <= self.max_radius
        )
        local, r = local[keep], r[keep]
        az_res, v_res, v_off = self._grid
        beta = np.arcsin(np.clip(local[:, 2] / np.maximum(r, 1e-9), -1, 1))
        in_fov = (beta >= self.vfov_down - 0.5 * v_res) & (
            beta <= self.vfov_up + 0.5 * v_res
        )
        local, r, beta = local[in_fov], r[in_fov], beta[in_fov]
        col = ((np.pi - np.arctan2(local[:, 1], local[:, 0]))
               / az_res).astype(np.int64)
        row = self.height - (beta / v_res + v_off).astype(np.int64)
        np.clip(row, 0, self.height - 1, out=row)
        np.clip(col, 0, self.width - 1, out=col)
        pix = row * self.width + col
        order = np.lexsort((r, pix))
        first = np.ones(len(order), dtype=bool)
        first[1:] = pix[order][1:] != pix[order][:-1]
        sel = order[first]
        return pix[sel], r[sel], local[sel]

    def _raycast_ground(self, pose: np.ndarray):
        """Analytic per-pixel ground return: (pix, r, xyz-local) arrays.

        A point-sampled ground cannot fill near-field pixel footprints (a
        few cm^2 at 5 m) at any tractable density, so ground returns are
        ray-cast against the closed-form terrain instead — dense near rings
        and naturally sparse far rings, exactly like a real scan.  Fixed
        point iteration r <- (o_z - h(o + r d)) / -d_z converges in a few
        steps (terrain slope << ray slope for every in-FOV ray).
        """
        dirs_l = self._ray_dirs()
        dirs_w = dirs_l @ pose[:3, :3].T
        o = pose[:3, 3]
        dz = dirs_w[:, 2]
        down = dz < -5e-3
        d = dirs_w[down]
        r = np.full(len(d), (o[2] - terrain_height(o[0], o[1])))
        r /= -d[:, 2]
        lim = self.max_radius * 1.6
        for _ in range(8):
            np.clip(r, self.min_range, lim, out=r)
            hz = terrain_height(o[0] + r * d[:, 0], o[1] + r * d[:, 1])
            r = (o[2] - hz) / -d[:, 2]
        np.clip(r, 0.0, lim, out=r)
        hit_z = o[2] + r * d[:, 2]
        res = np.abs(hit_z - terrain_height(o[0] + r * d[:, 0],
                                            o[1] + r * d[:, 1]))
        planar = r * np.linalg.norm(d[:, :2], axis=-1)
        ok = (res < 0.02) & (r >= self.min_range) & (planar <= self.max_radius)
        pix = np.flatnonzero(down)[ok]
        r = r[ok]
        return pix, r, r[:, None] * dirs_l[pix]

    def render(self, pose: np.ndarray, num_points: int,
               rng: np.random.Generator, frame: int = None) -> np.ndarray:
        """(num_points, 3) float32 scan in the lidar frame (zero-padded).

        ``frame`` indexes the dynamic objects' pose tracks; None renders the
        static world only.
        """
        idx = self.tree.query_ball_point(pose[:2, 3], self.max_radius + 0.5)
        cand = [self.world[idx].astype(np.float64)]
        if frame is not None:
            for obj in self.dynamics:
                op = obj["poses"][frame]
                if np.linalg.norm(op[:2, 3] - pose[:2, 3]) > \
                        self.max_radius + 6.0:
                    continue
                cand.append(obj["pts"] @ op[:3, :3].T + op[:3, 3])
        pts = np.concatenate(cand) if len(cand) > 1 else cand[0]
        local = (pts - pose[:3, 3]) @ pose[:3, :3]
        ppix, pr, ppts = self._zbuffer_points(local)
        gpix, gr, gpts = self._raycast_ground(pose)
        # merge the two return sets: closest wins per pixel (opaque surfaces
        # occlude the ground behind them and vice versa; a tie keeps the
        # surface point)
        npix = self.height * self.width
        best_g = np.full(npix, np.inf)
        best_g[gpix] = gr
        best_p = np.full(npix, np.inf)
        best_p[ppix] = pr
        take_p = pr <= best_g[ppix]
        take_g = gr < best_p[gpix]
        local = np.concatenate([ppts[take_p], gpts[take_g]])
        if self.drop_rate > 0.0 and len(local):
            local = local[rng.random(len(local)) >= self.drop_rate]
        local = local + rng.normal(0, self.noise, local.shape)
        if len(local) > num_points:
            sel = rng.choice(len(local), num_points, replace=False)
            local = local[sel]
        else:
            rng.shuffle(local)
        out = np.zeros((num_points, 3), dtype=np.float32)
        out[: len(local)] = local
        return out


def synthetic_batch(rng: np.random.Generator, batch_size: int, sensor: SensorConfig,
                    training: bool = False) -> dict:
    """A batch of ``synthetic_pair``s with its augmentation fields, the keys
    ``training.step`` reads: pc1, pc2 (B, N, 3), T_gt, T_trans, T_trans_inv
    (B, 4, 4) and aug_frame (B,)."""
    pc1, pc2, T_gt = zip(*(synthetic_pair(rng, sensor) for _ in range(batch_size)))
    T_trans, T_trans_inv, aug_frame = augmentation_batch(rng, batch_size, training)
    return {
        "pc1": np.stack(pc1),
        "pc2": np.stack(pc2),
        "T_gt": np.stack(T_gt),
        "T_trans": T_trans,
        "T_trans_inv": T_trans_inv,
        "aug_frame": aug_frame,
    }
