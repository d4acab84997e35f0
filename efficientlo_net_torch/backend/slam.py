"""Sliding-window SLAM: keyframe selection + pose-graph maintenance on top
of frame-to-frame odometry.

Port of ``efficientlo_net_tpu/backend/slam.py``.  The frontend supplies per-frame
relative poses (the PWCLO network's l0 output); this module:

* promotes frames to keyframes when accumulated motion exceeds distance /
  rotation thresholds,
* keeps a sliding window of keyframe poses linked by odometry factors,
* detects loop closures: keyframes spatially near but temporally far from
  the newest keyframe are re-measured with a user-supplied relative-pose
  callable (e.g. ``OdometryStream.measure_relative`` on the two keyframes'
  range images) and added as closure factors,
* optimizes the window with the Gauss-Newton solver of
  ``backend/pose_graph.py`` on ``SlamConfig.solver_device``, its
  reductions distributed over ``group`` where one is given,
* marginalizes keyframes that leave the window via the Schur complement:
  their factors are folded into a dense ``PriorFactor`` on the in-window
  keyframes they touched, so no information is silently dropped.

Keyframe poses and factors are float64 numpy on the host; every solve runs
in float32 on the solver device, in full float32 (``pose_graph.full_fp32``)
from the scan association to the write-back.  Payloads are opaque; image
payloads ((H, W, 3) or (1, H, W, 3), numpy or tensor on any device) feed
scan factors, closure ICP and ``render_map``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..evaluation.odometry import quat_to_mat_np
from ..ops import se3
from ..parallel.mesh import axis_group
from . import pose_graph as pg


@dataclasses.dataclass
class SlamConfig:
    keyframe_distance: float = 2.0      # meters
    keyframe_rotation: float = 0.1      # radians
    window_size: int = 20               # keyframes kept in the window
    optimize_every: int = 5             # keyframes between optimizations
    closure_radius: float = 4.0         # meters: candidate search radius
    closure_min_gap: int = 10           # keyframes: temporal separation floor
    closure_weight: float = 50.0
    # search the whole keyframe history for closure candidates, not just the
    # window.  A closure to an already-departed (frozen) keyframe still
    # enters the optimization: marginalization folds it into the prior on
    # the in-window end at the frozen pose's linearization, pulling the
    # window back toward the revisited place.
    closure_search_all: bool = False
    # fixed-pose anchor strength for already-frozen keyframes that re-enter
    # the system through a late loop closure (see _marginalize_departed)
    frozen_prior_weight: float = 1e4
    # where a closure whose older endpoint is already OUT of the window goes:
    # * "global" (default): archived for ``global_optimize`` only.  Feeding
    #   it to the window would satisfy it by bending the last few keyframes
    #   against the frozen (drifted) pose: a kink the refined chain then
    #   bakes in, leaving the global pass with zero residual to distribute.
    # * "window": enters the window via the frozen-pose anchor prior (online
    #   correction, no batch pass needed).
    # In-window closures always enter the window graph directly.
    closure_to_frozen: str = "global"
    marginalize: bool = True            # False: drop departing factors (ablation)
    # point-to-plane scan factors between consecutive window keyframes
    # (requires keyframe payloads to be range images and ``scan_sensor`` to
    # be set on the SLAM object)
    use_scan_factors: bool = False
    scan_max_dist: float = 1.0
    scan_weight: float = 1.0
    # polish accepted closure measurements with point-to-plane ICP against
    # the two keyframes' range images (scan_factors.icp_refine) and gate on
    # its diagnostics; requires ``scan_sensor`` and image payloads
    closure_icp: bool = False
    closure_icp_min_inliers: float = 0.2
    closure_icp_max_rms: float = 0.3
    # pixel-stride subsampling of each pair's correspondence block: a 6-DoF
    # constraint needs thousands, not all H*W=115200 pixels; 4 keeps ~29k
    # candidates per pair and cuts the per-iteration Jacobian work 4x
    scan_subsample: int = 4
    # torch device of the solver's tensors: None is the card ("cuda");
    # "cpu" when the caller asks for it.  Never falls back on its own.
    solver_device: Optional[str] = None
    gn: pg.GaussNewtonConfig = dataclasses.field(default_factory=pg.GaussNewtonConfig)


def _mat_from_qt(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_mat_np(np.asarray(q, dtype=np.float64))
    m[:3, 3] = t
    return m


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().double().numpy()


class SlidingWindowSLAM:
    """Online sliding-window pose-graph SLAM over odometry estimates.

    ``closure_fn(payload_i, payload_j) -> 4x4 | None`` measures the relative
    transform i_T_j between two keyframes' stored payloads (e.g. their range
    images, fed back through the odometry network); returning None rejects
    the candidate.  A ``closure_fn`` with a ``rel_init`` keyword gets the
    graph's own estimate as a seed.  Payloads are attached per frame via
    ``add_frame(..., payload=)`` and captured at keyframe promotion.
    ``group`` (a process group or a one-dimensional ``DeviceMesh``, the JAX
    package's ``mesh``) is passed to every ``pose_graph.optimize``: each of
    its ranks runs the same SLAM on the same frames and reduces its share
    of the factors.
    """

    def __init__(
        self,
        cfg: SlamConfig = SlamConfig(),
        closure_fn: Optional[Callable] = None,
        scan_sensor=None,
        initial_payload=None,
        group=None,
    ):
        self.cfg = cfg
        self.group = group
        self.device = resolve_device(cfg.solver_device or "cuda")
        self.closure_fn = closure_fn
        self.scan_sensor = scan_sensor  # SensorConfig for scan-factor payloads
        # keyframe state; keyframe 0 is the drive origin: give it a payload
        # (``initial_payload`` or ``set_initial_payload``) so closures back
        # to the start and the first scan-factor pair are measurable
        self.kf_poses: List[np.ndarray] = [np.eye(4)]       # world_T_kf
        self.kf_frame_ids: List[int] = [0]
        self.kf_payloads: List[object] = [initial_payload]
        # factors between keyframes (global keyframe ids)
        self.factors: List[Tuple[int, int, np.ndarray, float]] = []
        # permanent archives: ``factors`` gets pruned by marginalization,
        # but a late loop closure can only repair already-frozen drift
        # through a *global* re-optimization over the full history
        # (``global_optimize``):
        # * raw odometry factors as measured (diagnostics / ablation),
        self.archive: List[Tuple[int, int, np.ndarray, float]] = []
        # * every accepted loop-closure factor,
        self.closure_archive: List[Tuple[int, int, np.ndarray, float]] = []
        # * consecutive-keyframe relatives captured at FREEZE time, after
        #   every scan factor / closure that touched them in-window has
        #   acted.  The global chain must carry this refined information;
        #   rebuilding it from raw odometry would throw the window's work
        #   away.
        self._refined_chain: dict = {}
        self.closed_pairs: set = set()
        # per-keyframe range-image normals (computed once per keyframe, the
        # payload is immutable after promotion)
        self._normal_cache: dict = {}
        # marginalization prior over global keyframe ids (pg.PriorFactor)
        self._prior: Optional[pg.PriorFactor] = None
        self._frozen_ids: set = set()   # keyframes already marginalized away
        self._frame_count = 0
        self._T_since_kf = np.eye(4)                        # kf_T_current
        self._current = np.eye(4)                           # world_T_current
        self._kf_since_opt = 0
        self._last_payload: object = None
        self.full_trajectory: List[np.ndarray] = [np.eye(4)]

    def set_initial_payload(self, payload) -> None:
        """Attach the first frame's payload to keyframe 0 (the drive
        origin), making it a valid loop-closure / scan-factor target."""
        self.kf_payloads[0] = payload

    # -- frontend ---------------------------------------------------------
    def add_frame(self, q: np.ndarray, t: np.ndarray, payload=None) -> None:
        """Feed one frame-to-frame odometry estimate (LiDAR convention of the
        network: transform of frame k relative to k-1).  ``payload`` is an
        opaque handle (e.g. the range image) kept if this frame becomes a
        keyframe.  A zero-arg callable payload is resolved only on keyframe
        promotion, so callers with expensive payload materialization (e.g. a
        device->host copy) pay it only for the frames that become
        keyframes.  A device tensor payload stays where it is."""
        rel = _mat_from_qt(q, t)
        self._frame_count += 1
        self._T_since_kf = self._T_since_kf @ rel
        self._current = self.kf_poses[-1] @ self._T_since_kf
        self._last_payload = payload
        self.full_trajectory.append(self._current.copy())

        dist = float(np.linalg.norm(self._T_since_kf[:3, 3]))
        # rotation angle in numpy (trace formula): no device round trip per
        # frame
        tr = float(np.trace(self._T_since_kf[:3, :3]))
        ang = float(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
        if dist >= self.cfg.keyframe_distance or ang >= self.cfg.keyframe_rotation:
            self._promote_keyframe()

    def _promote_keyframe(self) -> None:
        i = len(self.kf_poses) - 1
        self.factors.append((i, i + 1, self._T_since_kf.copy(), 1.0))
        self.archive.append((i, i + 1, self._T_since_kf.copy(), 1.0))
        self.kf_poses.append(self._current.copy())
        self.kf_frame_ids.append(self._frame_count)
        payload = self._last_payload
        self.kf_payloads.append(payload() if callable(payload) else payload)
        self._T_since_kf = np.eye(4)
        self._kf_since_opt += 1

        found = self.detect_loop_closures()
        if found or self._kf_since_opt >= self.cfg.optimize_every:
            self.optimize_window()
            self._kf_since_opt = 0

    def add_loop_closure(self, kf_i: int, kf_j: int, rel: np.ndarray,
                         weight: Optional[float] = None):
        """rel: measured kf_i_T_kf_j (e.g. from re-running the odometry
        network on the two keyframes' range images)."""
        rel = np.asarray(rel, dtype=np.float64)
        if rel.shape != (4, 4):
            raise ValueError(f"closure transform must be (4, 4), got {rel.shape}")
        w = self.cfg.closure_weight if weight is None else weight
        in_window = kf_i >= int(self._window_ids()[0])
        if in_window or self.cfg.closure_to_frozen == "window":
            self.factors.append((kf_i, kf_j, rel, w))
        self.closure_archive.append((kf_i, kf_j, rel, w))
        self.closed_pairs.add((kf_i, kf_j))

    def detect_loop_closures(self) -> int:
        """Search keyframes spatially near but temporally far from the
        newest keyframe; measure each candidate with ``closure_fn`` and add
        accepted factors.  Returns the number of closures added."""
        if self.closure_fn is None:
            return 0
        if self.cfg.closure_search_all:
            ids = np.arange(len(self.kf_poses))
        else:
            ids = self._window_ids()
        i = len(self.kf_poses) - 1
        if self.kf_payloads[i] is None:
            return 0
        # pass the graph's own relative estimate kf_j_T_kf_i as a seed when
        # the measurement function accepts it: a revisit offset of several
        # meters is outside the odometry network's trained regime, but the
        # residual after warping by the graph estimate is inside it
        try:
            takes_init = "rel_init" in inspect.signature(self.closure_fn).parameters
        except (TypeError, ValueError):
            takes_init = False
        pos_i = self.kf_poses[i][:3, 3]
        added = 0
        for j in ids:
            if i - j < self.cfg.closure_min_gap or (j, i) in self.closed_pairs:
                continue
            if self.kf_payloads[j] is None:
                continue
            if np.linalg.norm(self.kf_poses[j][:3, 3] - pos_i) > self.cfg.closure_radius:
                continue
            if takes_init:
                rel_init = np.linalg.inv(self.kf_poses[j]) @ self.kf_poses[i]
                rel = self.closure_fn(self.kf_payloads[j], self.kf_payloads[i],
                                      rel_init=rel_init)
            else:
                rel = self.closure_fn(self.kf_payloads[j], self.kf_payloads[i])
            if rel is None:
                continue
            if self.cfg.closure_icp and self.scan_sensor is not None:
                rel = self._icp_polish(j, i, np.asarray(rel, dtype=np.float64))
                if rel is None:
                    continue
            self.add_loop_closure(j, i, np.asarray(rel, dtype=np.float64))
            added += 1
        return added

    def _image(self, kf: int) -> torch.Tensor:
        """Keyframe ``kf``'s range-image payload as a float32 (H, W, 3)
        tensor on the solver device."""
        img = torch.as_tensor(self.kf_payloads[kf], dtype=torch.float32, device=self.device)
        return img.reshape(img.shape[-3:])

    @pg.full_fp32()
    def _icp_polish(self, j: int, i: int, rel: np.ndarray):
        """Refine a closure measurement kf_j_T_kf_i with point-to-plane ICP
        on the two keyframes' range images; gate on inlier fraction and
        residual RMS.  Returns the polished (4, 4) or None if rejected."""
        from . import scan_factors as sfm

        t, inl, rms = sfm.icp_refine(
            self._image(j), self._image(i),
            torch.as_tensor(rel, dtype=torch.float32, device=self.device),
            self.scan_sensor, max_dist=self.cfg.scan_max_dist,
        )
        if float(inl) < self.cfg.closure_icp_min_inliers or \
                float(rms) > self.cfg.closure_icp_max_rms:
            return None
        return _host(t)

    # -- backend ----------------------------------------------------------
    def _window_ids(self) -> np.ndarray:
        n = len(self.kf_poses)
        lo = max(0, n - self.cfg.window_size)
        return np.arange(lo, n)

    def _poses(self, ids) -> torch.Tensor:
        """float32 (len(ids), 4, 4) keyframe poses on the solver device."""
        stacked = np.stack([self.kf_poses[g] for g in ids]).astype(np.float32)
        return torch.as_tensor(stacked, device=self.device)

    def _prior_mini_contribution(self, mini_poses, id_map):
        """(H, b) contribution of the current prior inside a mini system
        (all prior nodes must be present in ``id_map``), evaluated by the
        solver's own ``pg._prior_contribution`` so the linearization /
        convention lives in exactly one place."""
        local = self._prior.shifted(np.array([id_map[g] for g in self._prior.node_ids]))
        h, b, _ = pg._prior_contribution(mini_poses, local)
        return _host(h), _host(b)

    def _marginalize_departed(self, lo: int) -> None:
        """Schur-fold everything touching keyframes below ``lo`` into a dense
        prior on the in-window keyframes they constrain."""
        prior_nodes = list(self._prior.node_ids) if self._prior is not None else []
        departed_factors = [f for f in self.factors if f[0] < lo or f[1] < lo]
        dropped = sorted(
            {n for f in departed_factors for n in (f[0], f[1]) if n < lo}
            | {n for n in prior_nodes if n < lo}
        )
        if not dropped:
            return
        # snapshot the refined consecutive relative of every keyframe that
        # freezes now: the global chain factor for global_optimize
        for g in dropped:
            if g not in self._refined_chain and g + 1 < len(self.kf_poses):
                self._refined_chain[g] = np.linalg.inv(self.kf_poses[g]) @ self.kf_poses[g + 1]
        kept = sorted(
            {n for f in departed_factors for n in (f[0], f[1]) if n >= lo}
            | {n for n in prior_nodes if n >= lo}
        )
        self.factors = [f for f in self.factors if f[0] >= lo and f[1] >= lo]
        if not kept:
            self._prior = None  # nothing in-window is constrained
            self._frozen_ids.update(dropped)
            return

        nodes = dropped + kept
        id_map = {g: l for l, g in enumerate(nodes)}
        poses = self._poses(nodes)
        if departed_factors:
            factors = pg.make_factors(
                np.array([id_map[f[0]] for f in departed_factors]),
                np.array([id_map[f[1]] for f in departed_factors]),
                np.stack([f[2] for f in departed_factors]).astype(np.float32),
                np.array([f[3] for f in departed_factors], dtype=np.float32),
                num_nodes=len(nodes), device=self.device,
            )
            h, b, _ = pg.assemble_system(poses, factors)
            h, b = _host(h), _host(b)
        else:
            dim = 6 * len(nodes)
            h = np.zeros((dim, dim))
            b = np.zeros((dim,))
        if self._prior is not None:
            h_p, b_p = self._prior_mini_contribution(poses, id_map)
            h += h_p
            b += b_p

        # Keyframes that were frozen in an earlier round and reappear now
        # (through a late loop closure) carry no prior mass here: Schur
        # over a totally unconstrained node would annihilate the closure.
        # Anchor them at their frozen pose (the linearization point, so the
        # gradient contribution is zero) so the between-factor correctly
        # becomes a unary constraint on the in-window end.
        for g in dropped:
            if g in self._frozen_ids and g not in set(prior_nodes):
                sl = id_map[g] * 6 + np.arange(6)
                h[sl, sl] += self.cfg.frozen_prior_weight

        keep_l = np.array([id_map[g] for g in kept])
        drop_l = np.array([id_map[g] for g in dropped])
        h_new, b_new = pg.marginalize(
            torch.as_tensor(h.astype(np.float32), device=self.device),
            torch.as_tensor(b.astype(np.float32), device=self.device),
            keep_l, drop_l,
        )
        self._prior = pg.PriorFactor(node_ids=np.asarray(kept), h=h_new, b=b_new,
                                     lin_poses=self._poses(kept))
        self._frozen_ids.update(dropped)

    @pg.full_fp32()
    def optimize_window(self) -> float:
        """Gauss-Newton over the current window (with the marginalization
        prior); returns final chi2."""
        ids = self._window_ids()
        if self.cfg.marginalize:
            self._marginalize_departed(int(ids[0]))
        id_map = {g: l for l, g in enumerate(ids)}
        fs = [(id_map[i], id_map[j], z, w) for (i, j, z, w) in self.factors
              if i in id_map and j in id_map]
        if not fs:
            return 0.0
        src = np.array([f[0] for f in fs])
        dst = np.array([f[1] for f in fs])
        meas = np.stack([f[2] for f in fs]).astype(np.float32)
        weight = np.array([f[3] for f in fs], dtype=np.float32)

        # pad node count and factor capacity to shape buckets, as the JAX
        # package does (padding nodes carry identity poses and no factors;
        # the damping term keeps H invertible and their update is exactly
        # zero)
        n_window = len(ids)
        n_pad = min(-(-n_window // 8) * 8, max(self.cfg.window_size, n_window))
        capacity = 1 << (len(fs) - 1).bit_length()

        factors = pg.make_factors(src, dst, meas, weight, num_nodes=n_pad, capacity=capacity,
                                  device=self.device)
        poses0 = torch.cat([self._poses(ids),
                            torch.eye(4, device=self.device).expand(n_pad - n_window, 4, 4)])
        prior_local = (
            self._prior.shifted(np.array([id_map[g] for g in self._prior.node_ids]))
            if self._prior is not None else None
        )
        scan_factors = self._build_scan_factors(ids, id_map, poses0)
        opt, history = pg.optimize(poses0, factors, self.cfg.gn, prior=prior_local,
                                   scan_factors=scan_factors, group=self.group)
        opt = _host(opt)[:n_window]

        # write back, re-anchoring the world frame on the window head so the
        # fixed (out-of-window) prefix stays consistent
        anchor = self.kf_poses[ids[0]] @ np.linalg.inv(opt[0])
        for l, g in enumerate(ids):
            self.kf_poses[g] = anchor @ opt[l]
        self._current = self.kf_poses[-1] @ self._T_since_kf
        return float(history[-1])

    @pg.full_fp32()
    def global_optimize(self, iterations: int = 30, robust_closures: bool = True,
                        chain: str = "refined") -> float:
        """Batch pose-graph optimization over ALL keyframes: the refined
        consecutive-keyframe chain + every accepted loop closure.

        The sliding window freezes keyframes as they depart; a loop closure
        found hundreds of keyframes later can therefore only correct the
        window, never the drifted history.  This is the standard offline PGO
        pass that distributes the closure's correction along the whole chain:
        run it once after the drive (or at any checkpointing opportunity).
        Initializes at the current ``kf_poses``, gauge-fixes keyframe 0, and
        writes the optimized poses back.  Returns the final chi2.

        ``chain='refined'`` (default) uses each consecutive pair's relative
        pose as it stood when the earlier keyframe froze, i.e. AFTER all
        in-window scan factors and closures acted on it; ``chain='raw'``
        rebuilds from the archived odometry measurements (ablation: it
        discards the window's refinements).

        ``robust_closures`` applies the Geman-McClure kernel to the CLOSURE
        factors only (chain factors stay quadratic), so a false closure that
        survived the measurement gate switches itself off instead of folding
        the trajectory.

        Safe to run mid-drive: the write-back also updates the
        marginalization prior's linearization points by each node's own
        correction, so a subsequent ``optimize_window`` sees a consistent
        prior.  ``full_trajectory`` (the raw per-frame history) is NOT
        rewritten: re-anchor per-frame poses to ``kf_poses`` downstream.
        """
        n = len(self.kf_poses)
        if n < 2:
            return 0.0
        if chain == "refined":
            chain_fs = [
                (g, g + 1,
                 self._refined_chain.get(g, np.linalg.inv(self.kf_poses[g]) @ self.kf_poses[g + 1]),
                 1.0)
                for g in range(n - 1)
            ]
        else:
            chain_fs = list(self.archive)
        fs = chain_fs + list(self.closure_archive)
        src = np.array([f[0] for f in fs])
        dst = np.array([f[1] for f in fs])
        meas = np.stack([f[2] for f in fs]).astype(np.float32)
        weight = np.array([f[3] for f in fs], dtype=np.float32)
        # robust kernel eligibility: closures only
        rmask = np.concatenate([np.zeros(len(chain_fs), np.float32),
                                np.ones(len(self.closure_archive), np.float32)])
        # with a group, pad the factors to a multiple of its size (zero weight)
        ranks = (1 if self.group is None
                 else torch.distributed.get_world_size(axis_group(self.group)))
        factors = pg.make_factors(src, dst, meas, weight, num_nodes=n, robust_mask=rmask,
                                  capacity=-(-len(fs) // ranks) * ranks, device=self.device)
        poses0 = self._poses(range(n))
        # phase 1: non-robust: a CORRECT closure starts with a residual the
        # size of the accumulated drift, and a redescending kernel evaluated
        # there would switch it off before it can act
        gn = dataclasses.replace(self.cfg.gn, iterations=iterations, robust_delta=None)
        opt, history = pg.optimize(poses0, factors, gn, group=self.group)
        if robust_closures:
            # phase 2: Geman-McClure polish from the pulled-in state: now
            # only genuinely inconsistent factors carry big residuals
            gn2 = dataclasses.replace(self.cfg.gn, iterations=iterations, robust_delta=1.0,
                                      robust_kernel="gm")
            opt, history = pg.optimize(opt, factors, gn2, group=self.group)
        opt = _host(opt)
        anchor = self.kf_poses[0] @ np.linalg.inv(opt[0])
        old_poses = [p.copy() for p in self.kf_poses]
        for g in range(n):
            self.kf_poses[g] = anchor @ opt[g]
        self._current = self.kf_poses[-1] @ self._T_since_kf
        if self._prior is not None:
            # the prior's quadratic is over d_i = Log(lin_i^-1 T_i);
            # left-multiplying each node's correction C_i = T_new T_old^-1
            # into lin_i keeps d_i (hence the prior's pull) invariant under
            # the global re-write
            lin = _host(self._prior.lin_poses)
            new_lin = [self.kf_poses[g] @ np.linalg.inv(old_poses[g]) @ lin[k]
                       for k, g in enumerate(np.asarray(self._prior.node_ids))]
            self._prior = pg.PriorFactor(
                node_ids=self._prior.node_ids, h=self._prior.h, b=self._prior.b,
                lin_poses=torch.as_tensor(np.stack(new_lin).astype(np.float32),
                                          device=self.device),
            )
        return float(history[-1])

    def _build_scan_factors(self, ids, id_map, poses0):
        """Point-to-plane factors between consecutive window keyframes whose
        payloads are range images (cfg.use_scan_factors)."""
        if not self.cfg.use_scan_factors or self.scan_sensor is None:
            return None
        from . import scan_factors as sfm

        def normals_of(kf: int):
            # payloads are immutable after promotion: compute once per kf
            if kf not in self._normal_cache:
                self._normal_cache[kf], _ = sfm.compute_normals(self._image(kf))
            return self._normal_cache[kf]

        # normals for keyframes behind the window are never needed again
        # (scan pairs are consecutive in-window keyframes)
        for kf in [k for k in self._normal_cache if k < ids[0]]:
            del self._normal_cache[kf]

        s = max(1, self.cfg.scan_subsample)
        pairs, corrs = [], []
        for a, b in zip(ids[:-1], ids[1:]):
            if self.kf_payloads[a] is None or self.kf_payloads[b] is None:
                continue
            t_ab = se3.se3_inv(poses0[id_map[a]]) @ poses0[id_map[b]]
            corr = sfm.projective_association(
                self._image(b), self._image(a), normals_of(a), t_ab, self.scan_sensor,
                max_dist=self.cfg.scan_max_dist, normals_j=normals_of(b),
            )
            pairs.append((id_map[a], id_map[b]))
            corrs.append(corr.subsampled(s, self.cfg.scan_weight))
        if not pairs:
            return None
        return sfm.make_scan_factors(pairs, corrs)

    def keyframe_trajectory(self) -> np.ndarray:
        return np.stack(self.kf_poses)

    def render_map(self, voxel: float = 0.2, max_range: Optional[float] = None) -> np.ndarray:
        """World-frame point map fused from the keyframes' range-image
        payloads at the current (optimized) poses; see backend/mapping.py."""
        from .mapping import assemble_map

        payloads = [
            p.detach().cpu().numpy().reshape(p.shape[-3:]) if torch.is_tensor(p) else p
            for p in self.kf_payloads
        ]
        return assemble_map(self.kf_poses, payloads, voxel=voxel, max_range=max_range)
