"""Streaming odometry inference: one new scan per step.

Port of ``OdometryStream`` from ``efficientlo_net_tpu/evaluation/streaming.py``,
with the loop-closure measurement ``measure_relative`` and host projection.
Each scan pairs with the previous one, whose range
image and feature pyramid were computed when it arrived, so the steady-state
cost per frame is one projection, ONE feature tower and the correlation /
refinement stages.  Eval-mode pyramids are deterministic, so the cached
pyramid equals a recomputed one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..data import native_io
from ..device import resolve_device
from ..ops.projection import crop_and_project
from .odometry import quat_to_mat_np


class OdometryStream:
    """Emits the relative pose (q, t) of each pushed scan w.r.t. the
    previous one.  ``model`` is a ``PWCLONet`` with its weights loaded; the
    stream moves it to ``device`` and puts it in eval mode.

    ``host_projection=True`` crops and projects each scan on the CPU with
    the native projector (``data/native_io.py``, exact: the nearest point
    per pixel) and copies the dense image to the device, in place of the
    device's packed projection of the raw points.  Unlike the JAX package,
    which then falls back to device projection without the native library,
    the port raises: a stream that says it projects on the host does so."""

    def __init__(self, model, cfg: ModelConfig, device="cuda", host_projection: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        if host_projection and not native_io.available():
            raise RuntimeError("host_projection=True needs the native library "
                               "(native/lidar_io.cpp and a host C++ compiler)")
        self.host_projection = host_projection
        self.model = model.to(self.device).eval()
        self._prev = None
        #: (1, H, W, 3) range image of the most recent pushed scan
        self.last_projection = None

    def reset(self) -> None:
        self._prev = None

    def project(self, points: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) raw points -> (B, H, W, 3) range image, after the
        validity mask and the planar crop the network was trained with."""
        return crop_and_project(points, self.cfg.sensor)

    def project_scan(self, points: np.ndarray) -> torch.Tensor:
        """One raw scan (N, 3) -> its (1, H, W, 3) range image on the
        device: projected on the host with ``host_projection``, else copied
        and projected on the device."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        if self.host_projection:
            s = self.cfg.sensor
            img = native_io.project_scan(points, s.height, s.width, s,
                                         crop_radius=s.max_planar_radius)
            return torch.from_numpy(img[None]).to(self.device)
        return self.project(torch.as_tensor(points, device=self.device)[None])

    def _warp_project(self, img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """Rigidly move a (1, H, W, 3) range image's valid points by the
        (4, 4) ``m`` and re-project them.  Invalid (zero) pixels stay at the
        origin, or they would all land at m's translation as a phantom
        point."""
        pts = img.reshape(img.shape[0], -1, 3)
        valid = torch.any(pts != 0.0, dim=-1, keepdim=True)
        moved = pts @ m[:3, :3].T + m[:3, 3]
        return self.project(torch.where(valid, moved, torch.zeros((), device=pts.device)))

    def _relative(self, pyr_new, pyr_prev) -> np.ndarray:
        """float64 (4, 4) of the network's l0 (q, t) for one pyramid pair."""
        out = self.model.forward_from_pyramids(pyr_new, pyr_prev)
        q = out["q"][0][0].double().cpu().numpy()
        m = np.eye(4)
        m[:3, :3] = quat_to_mat_np(q / np.linalg.norm(q))
        m[:3, 3] = out["t"][0][0].double().cpu().numpy()
        return m

    @torch.no_grad()
    def measure_relative(self, img_i, img_j, t_init=None, refinements: int = 2) -> np.ndarray:
        """Measure i_T_j between two range images by iterated
        warp-and-measure: the loop-closure measurement primitive.

        The network is trained on consecutive-frame motion (~0.6-0.9 m); a
        revisit pair can sit meters apart, outside that regime.  So: measure
        once raw (or start from ``t_init``), then repeatedly warp frame j's
        points into frame i by the current estimate, re-project, and let the
        network measure the *residual* motion, which IS in its trained
        regime.  Each refinement composes ``i_T_j <- delta @ i_T_j``.

        img_i / img_j: (H, W, 3) or (1, H, W, 3) range images, numpy or
        tensor (e.g. SLAM keyframe payloads).  Returns a (4, 4) float64 numpy
        i_T_j.  Runs 1 + refinements feature towers and refinements
        correlation passes with ``t_init``, one more of each without.
        """
        def to_batch(x):
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            return x if x.dim() == 4 else x[None]

        img_i, img_j = to_batch(img_i), to_batch(img_j)
        pyr_i = self.model._pyramid(img_i)
        if t_init is None:
            cur = self._relative(self.model._pyramid(img_j), pyr_i)
        else:
            cur = np.asarray(t_init, dtype=np.float64).copy()
        for _ in range(refinements):
            m = torch.as_tensor(cur, dtype=torch.float32, device=self.device)
            warped = self._warp_project(img_j, m)
            cur = self._relative(self.model._pyramid(warped), pyr_i) @ cur
        return cur

    @torch.no_grad()
    def push(self, points: np.ndarray):
        """points: (N, 3) new scan.  Returns (q (4,), t (3,)) numpy: the pose
        of this frame w.r.t. the previous one (the first frame pairs with
        itself)."""
        proj = self.project_scan(points)
        pyr = self.model._pyramid(proj)
        prev = pyr if self._prev is None else self._prev
        out = self.model.forward_from_pyramids(pyr, prev)
        self._prev = pyr
        self.last_projection = proj
        return out["q"][0][0].cpu().numpy(), out["t"][0][0].cpu().numpy()
