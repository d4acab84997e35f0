"""Streaming odometry inference: one new scan per step.

Port of ``OdometryStream`` from ``efficientlo_net_tpu/evaluation/streaming.py``
(device projection).  Each scan pairs with the previous one, whose range
image and feature pyramid were computed when it arrived, so the steady-state
cost per frame is one projection, ONE feature tower and the correlation /
refinement stages.  Eval-mode pyramids are deterministic, so the cached
pyramid equals a recomputed one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.projection import crop_and_project


class OdometryStream:
    """Emits the relative pose (q, t) of each pushed scan w.r.t. the
    previous one.  ``model`` is a ``PWCLONet`` with its weights loaded; the
    stream moves it to ``device`` and puts it in eval mode."""

    def __init__(self, model, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
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

    @torch.no_grad()
    def push(self, points: np.ndarray):
        """points: (N, 3) new scan.  Returns (q (4,), t (3,)) numpy: the pose
        of this frame w.r.t. the previous one (the first frame pairs with
        itself)."""
        pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=self.device)
        proj = self.project(pts[None])
        pyr = self.model._pyramid(proj)
        prev = pyr if self._prev is None else self._prev
        out = self.model.forward_from_pyramids(pyr, prev)
        self._prev = pyr
        self.last_projection = proj
        return out["q"][0][0].cpu().numpy(), out["t"][0][0].cpu().numpy()
