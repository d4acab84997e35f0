"""Train and eval steps.

Port of ``efficientlo_net_tpu/training/step.py`` (device projection): one
step preprocesses and projects both frames on the device, runs the network
with its two towers, takes the multi-level loss, back-propagates and updates
the network and the loss weights.  PyTorch runs it eagerly; the JAX package
jits it into one program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, SensorConfig, TrainConfig
from ..data.loader import POINT_QUANT_SCALE
from ..models.losses import total_loss
from ..models.preprocess import preprocess
from ..ops.projection import project_to_range_image
from .state import TrainState, bn_momentum_schedule, lr_schedule

BATCH_KEYS = ("pc1", "pc2", "T_gt", "T_trans", "T_trans_inv", "aug_frame")


def _forward_inputs(batch: Dict, sensor: SensorConfig, device):
    """Preprocess and project both frames on ``device``: returns (p1, p2
    (B, H, W, 3), q_gt (B, 4), t_gt (B, 3)).  int16 clouds (quantized
    transfer) are dequantized first.  The projections carry no gradient."""
    b = {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
    pc1, pc2 = b["pc1"], b["pc2"]
    if not pc1.is_floating_point():
        inv = float(np.float32(1.0 / POINT_QUANT_SCALE))
        pc1 = pc1.to(torch.float32) * inv
        pc2 = pc2.to(torch.float32) * inv
    pc1, pc2, q_gt, t_gt = preprocess(
        pc1, pc2, b["T_gt"], b["T_trans"], b["T_trans_inv"], b["aug_frame"],
        max_planar_radius=sensor.max_planar_radius,
    )
    h, w = sensor.height, sensor.width
    # packed is safe here: preprocess() has already cropped to <= 35 m
    p1, _ = project_to_range_image(pc1, None, h, w, sensor)
    p2, _ = project_to_range_image(pc2, None, h, w, sensor)
    return p1.detach(), p2.detach(), q_gt, t_gt


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Returns ``train_step(state, batch, generator, stage=None) -> (state,
    metrics)``: one update of ``state`` (in place) on ``batch`` (numpy
    arrays or tensors, ``BATCH_KEYS``).  ``generator`` (a ``torch.Generator``
    on the state's device) draws the dropout masks and the scan
    permutations of every first-K select.  ``stage(name)``, if given, is
    called after each of "inputs", "forward", "backward" and "optimizer"."""
    lr_at = lr_schedule(train_cfg)
    bn_at = bn_momentum_schedule(train_cfg)

    def train_step(state: TrainState, batch: Dict, generator: torch.Generator,
                   stage: Optional[Callable[[str], None]] = None):
        mark = stage or (lambda name: None)
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        p1, p2, q_gt, t_gt = _forward_inputs(batch, model_cfg.sensor, state.device)
        mark("inputs")
        # the decay as a float32 scalar, as the JAX package traces it
        bn_momentum = torch.tensor(bn_at(state.step), dtype=torch.float32, device=state.device)
        out = model(p1, p2, bn_momentum=bn_momentum, stochastic=True, generator=generator)
        loss, metrics = total_loss(out, q_gt, t_gt, state.w_x, state.w_q)
        mark("forward")
        loss.backward()
        mark("backward")
        for group in state.optimizer.param_groups:
            group["lr"] = lr_at(state.step)
        state.optimizer.step()
        state.step += 1
        mark("optimizer")
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model_cfg: ModelConfig):
    """Returns ``eval_step(model, batch)``: the finest-level (l0) pose in
    eval mode, beside the ground truth: {"q", "t", "q_gt", "t_gt"}."""

    @torch.no_grad()
    def eval_step(model, batch: Dict):
        model.eval()
        device = next(model.parameters()).device
        p1, p2, q_gt, t_gt = _forward_inputs(batch, model_cfg.sensor, device)
        out = model(p1, p2)
        return {"q": out["q"][0], "t": out["t"][0], "q_gt": q_gt, "t_gt": t_gt}

    return eval_step


def identity_batch_fields(batch_size: int) -> Dict[str, np.ndarray]:
    """Eval-mode placeholders: identity augmentation."""
    eye = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
    return {
        "T_trans": eye,
        "T_trans_inv": eye.copy(),
        "aug_frame": np.ones((batch_size,), dtype=np.int32),
    }
