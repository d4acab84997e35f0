"""Multi-level supervised pose loss with learned homoscedastic weights.

Port of ``efficientlo_net_tpu/models/losses.py``:
  per level:  L = mean|t - t_gt| * e^{-w_x} + w_x
              + mean‖q_gt - q/‖q‖‖₂ * e^{-w_q} + w_q
  total:      1.6 L3 + 0.8 L2 + 0.4 L1 + 0.2 L0   (coarsest weighted highest)
``w_x`` and ``w_q`` are trainable scalars.
"""

from __future__ import annotations

import torch

from ..ops import quaternion as Q

LEVEL_WEIGHTS = (0.2, 0.4, 0.8, 1.6)  # l0, l1, l2, l3


def level_loss(q, t, q_gt, t_gt, w_x, w_q):
    dq = q_gt - Q.qnormalize(q)
    loss_q = torch.mean(torch.sqrt(torch.sum(dq * dq, dim=-1) + 1e-10))
    dt = t - t_gt
    loss_x = torch.mean(torch.sqrt(dt * dt + 1e-10))  # elementwise |.|
    return loss_x * torch.exp(-w_x) + w_x + loss_q * torch.exp(-w_q) + w_q


def total_loss(outputs, q_gt, t_gt, w_x, w_q):
    """outputs: dict with "q"/"t" lists ordered [l0, l1, l2, l3].  Returns
    (total, metrics) with the JAX package's metric keys."""
    losses = [level_loss(outputs["q"][i], outputs["t"][i], q_gt, t_gt, w_x, w_q)
              for i in range(4)]
    total = sum(w * l for w, l in zip(LEVEL_WEIGHTS, losses))
    return total, {
        "loss": total,
        "l0_loss": losses[0],
        "l1_loss": losses[1],
        "l2_loss": losses[2],
        "l3_loss": losses[3],
    }
