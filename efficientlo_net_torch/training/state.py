"""Train state, schedules and optimizer.

Port of ``efficientlo_net_tpu/training/state.py`` in PyTorch idiom: the state
holds the network (parameters and batch-norm buffers), the trainable loss
weights ``w_x``/``w_q``, a ``torch.optim`` optimizer over all of them, and
the count of updates made.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..config import TrainConfig
from ..device import resolve_device


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate of the update after ``step`` earlier ones
    (``TrainConfig.learning_rate``)."""
    return cfg.learning_rate


def bn_momentum_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Batch-norm EMA decay at ``step`` (``TrainConfig.bn_momentum``)."""
    return cfg.bn_momentum


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam (the update of ``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 added
    to the bias-corrected root) or SGD with heavy-ball momentum and no
    dampening (``optax.sgd(momentum=...)``).  The learning rate is set
    before each update from ``lr_schedule``."""
    lr = lr_schedule(cfg)(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum, dampening=0.0)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    w_x: nn.Parameter
    w_q: nn.Parameter
    optimizer: torch.optim.Optimizer
    step: int = 0  # updates made so far (optax's count)

    @property
    def device(self) -> torch.device:
        return self.w_x.device

    def parameters(self):
        """Every trained tensor: the network's parameters, then w_x, w_q."""
        return [*self.model.parameters(), self.w_x, self.w_q]


def create_train_state(model: nn.Module, train_cfg: TrainConfig, device="cuda",
                       w_x: Optional[float] = None, w_q: Optional[float] = None) -> TrainState:
    """Move ``model`` (a ``PWCLONet``, freshly initialized or loaded) to
    ``device`` in training mode and make its optimizer.  ``w_x``/``w_q``
    default to the config's initial values (an artifact carries none)."""
    dev = resolve_device(device)
    model = model.to(dev).train()

    def scalar(value):
        return nn.Parameter(torch.tensor(float(value), dtype=torch.float32, device=dev))

    w_x = scalar(train_cfg.w_x_init if w_x is None else w_x)
    w_q = scalar(train_cfg.w_q_init if w_q is None else w_q)
    optimizer = make_optimizer(train_cfg, [*model.parameters(), w_x, w_q])
    return TrainState(model=model, w_x=w_x, w_q=w_q, optimizer=optimizer)
