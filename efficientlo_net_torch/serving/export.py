"""Model export for deployment: ``torch.export`` inference artifacts.

Port of ``efficientlo_net_tpu/serving/export.py``.  The whole odometry
inference function (validity mask, planar crop, packed projection of both
scans, the eval-mode forward) is exported with ``torch.export`` into one
``.pt2`` file with the weights inside and static shapes (batch size and point
count are fixed at export time).

* ``device="cuda"``: the graph calls the ``efficientlo::window_select``,
  ``efficientlo::select_and_group`` and ``efficientlo::bn_relu`` operators,
  so it runs the Hopper kernels.  Loading it needs this package's operators
  registered (``load_odometry`` imports them); the JAX package's TPU artifact
  needs nothing.
* ``device="cpu"``: traced under ``neighbors.plain_selects()``, so the graph
  holds plain PyTorch operations only and loads in bare PyTorch, the
  counterpart of the JAX package's portable artifact.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..ops import neighbors as nbr
from ..ops.projection import crop_and_project

FILE_SUFFIX = ".pt2"


def make_infer_fn(model, cfg: ModelConfig):
    """The production odometry inference path as a function of two raw scans
    (B, N, 3): the validity mask and the planar crop (as ``OdometryStream``
    applies them), the packed projection of both frames, the eval-mode
    forward; returns the finest-level (l0) pose ``(q (B, 4), t (B, 3))``.
    Puts ``model`` in eval mode."""
    model.eval()

    def infer(pc1: torch.Tensor, pc2: torch.Tensor):
        out = model(crop_and_project(pc1, cfg.sensor), crop_and_project(pc2, cfg.sensor))
        return out["q"][0], out["t"][0]

    return infer


class _Odometry(nn.Module):
    """``make_infer_fn`` as a module, for ``torch.export``."""

    def __init__(self, model, cfg: ModelConfig):
        super().__init__()
        self.model = model
        self.infer = make_infer_fn(model, cfg)

    def forward(self, pc1, pc2):
        return self.infer(pc1, pc2)


def export_odometry(model, cfg: ModelConfig, batch_size: int = 1,
                    num_points: Optional[int] = None, device="cuda"):
    """``torch.export`` of the inference function of ``model`` (a
    ``PWCLONet`` with its weights) for scans of (``batch_size``,
    ``num_points``, 3) float32 on ``device``; ``num_points`` defaults to the
    sensor's padded scan size.  Moves ``model`` to ``device``.  Returns the
    ``ExportedProgram``; write it with ``save_artifact``."""
    dev = resolve_device(device)
    n = num_points or cfg.sensor.num_points
    example = torch.zeros((batch_size, n, 3), dtype=torch.float32, device=dev)
    module = _Odometry(model.to(dev), cfg)
    portable = dev.type == "cpu"
    with torch.no_grad(), nbr.plain_selects() if portable else contextlib.nullcontext():
        return torch.export.export(module, (example, example.clone()), strict=False)


def save_artifact(path: str, exported) -> str:
    """Write an ``ExportedProgram`` to ``path`` (``.pt2`` appended if
    missing); returns the path."""
    if not path.endswith(FILE_SUFFIX):
        path = path + FILE_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return path


def load_odometry(path) -> Tuple[object, callable]:
    """Load an artifact; returns ``(exported, call)`` where ``call(pc1, pc2)
    -> (q, t)`` takes numpy arrays or tensors and runs on the device the
    artifact was exported for."""
    from ..ops import bn_relu, window_select  # noqa: F401  (register a card artifact's operators)

    exported = torch.export.load(path)
    module = exported.module()
    device = next(iter(exported.state_dict.values())).device

    def call(pc1, pc2):
        with torch.no_grad():
            return module(torch.as_tensor(pc1, dtype=torch.float32, device=device),
                          torch.as_tensor(pc2, dtype=torch.float32, device=device))

    return exported, call
