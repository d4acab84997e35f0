"""Train and eval steps.

Port of ``efficientlo_net_tpu/training/step.py``: one step preprocesses and
projects both frames on the device (or, host-projected, takes the images
the loader projected), runs the network with its two towers, takes the
multi-level loss, back-propagates and updates the network and the loss
weights.  PyTorch runs it eagerly; the JAX package
jits it into one program.  ``make_streaming_eval_fns`` splits the eval step
into a per-frame encoder and a per-pair correlation, for sequence
evaluation.

Spans (``utils.profiling``): ``train.step`` (its id the state's step) with
``train.inputs``, ``train.forward``, ``train.loss``, ``train.backward`` and
``train.optimizer``; ``eval.encode`` and ``eval.correlate`` in the streaming
steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, SensorConfig, TrainConfig
from ..data.loader import POINT_QUANT_SCALE
from ..models.layers import data_parallel
from ..models.losses import total_loss
from ..models.preprocess import gt_quat, preprocess
from ..ops.projection import crop_and_project, project_to_range_image
from ..parallel.distributed import all_reduce_
from ..utils.profiling import span
from .state import TrainState, bn_momentum_schedule, lr_schedule

BATCH_KEYS = ("pc1", "pc2", "T_gt", "T_trans", "T_trans_inv", "aug_frame")
PROJECTED_KEYS = ("p1", "p2", "T_gt", "T_trans", "T_trans_inv", "aug_frame")


def dequantize(points: torch.Tensor) -> torch.Tensor:
    """int16 clouds or images (quantized transfer) to float32 metres; float
    ones pass through."""
    if points.is_floating_point():
        return points
    return points.to(torch.float32) * float(np.float32(1.0 / POINT_QUANT_SCALE))


def _forward_inputs(batch: Dict, sensor: SensorConfig, device):
    """Preprocess and project both frames on ``device``: returns (p1, p2
    (B, H, W, 3), q_gt (B, 4), t_gt (B, 3)).  int16 clouds (quantized
    transfer) are dequantized first.  The projections carry no gradient."""
    b = {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
    pc1, pc2 = dequantize(b["pc1"]), dequantize(b["pc2"])
    pc1, pc2, q_gt, t_gt = preprocess(
        pc1, pc2, b["T_gt"], b["T_trans"], b["T_trans_inv"], b["aug_frame"],
        max_planar_radius=sensor.max_planar_radius,
    )
    h, w = sensor.height, sensor.width
    # packed is safe here: preprocess() has already cropped to <= 35 m
    p1, _ = project_to_range_image(pc1, None, h, w, sensor, method="packed")
    p2, _ = project_to_range_image(pc2, None, h, w, sensor, method="packed")
    return p1.detach(), p2.detach(), q_gt, t_gt


def _forward_inputs_projected(batch: Dict, device):
    """Inputs of the host-projected step (``data/host_preprocess.py``): the
    images (B, H, W, 3) arrive cropped, perturbed and projected; int16
    images (quantized transfer) are dequantized, and only the ground truth
    is derived here, on ``device``.  The images carry no gradient."""
    b = {k: torch.as_tensor(batch[k], device=device) for k in PROJECTED_KEYS}
    p1, p2 = dequantize(b["p1"]), dequantize(b["p2"])
    q_gt, t_gt = gt_quat(b["T_gt"], b["T_trans"], b["T_trans_inv"], b["aug_frame"])
    return p1.detach(), p2.detach(), q_gt, t_gt


def _average_over(group, tensors) -> None:
    """Every tensor of ``tensors`` replaced, in place, by its mean over the
    ranks of ``group``: one all-reduce of them all, flattened."""
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), group)
    flat /= torch.distributed.get_world_size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, host_projected: bool = False,
                    data_group=None):
    """Returns ``train_step(state, batch, generator, stage=None) -> (state,
    metrics)``: one update of ``state`` (in place) on ``batch`` (numpy
    arrays or tensors, ``BATCH_KEYS``; with ``host_projected``, the
    loader's projected batch, ``PROJECTED_KEYS``).  ``generator`` (a
    ``torch.Generator`` on the state's device) draws the dropout masks and
    the scan permutations of every first-K select.  ``stage(name)``, if given, is
    called after each of "inputs", "forward", "backward" and "optimizer".

    ``data_group`` (a process group; see
    ``parallel.data_parallel.make_sharded_train_step``) makes the step this
    rank's share of a data-parallel step over ``batch``, its rows of the
    global batch: batch statistics and dropout masks span the group, and the
    gradients (the network's, ``w_x`` and ``w_q``) and the metrics are
    averaged over it before the update, so every rank makes the same update.
    Every rank must pass a generator seeded alike.  With one rank the step
    computes what the single-process step does, bit for bit."""
    lr_at = lr_schedule(train_cfg)
    bn_at = bn_momentum_schedule(train_cfg)

    def train_step(state: TrainState, batch: Dict, generator: torch.Generator,
                   stage: Optional[Callable[[str], None]] = None):
        with span("train.step", id=state.step):
            return _train_step(state, batch, generator, stage or (lambda name: None))

    def _train_step(state, batch, generator, mark):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.inputs"):
            if host_projected:
                p1, p2, q_gt, t_gt = _forward_inputs_projected(batch, state.device)
            else:
                p1, p2, q_gt, t_gt = _forward_inputs(batch, model_cfg.sensor, state.device)
        mark("inputs")
        with span("train.forward"):
            # the decay as a float32 scalar, as the JAX package traces it
            bn_momentum = torch.tensor(bn_at(state.step), dtype=torch.float32,
                                       device=state.device)
            with data_parallel(data_group):
                out = model(p1, p2, bn_momentum=bn_momentum, stochastic=True,
                            generator=generator)
        with span("train.loss"):
            loss, metrics = total_loss(out, q_gt, t_gt, state.w_x, state.w_q)
        mark("forward")
        with span("train.backward"):
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if data_group is not None:
                _average_over(data_group, [p.grad for p in state.parameters()])
                _average_over(data_group, list(metrics.values()))
        mark("backward")
        with span("train.optimizer"):
            for group in state.optimizer.param_groups:
                group["lr"] = lr_at(state.step)
            state.optimizer.step()
            state.step += 1
        mark("optimizer")
        return state, metrics

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


def make_streaming_eval_fns(model_cfg: ModelConfig):
    """(encode_step, correlate_step) for pyramid-cached sequence evaluation.

    With identity augmentation the eval preprocessing is the validity mask
    and the 35 m crop, which is per frame: so each frame is projected and
    encoded once (``encode_step(model, points)``: points (B, N, 3), float or
    int16, on any device -> the pyramid) and consecutive pyramids are
    correlated (``correlate_step(model, pyr_new, pyr_prev)`` -> the l0 {"q",
    "t"}), as the stream does.  Eval-mode towers are deterministic, so the
    poses are those of ``make_eval_step`` on the same pairs."""
    sensor = model_cfg.sensor

    @torch.no_grad()
    def encode_step(model, points):
        with span("eval.encode"):
            model.eval()
            device = next(model.parameters()).device
            points = dequantize(torch.as_tensor(points, device=device))
            return model._pyramid(crop_and_project(points, sensor))

    @torch.no_grad()
    def correlate_step(model, pyr_new, pyr_prev):
        with span("eval.correlate"):
            model.eval()
            out = model.forward_from_pyramids(pyr_new, pyr_prev)
            return {"q": out["q"][0], "t": out["t"][0]}

    return encode_step, correlate_step


def identity_batch_fields(batch_size: int) -> Dict[str, np.ndarray]:
    """Eval-mode placeholders: identity augmentation."""
    eye = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
    return {
        "T_trans": eye,
        "T_trans_inv": eye.copy(),
        "aug_frame": np.ones((batch_size,), dtype=np.int32),
    }
