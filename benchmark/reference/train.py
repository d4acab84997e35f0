"""The reference's training steps and sequence poses.

``train_steps`` follows the first steps of a training run: the
preprocessing (crop, augmentation, ground truth as (q, t)), the packed
projection, the network in training mode, the four-level loss with learned
weights, the gradients and Adam (``torch.optim.Adam``), with the learning rate and batch-norm
decay schedules of the training configuration.  ``sequence_poses`` gives
the l0 pose of frame pairs of a sequence, from the raw scans through the
int16 quantization that sequence evaluation applies.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import ops, weights
from .net import NetConfig, Network

LEVEL_WEIGHTS = (0.2, 0.4, 0.8, 1.6)  # l0, l1, l2, l3
LOSS_KEYS = ("loss", "l0_loss", "l1_loss", "l2_loss", "l3_loss")
POINT_QUANT_SCALE = 800.0  # int16 steps of 1.25 mm


def network(config: Dict, weights_path: Path, device) -> Network:
    """The reference network of a configuration file, with the weights of
    ``weights_path``, on ``device``."""
    net = Network(NetConfig.from_dicts(config["sensor"], config["model"]))
    net.load_state_dict(weights.state_dict(str(weights_path)), strict=True)
    return net.to(device)


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """Matrix products in TF32 while it is open, when ``on`` (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def learning_rate(hp: Dict, step: int, batch_size: int) -> float:
    """Staircase exponential decay on samples seen, floored."""
    samples = step * batch_size
    lr = hp["base_learning_rate"] * hp["lr_decay_rate"] ** (samples // hp["lr_decay_step"])
    return max(lr, hp["lr_floor"])


def bn_decay(hp: Dict, step: int, batch_size: int) -> float:
    samples = step * batch_size
    mom = hp["bn_init_decay"] * hp["bn_decay_rate"] ** (samples // hp["bn_decay_step"])
    return min(hp["bn_decay_clip"], 1.0 - mom)


def inputs(batch: Dict, sensor: Dict, device):
    """(p1, p2 range images, q_gt, t_gt) of a host batch: both frames
    cropped, the augmentation applied to the frame ``aug_frame`` names,
    projected; the ground truth adjusted for the augmentation."""
    b = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
    pc1, keep1 = ops.crop(b["pc1"], sensor["max_planar_radius"])
    pc2, keep2 = ops.crop(b["pc2"], sensor["max_planar_radius"])
    pc1_t = ops.transform_points(b["T_trans"], pc1) * keep1
    pc2_t = ops.transform_points(b["T_trans"], pc2) * keep2
    aug1 = (b["aug_frame"] == 1)[:, None, None]
    pc1, pc2 = torch.where(aug1, pc1_t, pc1), torch.where(aug1, pc2, pc2_t)
    T = torch.where(aug1, b["T_gt"] @ b["T_trans_inv"], b["T_trans"] @ b["T_gt"])
    h, w = sensor["height"], sensor["width"]
    p1, _ = ops.project(pc1, None, h, w, sensor)
    p2, _ = ops.project(pc2, None, h, w, sensor)
    return p1, p2, ops.mat_to_quat(T[:, :3, :3]), T[:, :3, 3]


def level_loss(q, t, q_gt, t_gt, w_x, w_q):
    dq = q_gt - ops.qnormalize(q)
    loss_q = torch.mean(torch.sqrt(torch.sum(dq * dq, dim=-1) + 1e-10))
    dt = t - t_gt
    loss_x = torch.mean(torch.sqrt(dt * dt + 1e-10))
    return loss_x * torch.exp(-w_x) + w_x + loss_q * torch.exp(-w_q) + w_q


def total_loss(out, q_gt, t_gt, w_x, w_q):
    losses = [level_loss(out["q"][i], out["t"][i], q_gt, t_gt, w_x, w_q) for i in range(4)]
    total = sum(w * l for w, l in zip(LEVEL_WEIGHTS, losses))
    return total, dict(zip(LOSS_KEYS, [total] + losses))


def train_steps(net: Network, batches: Sequence[Dict], generator: torch.Generator, hp: Dict,
                batch_size: int, device) -> Dict:
    """One training step on each of ``batches``, from the weights ``net``
    holds.  Returns the losses of every step ({key: [per step]}), the first
    step's gradients, and each parameter's and statistic's change over all
    the steps, by name."""
    net.train()
    names = [n for n, _ in net.named_parameters()] + ["w_x", "w_q"]
    w_x = torch.nn.Parameter(torch.tensor(float(hp["w_x_init"]), device=device))
    w_q = torch.nn.Parameter(torch.tensor(float(hp["w_q_init"]), device=device))
    params = [*net.parameters(), w_x, w_q]
    before = {n: p.detach().clone() for n, p in zip(names, params)}
    before.update({n: b.clone() for n, b in net.named_buffers()})
    adam = torch.optim.Adam(params, lr=learning_rate(hp, 0, batch_size),
                            betas=(hp["adam_b1"], hp["adam_b2"]), eps=hp["adam_eps"])
    losses: Dict[str, List[float]] = {k: [] for k in LOSS_KEYS}
    first_grad = None
    for step, batch in enumerate(batches):
        for p in params:
            p.grad = None
        p1, p2, q_gt, t_gt = inputs(batch, net.cfg.sensor, device)
        m = torch.tensor(bn_decay(hp, step, batch_size), dtype=torch.float32, device=device)
        out = net(p1, p2, m, generator)
        loss, metrics = total_loss(out, q_gt, t_gt, w_x, w_q)
        loss.backward()
        for k in LOSS_KEYS:
            losses[k].append(float(metrics[k].detach()))
        if first_grad is None:
            first_grad = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        for group in adam.param_groups:
            group["lr"] = learning_rate(hp, step, batch_size)
        adam.step()
    after = {n: p.detach() for n, p in zip(names, params)}
    after.update(dict(net.named_buffers()))
    return {"losses": losses, "first_grad": first_grad,
            "change": {n: after[n] - before[n] for n in before}}


def dequantized(scans: np.ndarray) -> np.ndarray:
    """Scans as sequence evaluation sends them: int16 steps of 1.25 mm,
    back to float32 metres."""
    q = np.clip(np.rint(scans * POINT_QUANT_SCALE), -32767, 32767).astype(np.int16)
    return q.astype(np.float32) * np.float32(1.0 / POINT_QUANT_SCALE)


@torch.no_grad()
def sequence_poses(net: Network, scans, frames: Sequence[int], device,
                   block: int = 8) -> np.ndarray:
    """The l0 (q, t) of each frame of ``frames`` against the frame before it
    (frame 0 against itself), in eval mode, ``block`` pairs at a time:
    (len(frames), 7) rows of q then t.  ``scans(i)`` gives frame i's raw
    scan (N, 3).  A short last block is padded to ``block`` pairs: with
    ``block`` the evaluated batch, every matrix product takes the shape it
    has there, since float32 products of another shape round differently,
    and the projection and the warps can turn a last-bit difference into
    another pose."""
    net.eval()
    sensor = net.cfg.sensor
    rows = []
    for s in range(0, len(frames), block):
        chunk = list(frames[s:s + block])
        real = len(chunk)
        chunk += chunk[-1:] * (block - real)
        cur = dequantized(np.stack([scans(f) for f in chunk]))
        prev = dequantized(np.stack([scans(max(f - 1, 0)) for f in chunk]))
        images = []
        for pts in (cur, prev):
            pts, _ = ops.crop(torch.as_tensor(pts, device=device), sensor["max_planar_radius"])
            images.append(ops.project(pts, None, sensor["height"], sensor["width"], sensor)[0])
        out = net.correlate(net.pyramid(images[0]), net.pyramid(images[1]))
        rows.append(torch.cat([out["q"][0], out["t"][0]], dim=-1)[:real].cpu().numpy())
    return np.concatenate(rows).astype(np.float64)
