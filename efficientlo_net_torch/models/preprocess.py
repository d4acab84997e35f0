"""Batched preprocessing: validity masking, the planar crop, the SE(3)
augmentation of one frame, and the ground truth as (q, t).

Port of ``efficientlo_net_tpu/models/preprocess.py``.
"""

from __future__ import annotations

import torch

from ..ops import quaternion as Q


def _crop(pc, max_planar_radius):
    """Points (B, N, 3) with invalid (all-zero) and cropped points zeroed,
    and the (B, N, 1) keep mask."""
    valid = torch.any(pc != 0.0, dim=-1)
    keep = (valid & (torch.linalg.vector_norm(pc[..., :2], dim=-1) <= max_planar_radius))[..., None]
    return pc * keep, keep


def preprocess(pc_f1, pc_f2, T_gt, T_trans, T_trans_inv, aug_frame, max_planar_radius=35.0):
    """Args:
      pc_f1, pc_f2: (B, N, 3) raw padded clouds (frame 1 = later frame).
      T_gt: (B, 4, 4) ground-truth relative transform.
      T_trans / T_trans_inv: (B, 4, 4) augmentation perturbation (identity at
        eval).
      aug_frame: (B,) int, 1 or 2: which frame receives the perturbation.

    Returns (pc1_aug, pc2_aug, q_gt, t_gt) with invalid or cropped points at
    exactly (0, 0, 0).
    """
    pc1, keep1 = _crop(pc_f1, max_planar_radius)
    pc2, keep2 = _crop(pc_f2, max_planar_radius)
    pc1_t = Q.transform_points(T_trans, pc1) * keep1
    pc2_t = Q.transform_points(T_trans, pc2) * keep2

    aug1 = (aug_frame == 1)[:, None, None]
    pc1_aug = torch.where(aug1, pc1_t, pc1)
    pc2_aug = torch.where(aug1, pc2, pc2_t)
    q_gt, t_gt = gt_quat(T_gt, T_trans, T_trans_inv, aug_frame)
    return pc1_aug, pc2_aug, q_gt, t_gt


def gt_quat(T_gt, T_trans, T_trans_inv, aug_frame):
    """Augmentation-adjusted ground truth as (q_gt (B, 4), t_gt (B, 3)):
    T_gt T_trans^-1 when frame 1 was perturbed, T_trans T_gt when frame 2
    was; the rotation goes to a quaternion through zyx-Euler angles."""
    aug1 = (aug_frame == 1)[:, None, None]
    T_gt_aug = torch.where(aug1, T_gt @ T_trans_inv, T_trans @ T_gt)
    return Q.mat_to_quat(T_gt_aug[:, :3, :3]), T_gt_aug[:, :3, 3]
