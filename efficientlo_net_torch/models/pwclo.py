"""PWCLO-Net: pyramid / warping / cost-volume LiDAR odometry network.

Port of ``efficientlo_net_tpu/models/pwclo.py``: a 4-level Siamese set-conv
pyramid over the cylindrical range image, a coarse attentive cost volume
regressing an initial pose, and three warp-refinement levels.  Full HDL-64
level shapes: 64x1800 -> l0 16x225 -> l1 8x113 -> l2 4x57 -> l3 4x29.
Submodule names follow the JAX package's Flax names.

The mode is the module's ``training`` flag.  Randomness comes from an
explicit ``torch.Generator`` on the model's device: in training the pose
heads' dropout masks, and, with ``stochastic=True``, a fresh scan-order
permutation at every first-K select (the JAX package's ``neighbor`` and
``dropout`` streams; the two give different numbers from one seed).

``cfg.compute_dtype`` sets the dtype of every MLP stack (bfloat16 or
float32); the pose heads stay float32 and the parameters are float32 either
way, so one set of weights serves both.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import quaternion as Q
from ..ops.projection import project_to_range_image
from ..parallel.ring import ring_select_and_group_replicated
from .layers import (
    CostVolume,
    DownConv,
    FlowPredictor,
    Head1x1,
    UpConv,
    data_shard,
    softmax_valid,
    valid_mask_from_xyz,
)


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Flax's ``nn.Dropout`` in training: keep each value with probability
    1 - rate and scale it by 1 / (1 - rate); rate 0 is the identity.  In a
    data-parallel step (``layers.data_shard``) the mask is drawn for the
    global batch and this rank keeps its rows, so the step draws what one
    process would."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep_prob = 1.0 - rate
    shard = data_shard()
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    else:
        index, count = shard
        rows = x.shape[0]
        keep = torch.rand((rows * count,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)[index * rows:(index + 1) * rows] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class PoseHead(nn.Module):
    """conv1d(head_dim) -> dropout (training only) -> {q head (normalized),
    t head}."""

    def __init__(self, in_features: int, head_dim: int, dropout_rate: float):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.big = Head1x1(in_features, head_dim)
        self.q_head = Head1x1(head_dim, 4)
        self.t_head = Head1x1(head_dim, 3)

    def forward(self, feat_b1c, generator=None):
        x = self.big(feat_b1c)
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        q = Q.qnormalize(self.q_head(x))
        t = self.t_head(x)
        return q[:, 0, :], t[:, 0, :]  # (B, 4), (B, 3)


class PWCLONet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        shapes = cfg.level_shapes
        strides = list(zip(cfg.stride_h, cfg.stride_w))
        feat_c = [m[-1] for m in cfg.down_mlps]  # l0..l3 feature channels
        cv_c = cfg.cv_mlp1[-1]
        pred_c = cfg.predictor_mlp[-1]
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        # Siamese pyramid: one module per level, applied to both frames.
        in_c = [3] + feat_c[:3]  # level 0 gets zero features of width 3
        self.down_strides = [strides[i + 2] for i in range(4)]
        self.down_layers = []
        for i in range(4):
            layer = DownConv(in_c[i], cfg.down_kernels[i], cfg.down_K[i],
                             cfg.down_conv_dis[i], cfg.down_mlps[i], shapes[i + 2], dtype)
            self.add_module(f"down_l{i}", layer)
            self.down_layers.append(layer)

        # Coarse correlation at l2 + pooling down_conv to l3.
        self.cv_origin = CostVolume(
            feat_c[2], feat_c[2], cfg.cv_kernel1, cfg.cv_kernel2[3], cfg.cv_nsample,
            cfg.cv_nsample_q[3], cfg.cost_volume_dis[2], cfg.cv_mlp1, cfg.cv_mlp2, dtype,
        )
        self.cv_down_l3 = DownConv(cv_c, cfg.down_kernels[3], cfg.down_K[3],
                                   cfg.down_conv_dis[3], cfg.cv_down_mlp, shapes[5], dtype)
        l3_pred_c = cfg.cv_down_mlp[-1]
        self.l3_w_predictor = FlowPredictor(feat_c[3] + l3_pred_c, cfg.predictor_mlp, dtype)
        self.l3_head = PoseHead(l3_pred_c, cfg.head_dim, cfg.dropout_rate)

        # Warp-refinement levels l2, l1, l0; up_conv strides map level i to
        # level i+1's grid.
        self.refine = []
        for i in range(3):
            coarse_w = pred_c
            coarse_pred = l3_pred_c if i == 2 else pred_c
            parts = {
                "cv": CostVolume(feat_c[i], feat_c[i], cfg.cv_kernel1, cfg.cv_kernel2[i],
                                 cfg.cv_nsample, cfg.cv_nsample_q[i], cfg.cost_volume_dis[i],
                                 cfg.cv_mlp1, cfg.cv_mlp2, dtype),
                "up_w": UpConv(feat_c[i], coarse_w, cfg.up_kernel, cfg.up_nsample,
                               cfg.up_conv_dis[i], strides[i + 3], cfg.up_mlp1, cfg.up_mlp2,
                               dtype),
                "up_feat": UpConv(feat_c[i], coarse_pred, cfg.up_kernel, cfg.up_nsample,
                                  cfg.up_conv_dis[i], strides[i + 3], cfg.up_mlp1,
                                  cfg.up_mlp2, dtype),
                "pred_feat": FlowPredictor(feat_c[i] + cfg.up_mlp2[-1] + cv_c,
                                           cfg.predictor_mlp, dtype),
                "pred_w": FlowPredictor(feat_c[i] + cfg.up_mlp2[-1] + cv_c,
                                        cfg.predictor_mlp, dtype),
                "head": PoseHead(pred_c, cfg.head_dim, cfg.dropout_rate),
            }
            for name, module in parts.items():
                self.add_module(f"{name}_l{i}", module)
            self.refine.append(parts)

    @staticmethod
    def _perm(kernel_size, stochastic: bool, generator):
        """Scan-order permutation of a first-K select: a fresh one from
        ``generator`` at every call when ``stochastic``, else None (scan
        order)."""
        if not stochastic:
            return None
        if generator is None:
            raise ValueError("stochastic=True needs a torch.Generator")
        t = kernel_size[0] * kernel_size[1]
        return torch.randperm(t, generator=generator, device=generator.device)

    def _pyramid(self, xyz_proj, bn_momentum=0.99, stochastic=False, generator=None,
                 ring_group=None):
        """Four down_convs for one (batch of) frame(s); returns per-level
        (xyz_proj, feat, feat_proj).  With ``ring_group`` (a ``DeviceMesh``
        with a "ring" dimension, or the ring's process group) the
        full-resolution level-0 select, by far the heaviest, runs W-axis
        ring-sharded (``parallel/ring.py``), its groups gathered back; the
        coarser levels are small and stay replicated."""
        cfg = self.cfg
        shapes = cfg.level_shapes
        feats = []
        cur_xyz = xyz_proj
        cur_feat_proj = torch.zeros_like(xyz_proj)  # zero input features
        for i, layer in enumerate(self.down_layers):
            perm = self._perm(cfg.down_kernels[i], stochastic, generator)
            select_fn = None
            if ring_group is not None and i == 0:
                select_fn = functools.partial(ring_select_and_group_replicated, mesh=ring_group)
            feat, new_xyz = layer(cur_xyz, cur_feat_proj, self.down_strides[i], perm, bn_momentum,
                                  select_fn=select_fn)
            h, w = shapes[i + 2]
            feat_proj = feat.reshape(feat.shape[0], h, w, feat.shape[-1])
            feats.append((new_xyz, feat, feat_proj))
            cur_xyz, cur_feat_proj = new_xyz, feat_proj
        return feats

    def _warp(self, xyz_proj, q, t):
        """Rigidly move level points by the accumulated pose, masking invalid
        points."""
        b, h, w, _ = xyz_proj.shape
        xyz = xyz_proj.reshape(b, h * w, 3)
        mask = valid_mask_from_xyz(xyz)[..., None]
        return (Q.qrotate(q, xyz) + t[:, None, :]) * mask

    def forward(self, proj_f1: torch.Tensor, proj_f2: torch.Tensor, bn_momentum=0.99,
                stochastic: bool = False, generator: Optional[torch.Generator] = None,
                ring_group=None) -> Dict[str, Any]:
        """Both frames' range images (B, H, W, 3) -> {"q": [l0..l3], "t": ...}.

        In eval the Siamese tower runs once on the merged 2B batch (eval-mode
        batch norm and every pyramid op are independent across the batch).
        In training it runs twice, frame 1 then frame 2: batch statistics
        over a merged 2B batch would differ, and the shared layers update
        their running statistics once per frame, in that order.
        ``ring_group`` (eval only) ring-shards the level-0 select, see
        ``_pyramid``; every rank of the ring passes both whole frames and
        gets the whole output."""
        kw = dict(bn_momentum=bn_momentum, stochastic=stochastic, generator=generator)
        if self.training:
            if ring_group is not None:
                raise NotImplementedError(
                    "the W-axis ring in training needs the backward of the halo exchange "
                    "and of the sector gather (ROADMAP.md, Queue 1: the ring in training)")
            f1 = self._pyramid(proj_f1, **kw)
            f2 = self._pyramid(proj_f2, **kw)
        else:
            b = proj_f1.shape[0]
            fb = self._pyramid(torch.cat([proj_f1, proj_f2], dim=0), ring_group=ring_group, **kw)
            f1 = [tuple(t[:b] for t in lvl) for lvl in fb]
            f2 = [tuple(t[b:] for t in lvl) for lvl in fb]
        return self.forward_from_pyramids(f1, f2, **kw)

    def forward_from_pyramids(self, f1, f2, bn_momentum=0.99, stochastic: bool = False,
                              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Correlation + warp-refinement on precomputed feature pyramids
        (a stream caches each frame's pyramid and pairs it with the next)."""
        cfg = self.cfg
        shapes = cfg.level_shapes
        b = f1[0][0].shape[0]

        (l0_xyz1, l0_feat1, _) = f1[0]
        (l1_xyz1, l1_feat1, _) = f1[1]
        (l2_xyz1, l2_feat1, l2_fp1) = f1[2]
        (l3_xyz1, l3_feat1, _) = f1[3]
        (l0_xyz2, _, l0_fp2) = f2[0]
        (l1_xyz2, _, l1_fp2) = f2[1]
        (l2_xyz2, _, l2_fp2) = f2[2]

        def perm(kernel_size):
            return self._perm(kernel_size, stochastic, generator)

        m = bn_momentum
        # ---- coarse level l3 -------------------------------------------
        cv = self.cv_origin(l2_xyz1, l2_xyz2, l2_fp1, l2_fp2, perm(cfg.cv_kernel1), m)
        h2, w2 = shapes[4]
        cv_proj = cv.reshape(b, h2, w2, cv.shape[-1])
        l3_predict, _ = self.cv_down_l3(l2_xyz1, cv_proj, self.down_strides[3],
                                        perm(cfg.down_kernels[3]), m)

        h3, w3 = shapes[5]
        l3_predict_proj = l3_predict.reshape(b, h3, w3, -1)
        l3_w = self.l3_w_predictor([l3_feat1, l3_predict], m)
        l3_w_proj = l3_w.reshape(b, h3, w3, -1)

        l3_mask = valid_mask_from_xyz(l3_xyz1.reshape(b, h3 * w3, 3))
        l3_q, l3_t = self.l3_head(softmax_valid(l3_predict, l3_w, l3_mask), generator)

        # ---- warp-refinement l2 -> l1 -> l0 ----------------------------
        level_data = [
            (2, l2_xyz1, l2_feat1, l2_fp2, l2_xyz2, shapes[4]),
            (1, l1_xyz1, l1_feat1, l1_fp2, l1_xyz2, shapes[3]),
            (0, l0_xyz1, l0_feat1, l0_fp2, l0_xyz2, shapes[2]),
        ]
        q_coarse, t_coarse = l3_q, l3_t
        coarser_xyz_proj = l3_xyz1  # source grid for the up_convs
        coarser_w_proj = l3_w_proj
        coarser_predict_proj = l3_predict_proj
        qs, ts = [None, None, None, l3_q], [None, None, None, l3_t]

        for li, xyz1_proj, feat1, fp2, xyz2_proj, (hl, wl) in level_data:
            parts = self.refine[li]
            warped = self._warp(xyz1_proj, q_coarse, t_coarse)  # (B, N, 3)
            # warped points derive from the 35 m-cropped input: packed is
            # safe.  Gradients flow through the gather of the winners into
            # the coarser level's (q, t).
            xyz_warp_proj, feat_warp_proj = project_to_range_image(
                warped, feat1, hl, wl, cfg.sensor, method="packed"
            )
            feat_warp = feat_warp_proj.reshape(b, hl * wl, -1)
            mask_warp = valid_mask_from_xyz(xyz_warp_proj.reshape(b, hl * wl, 3))

            cv_l = parts["cv"](xyz_warp_proj, xyz2_proj, feat_warp_proj, fp2,
                               perm(cfg.cv_kernel1), m)
            up_w = parts["up_w"](xyz_warp_proj, coarser_xyz_proj, feat_warp, coarser_w_proj,
                                 perm(cfg.up_kernel), m)
            up_feat = parts["up_feat"](xyz_warp_proj, coarser_xyz_proj, feat_warp,
                                       coarser_predict_proj, perm(cfg.up_kernel), m)
            predict = parts["pred_feat"]([feat_warp, up_feat, cv_l], m)
            w = parts["pred_w"]([feat_warp, up_w, cv_l], m)

            q_det, t_det = parts["head"](softmax_valid(predict, w, mask_warp), generator)
            q_new, t_new = Q.compose_pose(q_det, t_det, q_coarse, t_coarse)

            qs[li], ts[li] = q_new, t_new
            q_coarse, t_coarse = q_new, t_new
            coarser_xyz_proj = xyz_warp_proj
            coarser_w_proj = w.reshape(b, hl, wl, -1)
            coarser_predict_proj = predict.reshape(b, hl, wl, -1)

        return {"q": [Q.qnormalize(q) for q in qs], "t": ts}  # [l0, l1, l2, l3]
