"""The reference network: PWCLO-Net (Wang et al., "Efficient 3D Deep LiDAR
Odometry", TPAMI 2022) in plain PyTorch, float32.

A frozen copy of the judged program's network with the plain selects of
``ops`` in place of its kernels, and nothing else: no reduced-precision
path, no data-parallel batch statistics, no ring sharding.  Module and
parameter names are the program's, so one weights file loads into both.
The mode is the module's ``training`` flag; randomness (the scan-order
permutations of every first-K select and the pose heads' dropout) is drawn
from an explicit ``torch.Generator`` in the order the program draws it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import ops

_MASK_NEG = -1e10


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """The sensor (a dict of the sensor's fields) and the network's sizes,
    as a configuration file of the benchmark states them."""

    sensor: Dict
    stride_h: Tuple[int, ...]
    stride_w: Tuple[int, ...]
    down_conv_dis: Tuple[float, ...]
    up_conv_dis: Tuple[float, ...]
    cost_volume_dis: Tuple[float, ...]
    down_kernels: Tuple
    down_K: Tuple[int, ...]
    down_mlps: Tuple
    cv_kernel1: Tuple[int, int]
    cv_kernel2: Tuple
    cv_nsample: int
    cv_nsample_q: Tuple[int, ...]
    cv_mlp1: Tuple[int, ...]
    cv_mlp2: Tuple[int, ...]
    cv_down_mlp: Tuple[int, ...]
    up_kernel: Tuple[int, int]
    up_nsample: int
    up_mlp1: Tuple[int, ...]
    up_mlp2: Tuple[int, ...]
    predictor_mlp: Tuple[int, ...]
    head_dim: int
    dropout_rate: float

    @classmethod
    def from_dicts(cls, sensor: Dict, model: Dict) -> "NetConfig":
        names = {f.name for f in dataclasses.fields(cls)} - {"sensor"}
        return cls(sensor=dict(sensor), **{k: _tuples(v) for k, v in model.items() if k in names})

    @property
    def level_shapes(self):
        """(H, W) of [pre1, pre2, l0, l1, l2, l3]: ceil division by the
        strides, level by level."""
        h, w = self.sensor["height"], self.sensor["width"]
        shapes = []
        for sh, sw in zip(self.stride_h, self.stride_w):
            h, w = -(-h // sh), -(-w // sw)
            shapes.append((h, w))
        return tuple(shapes)


class BatchNorm(nn.Module):
    """Batch norm over every axis but the last, eps 1e-3; in training the
    batch mean and biased variance, and running = m * running + (1 - m) *
    batch with the decay m of the call."""

    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, momentum):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.var(x, dim=axes, correction=0)
            with torch.no_grad():
                self.mean.copy_(momentum * self.mean + (1.0 - momentum) * mean)
                self.var.copy_(momentum * self.var + (1.0 - momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + 1e-3) * self.scale + self.bias


class ConvMLP(nn.Module):
    """1x1 convolutions over the channel axis: Linear -> BN -> ReLU."""

    def __init__(self, in_features, features):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f))
            self.add_module(f"bn_{i}", BatchNorm(f))
            in_features = f
        self.out_features = in_features

    def forward(self, x, m):
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), m))
        return x


class Head1x1(nn.Module):
    def __init__(self, in_features, features):
        super().__init__()
        self.dense = nn.Linear(in_features, features)

    def forward(self, x):
        return self.dense(x)


def softmax_valid(feature, weight, mask):
    """Softmax-weighted pooling over the valid points of axis 1: (B, 1, C)."""
    w = torch.softmax(torch.where(mask[..., None], weight, _MASK_NEG), dim=1) * mask[..., None]
    return torch.sum(feature * w, dim=1, keepdim=True)


def valid_mask(xyz):
    return torch.any(xyz != 0.0, dim=-1)


class DownConv(nn.Module):
    """Strided set convolution: K first-K window neighbours of each strided
    centre, an MLP on (relative xyz, features), masked max over K."""

    def __init__(self, in_features, kernel_size, k, distance, mlp, out_hw):
        super().__init__()
        self.kernel_size, self.k, self.distance = tuple(kernel_size), k, distance
        self.out_hw = tuple(out_hw)
        self.mlp = ConvMLP(3 + in_features, mlp)

    def forward(self, xyz_proj, feat_proj, stride, perm, m):
        b = xyz_proj.shape[0]
        oh, ow = self.out_hw
        idx, mask = ops.select(xyz_proj.detach(), xyz_proj.detach(), self.kernel_size, self.k,
                               self.distance, center_stride=tuple(stride), mode=ops.FIRST_K,
                               perm=perm)
        both = ops.gather(torch.cat([xyz_proj, feat_proj], dim=-1), idx) * mask
        new_xyz_proj = xyz_proj[:, ::stride[0], ::stride[1], :].contiguous()
        new_xyz = new_xyz_proj.reshape(b, oh * ow, 3)
        out = self.mlp(torch.cat([both[..., :3] - new_xyz[:, :, None, :], both[..., 3:]], -1), m)
        return torch.amax(out * mask, dim=2), new_xyz_proj


class UpConv(nn.Module):
    """Upsampling set convolution from the coarser level."""

    def __init__(self, in_dense, in_coarse, kernel_size, nsample, distance, stride, mlp, mlp2):
        super().__init__()
        self.kernel_size, self.nsample, self.distance = tuple(kernel_size), nsample, distance
        self.stride = tuple(stride)
        self.mlp = ConvMLP(3 + in_coarse, mlp)
        self.mlp2 = ConvMLP(self.mlp.out_features + in_dense, mlp2)

    def forward(self, xyz1_proj, xyz2_proj, feat1, feat2_proj, perm, m):
        b, h, w, _ = xyz1_proj.shape
        idx, mask = ops.select(xyz1_proj.detach(), xyz2_proj.detach(), self.kernel_size,
                               self.nsample, self.distance, source_stride=self.stride,
                               mode=ops.FIRST_K, perm=perm)
        both = ops.gather(torch.cat([xyz2_proj, feat2_proj], dim=-1), idx) * mask
        diff = both[..., :3] - xyz1_proj.reshape(b, h * w, 3)[:, :, None, :]
        out = torch.amax(self.mlp(torch.cat([diff, both[..., 3:]], dim=-1), m) * mask, dim=2)
        return self.mlp2(torch.cat([out, feat1], dim=-1), m)


class CostVolume(nn.Module):
    """Attentive cost volume: cross-frame attention over the K nearest
    frame-2 points in a window, then self-aggregation over first-K frame-1
    neighbours."""

    def __init__(self, in1, in2, kernel_size1, kernel_size2, nsample, nsample_q, distance,
                 mlp1, mlp2):
        super().__init__()
        self.kernel_size1, self.kernel_size2 = tuple(kernel_size1), tuple(kernel_size2)
        self.nsample, self.nsample_q, self.distance = nsample, nsample_q, distance
        c = mlp1[-1]
        self.cv_mlp1 = ConvMLP(10 + in1 + in2, mlp1)
        self.cv_xyz = ConvMLP(10, (c,))
        self.cv_sum_mlp = ConvMLP(2 * c, mlp2)
        self.cv_sum_xyz = ConvMLP(10, (c,))
        self.cv_agg_mlp = ConvMLP(c + in1 + c, mlp2)

    def forward(self, wxyz1_proj, xyz2_proj, feat1_proj, feat2_proj, perm, m):
        b, h, w, _ = wxyz1_proj.shape
        n = h * w
        idx_q, mask_q = ops.select(wxyz1_proj.detach(), xyz2_proj.detach(), self.kernel_size2,
                                   self.nsample_q, 1000.0, mode=ops.KNN)
        both_q = ops.gather(torch.cat([xyz2_proj, feat2_proj], dim=-1), idx_q) * mask_q
        qi_xyz, qi_feat = both_q[..., :3], both_q[..., 3:]
        xyz1 = wxyz1_proj.reshape(b, n, 3)
        feat1 = feat1_proj.reshape(b, n, -1)
        kq = qi_xyz.shape[2]
        pi_xyz = xyz1[:, :, None, :].expand(b, n, kq, 3)
        pi_feat = feat1[:, :, None, :].expand(b, n, kq, feat1.shape[-1])
        diff = qi_xyz - pi_xyz
        euc = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-20)
        xyz_enc_in = torch.cat([pi_xyz, qi_xyz, diff, euc], dim=-1)
        feat_emb = self.cv_mlp1(torch.cat([xyz_enc_in, pi_feat, qi_feat], dim=-1), m)
        xyz_enc = self.cv_xyz(xyz_enc_in, m)
        attn = self.cv_sum_mlp(torch.cat([xyz_enc, feat_emb], dim=-1), m)
        wq = torch.softmax(torch.where(mask_q > 0, attn, _MASK_NEG), dim=2)
        first_proj = torch.sum(wq * feat_emb, dim=2).reshape(b, h, w, -1)

        idx_p, mask_p = ops.select(wxyz1_proj.detach(), wxyz1_proj.detach(), self.kernel_size1,
                                   self.nsample, self.distance, mode=ops.FIRST_K, perm=perm)
        both_p = ops.gather(torch.cat([wxyz1_proj, first_proj], dim=-1), idx_p) * mask_p
        g_xyz, g_feat = both_p[..., :3], both_p[..., 3:]
        kp = g_xyz.shape[2]
        c_xyz = xyz1[:, :, None, :].expand(b, n, kp, 3)
        c_feat = feat1[:, :, None, :].expand(b, n, kp, feat1.shape[-1])
        p_diff = g_xyz - c_xyz
        p_euc = torch.sqrt(torch.sum(p_diff * p_diff, dim=-1, keepdim=True) + 1e-20)
        p_enc = self.cv_sum_xyz(torch.cat([c_xyz, g_xyz, p_diff, p_euc], dim=-1), m)
        p_attn = self.cv_agg_mlp(torch.cat([p_enc, c_feat, g_feat], dim=-1), m)
        wp = torch.softmax(torch.where(mask_p > 0, p_attn, _MASK_NEG), dim=2)
        return torch.sum(wp * g_feat, dim=2)


class FlowPredictor(nn.Module):
    def __init__(self, in_features, mlp):
        super().__init__()
        self.mlp = ConvMLP(in_features, mlp)

    def forward(self, inputs, m):
        return self.mlp(torch.cat(inputs, dim=-1), m)


class PoseHead(nn.Module):
    """1x1 conv to head_dim, dropout in training, then the q and t heads."""

    def __init__(self, in_features, head_dim, dropout_rate):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.big = Head1x1(in_features, head_dim)
        self.q_head = Head1x1(head_dim, 4)
        self.t_head = Head1x1(head_dim, 3)

    def forward(self, x, generator):
        x = self.big(x)
        if self.training and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
            x = torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
        return ops.qnormalize(self.q_head(x))[:, 0, :], self.t_head(x)[:, 0, :]


class Network(nn.Module):
    """Siamese four-level set-conv pyramid, a coarse cost volume at l2 that
    regresses the l3 pose, and three warp-refinement levels l2, l1, l0."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        shapes = cfg.level_shapes
        strides = list(zip(cfg.stride_h, cfg.stride_w))
        feat_c = [mlp[-1] for mlp in cfg.down_mlps]
        cv_c, pred_c = cfg.cv_mlp1[-1], cfg.predictor_mlp[-1]
        in_c = [3] + feat_c[:3]
        self.down_strides = [strides[i + 2] for i in range(4)]
        for i in range(4):
            self.add_module(f"down_l{i}", DownConv(in_c[i], cfg.down_kernels[i], cfg.down_K[i],
                                                   cfg.down_conv_dis[i], cfg.down_mlps[i],
                                                   shapes[i + 2]))
        self.cv_origin = CostVolume(feat_c[2], feat_c[2], cfg.cv_kernel1, cfg.cv_kernel2[3],
                                    cfg.cv_nsample, cfg.cv_nsample_q[3], cfg.cost_volume_dis[2],
                                    cfg.cv_mlp1, cfg.cv_mlp2)
        self.cv_down_l3 = DownConv(cv_c, cfg.down_kernels[3], cfg.down_K[3],
                                   cfg.down_conv_dis[3], cfg.cv_down_mlp, shapes[5])
        l3_c = cfg.cv_down_mlp[-1]
        self.l3_w_predictor = FlowPredictor(feat_c[3] + l3_c, cfg.predictor_mlp)
        self.l3_head = PoseHead(l3_c, cfg.head_dim, cfg.dropout_rate)
        for i in range(3):
            coarse_pred = l3_c if i == 2 else pred_c
            up = dict(kernel_size=cfg.up_kernel, nsample=cfg.up_nsample,
                      distance=cfg.up_conv_dis[i], stride=strides[i + 3], mlp=cfg.up_mlp1,
                      mlp2=cfg.up_mlp2)
            pred_in = feat_c[i] + cfg.up_mlp2[-1] + cv_c
            self.add_module(f"cv_l{i}", CostVolume(
                feat_c[i], feat_c[i], cfg.cv_kernel1, cfg.cv_kernel2[i], cfg.cv_nsample,
                cfg.cv_nsample_q[i], cfg.cost_volume_dis[i], cfg.cv_mlp1, cfg.cv_mlp2))
            self.add_module(f"up_w_l{i}", UpConv(feat_c[i], pred_c, **up))
            self.add_module(f"up_feat_l{i}", UpConv(feat_c[i], coarse_pred, **up))
            self.add_module(f"pred_feat_l{i}", FlowPredictor(pred_in, cfg.predictor_mlp))
            self.add_module(f"pred_w_l{i}", FlowPredictor(pred_in, cfg.predictor_mlp))
            self.add_module(f"head_l{i}", PoseHead(pred_c, cfg.head_dim, cfg.dropout_rate))

    def _perm(self, kernel_size, generator):
        """A fresh scan order of a first-K window in training; scan order
        (None) in eval."""
        if not self.training:
            return None
        return torch.randperm(kernel_size[0] * kernel_size[1], generator=generator,
                              device=generator.device)

    def pyramid(self, xyz_proj, m=0.99, generator=None):
        """Per level (xyz_proj, feat (B, N, C), feat_proj) of one batch of
        range images."""
        shapes = self.cfg.level_shapes
        levels = []
        xyz, feat_proj = xyz_proj, torch.zeros_like(xyz_proj)
        for i in range(4):
            perm = self._perm(self.cfg.down_kernels[i], generator)
            feat, xyz = getattr(self, f"down_l{i}")(xyz, feat_proj, self.down_strides[i], perm, m)
            h, w = shapes[i + 2]
            feat_proj = feat.reshape(feat.shape[0], h, w, feat.shape[-1])
            levels.append((xyz, feat, feat_proj))
        return levels

    def _warp(self, xyz_proj, q, t):
        b, h, w, _ = xyz_proj.shape
        xyz = xyz_proj.reshape(b, h * w, 3)
        return (ops.qrotate(q, xyz) + t[:, None, :]) * valid_mask(xyz)[..., None]

    def forward(self, p1, p2, m=0.99, generator: Optional[torch.Generator] = None):
        """Range images of both frames (B, H, W, 3) -> {"q": [l0..l3], "t":
        [l0..l3]}.  Training runs the tower on frame 1 then frame 2 (batch
        statistics per frame); eval on both frames at once."""
        if self.training:
            f1 = self.pyramid(p1, m, generator)
            f2 = self.pyramid(p2, m, generator)
        else:
            b = p1.shape[0]
            fb = self.pyramid(torch.cat([p1, p2], dim=0), m, generator)
            f1 = [tuple(t[:b] for t in lvl) for lvl in fb]
            f2 = [tuple(t[b:] for t in lvl) for lvl in fb]
        return self.correlate(f1, f2, m, generator)

    def correlate(self, f1, f2, m=0.99, generator=None):
        """Correlation and warp refinement of two pyramids."""
        cfg = self.cfg
        shapes = cfg.level_shapes
        b = f1[0][0].shape[0]
        (l2_xyz1, l2_feat1, l2_fp1), (l3_xyz1, l3_feat1, _) = f1[2], f1[3]
        cv = self.cv_origin(l2_xyz1, f2[2][0], l2_fp1, f2[2][2],
                            self._perm(cfg.cv_kernel1, generator), m)
        h2, w2 = shapes[4]
        l3_pred, _ = self.cv_down_l3(l2_xyz1, cv.reshape(b, h2, w2, -1), self.down_strides[3],
                                     self._perm(cfg.down_kernels[3], generator), m)
        h3, w3 = shapes[5]
        l3_w = self.l3_w_predictor([l3_feat1, l3_pred], m)
        l3_mask = valid_mask(l3_xyz1.reshape(b, h3 * w3, 3))
        q_c, t_c = self.l3_head(softmax_valid(l3_pred, l3_w, l3_mask), generator)
        qs, ts = [None, None, None, q_c], [None, None, None, t_c]
        c_xyz, c_w, c_pred = l3_xyz1, l3_w.reshape(b, h3, w3, -1), l3_pred.reshape(b, h3, w3, -1)
        for li in (2, 1, 0):
            xyz1_proj, feat1 = f1[li][0], f1[li][1]
            xyz2_proj, fp2 = f2[li][0], f2[li][2]
            hl, wl = shapes[li + 2]
            warped = self._warp(xyz1_proj, q_c, t_c)
            wxyz, wfeat_proj = ops.project(warped, feat1, hl, wl, cfg.sensor)
            wfeat = wfeat_proj.reshape(b, hl * wl, -1)
            wmask = valid_mask(wxyz.reshape(b, hl * wl, 3))
            cv_l = getattr(self, f"cv_l{li}")(wxyz, xyz2_proj, wfeat_proj, fp2,
                                              self._perm(cfg.cv_kernel1, generator), m)
            up_w = getattr(self, f"up_w_l{li}")(wxyz, c_xyz, wfeat, c_w,
                                                self._perm(cfg.up_kernel, generator), m)
            up_feat = getattr(self, f"up_feat_l{li}")(wxyz, c_xyz, wfeat, c_pred,
                                                      self._perm(cfg.up_kernel, generator), m)
            pred = getattr(self, f"pred_feat_l{li}")([wfeat, up_feat, cv_l], m)
            w = getattr(self, f"pred_w_l{li}")([wfeat, up_w, cv_l], m)
            q_d, t_d = getattr(self, f"head_l{li}")(softmax_valid(pred, w, wmask), generator)
            q_c, t_c = ops.compose_pose(q_d, t_d, q_c, t_c)
            qs[li], ts[li] = q_c, t_c
            c_xyz, c_w, c_pred = wxyz, w.reshape(b, hl, wl, -1), pred.reshape(b, hl, wl, -1)
        return {"q": [ops.qnormalize(q) for q in qs], "t": ts}
