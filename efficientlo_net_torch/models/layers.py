"""Layer library: set-conv pyramid, attentive cost volume, predictors.

Port of ``efficientlo_net_tpu/models/layers.py``.  The mode is the module's
``training`` flag: in eval mode batch norm reads its running statistics, in
training it normalizes with the batch's and updates the running ones by an
EMA whose decay ``bn_momentum`` is passed per call.  Tensors are
channels-last: grids (B, H, W, C), neighbour groups (B, N, K, C).  Module and
parameter names follow the JAX package's Flax names, so the weight bridge
(``pretrained.variables_to_state_dict``) maps one to one; initialization is
Flax's (Xavier-uniform weights, zero biases).

``dtype`` is the compute dtype of the MLP stacks (``ModelConfig.compute_dtype``).
Under bfloat16 the casts are the JAX package's, place by place: parameters
stay float32 and each dense layer casts its input, weight and bias (as Flax's
``promote_dtype``); batch norm computes in float32 and returns the input's
dtype; the masked softmaxes and the pose heads run in float32; a product
with a float32 mask or a concatenation with float32 features promotes to
float32 where ``*`` and ``jnp.concatenate`` do.  So every pyramid feature and
every cost volume is float32, and the neighbour selects only see float32.

Inside ``data_parallel(group)`` (the data-parallel train step) each rank
holds its rows of a global batch: training-mode batch norm then normalizes
over the rows of every rank of the group, as the JAX package's jitted step
normalizes over its whole sharded batch, and dropout keeps this rank's rows
of a global mask (``data_shard``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import bn_relu as bnr
from ..ops import neighbors as nbr
from ..parallel.distributed import all_reduce_sum

_MASK_NEG = -1e10
_data_group = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Inside the block the network's training-mode batch statistics and
    dropout masks span every rank of ``group`` (see the module docstring);
    a group of one rank, or None, changes nothing."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    token = _data_group.set(group)
    try:
        yield
    finally:
        _data_group.reset(token)


def data_shard() -> Optional[Tuple[int, int]]:
    """(this rank's index, the rank count) of the active data-parallel
    group, or None outside ``data_parallel``."""
    group = _data_group.get()
    return None if group is None else (dist.get_rank(group), dist.get_world_size(group))


def _global_moments(x, axes, group):
    """Mean and biased variance over ``axes`` of the rows of every rank:
    two differentiable all-reduces (the sums and the count, then the
    centred squares), so the backward sums over the ranks too, as
    ``SyncBatchNorm`` does."""
    count = torch.full((1,), x.numel() // x.shape[-1], dtype=x.dtype, device=x.device)
    totals = all_reduce_sum(torch.cat([torch.sum(x, dim=axes), count]), group)
    mean = totals[:-1] / totals[-1]
    var = all_reduce_sum(torch.sum(torch.square(x - mean), dim=axes), group) / totals[-1]
    return mean, var


class ScheduledBatchNorm(nn.Module):
    """Batch norm over all axes but the last, eps 1e-3, running ``mean`` and
    ``var`` buffers.  In training it normalizes with the batch mean and the
    *biased* batch variance and sets ``running = m * running + (1 - m) *
    batch`` with the decay ``m`` of the call (a float or a float32 0-d
    tensor), detached.  (``nn.BatchNorm`` keeps an unbiased running
    variance and calls ``1 - m`` its momentum.)"""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, momentum=0.99):
        in_dtype = x.dtype
        x = x.float()  # statistics and normalization in float32
        if self.training:
            axes = tuple(range(x.dim() - 1))
            group = _data_group.get()
            if group is None:
                mean = torch.mean(x, dim=axes)
                var = torch.var(x, dim=axes, correction=0)
            else:
                mean, var = _global_moments(x, axes, group)
            with torch.no_grad():
                self.mean.copy_(momentum * self.mean + (1.0 - momentum) * mean)
                self.var.copy_(momentum * self.var + (1.0 - momentum) * var)
        else:
            mean, var = self.mean, self.var
        return bnr.normalize(x, mean, var, self.scale, self.bias, self.epsilon).to(in_dtype)

    def forward_relu(self, x, momentum=0.99):
        """``relu(self(x, momentum))``: one ``efficientlo::bn_relu`` pass where
        ``_fuses_bn_relu`` holds, bit-identical to the chain, else the chain."""
        if _fuses_bn_relu(self, x):
            return bnr.bn_relu_op(x, self.mean, self.var, self.scale, self.bias, self.epsilon)
        return torch.relu(self(x, momentum))


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """``nn.Linear`` initialized as Flax's ``Dense`` with Xavier-uniform
    kernel init: U(±sqrt(6 / (in + out))) weights, zero bias."""
    dense = nn.Linear(in_features, out_features)
    nn.init.xavier_uniform_(dense.weight)
    nn.init.zeros_(dense.bias)
    return dense


def _fuses_bn_relu(bn: ScheduledBatchNorm, x: torch.Tensor) -> bool:
    """Whether ``bn`` and the ReLU after it run as one ``efficientlo::bn_relu``
    pass over ``x``: eval-mode batch norm with gradients off on a float32
    CUDA tensor.  Training, eval with gradients, the CPU and bfloat16 keep
    the eager chain."""
    return (not bn.training and not torch.is_grad_enabled() and x.is_cuda
            and x.dtype == torch.float32)


class ConvMLP(nn.Module):
    """Stack of 1x1 convs over the channel axis: Linear -> BN -> ReLU, the
    linear layers in ``dtype``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", _dense(in_features, f))
            self.add_module(f"bn_{i}", ScheduledBatchNorm(f))
            in_features = f
        self.out_features = in_features

    def _linear(self, dense: nn.Linear, x):
        if self.dtype == torch.float32:
            return dense(x)
        # Flax's Dense: input, kernel and bias cast to the compute dtype, the
        # product rounded, then the bias added (not one fused addmm)
        return F.linear(x.to(self.dtype), dense.weight.to(self.dtype)) + dense.bias.to(self.dtype)

    def forward(self, x, bn_momentum=0.99):
        for i in range(self.depth):
            x = getattr(self, f"bn_{i}").forward_relu(
                self._linear(getattr(self, f"dense_{i}"), x), bn_momentum)
        return x


class Head1x1(nn.Module):
    """1x1 conv with no BN or activation (pose heads)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = _dense(in_features, features)

    def forward(self, x):
        return self.dense(x)


def softmax_valid(feature_bnc, weight_bnc, mask_valid):
    """Masked softmax-weighted pooling over the valid points of axis 1.
    Returns (B, 1, C), in float32."""
    feature_bnc = feature_bnc.float()
    logits = torch.where(mask_valid[..., None], weight_bnc.float(), _MASK_NEG)
    w = torch.softmax(logits, dim=1)
    # zero out fully-invalid batches' contributions from masked points
    w = w * mask_valid[..., None]
    return torch.sum(feature_bnc * w, dim=1, keepdim=True)


def valid_mask_from_xyz(xyz_bn3):
    """(B, N) bool: a point is valid iff it is not exactly (0, 0, 0)."""
    return torch.any(xyz_bn3 != 0.0, dim=-1)


class DownConv(nn.Module):
    """Strided set-conv: K window neighbours per strided centre, per-point
    MLP on (Δxyz, feat), mask, max-pool over K.  Eval groups with the fused
    select-and-group; training selects, then gathers, so that gradients
    reach the source features.  ``select_fn`` replaces the select + group
    (the W-axis ring's ``parallel.ring.ring_select_and_group_replicated``):
    it takes (xyz, feats, kernel_size, k, distance, center_stride=, mode=,
    perm=, fused=) and returns (xyz_group, feat_group, mask); it is given
    ``fused=not training`` as the unsharded select is, so the ring groups
    with gradients in training."""

    def __init__(self, in_features: int, kernel_size: Tuple[int, int], k: int,
                 distance: float, mlp: Sequence[int], out_hw: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.k = k
        self.distance = distance
        self.out_hw = tuple(out_hw)
        self.mlp = ConvMLP(3 + in_features, mlp, dtype)

    def forward(self, xyz_proj, feat_proj, stride_hw, perm=None, bn_momentum=0.99,
                select_fn=None):
        b = xyz_proj.shape[0]
        oh, ow = self.out_hw
        if select_fn is not None:
            xyz_group, feat_group, mask = select_fn(
                xyz_proj, feat_proj, self.kernel_size, self.k, self.distance,
                center_stride=tuple(stride_hw), mode=nbr.FIRST_K, perm=perm,
                fused=not self.training,
            )
        else:
            xyz_group, feat_group, mask = nbr.select_and_group(
                xyz_proj, feat_proj, self.kernel_size, self.k, self.distance,
                center_stride=tuple(stride_hw), mode=nbr.FIRST_K, perm=perm,
                fused=not self.training,
            )
        new_xyz_proj = xyz_proj[:, :: stride_hw[0], :: stride_hw[1], :].contiguous()
        new_xyz = new_xyz_proj.reshape(b, oh * ow, 3)

        diff = xyz_group - new_xyz[:, :, None, :]
        out = self.mlp(torch.cat([diff, feat_group], dim=-1), bn_momentum)
        # amax splits the gradient evenly among tied maxima, as jnp.max does;
        # the float32 mask promotes a bfloat16 MLP output to float32
        out = torch.amax(out * mask, dim=2)  # (B, N, C)
        return out, new_xyz_proj


class UpConv(nn.Module):
    """Upsampling set-conv: dense centres query the coarse level's features
    in a source-strided window (first-K); MLP -> masked max-pool -> concat
    the dense features -> MLP2."""

    def __init__(self, in_dense: int, in_coarse: int, kernel_size: Tuple[int, int],
                 nsample: int, distance: float, stride_hw: Tuple[int, int],
                 mlp: Sequence[int], mlp2: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.nsample = nsample
        self.distance = distance
        self.stride_hw = tuple(stride_hw)
        self.mlp = ConvMLP(3 + in_coarse, mlp, dtype)
        self.mlp2 = ConvMLP(self.mlp.out_features + in_dense, mlp2, dtype)

    def forward(self, xyz1_proj, xyz2_proj, feat1, feat2_proj, perm=None, bn_momentum=0.99):
        b, h, w, _ = xyz1_proj.shape
        idx, mask = nbr.select_neighbors(
            xyz1_proj, xyz2_proj, self.kernel_size, self.nsample, self.distance,
            source_stride=self.stride_hw, mode=nbr.FIRST_K, perm=perm,
        )
        both = nbr.gather_by_index(torch.cat([xyz2_proj, feat2_proj], dim=-1), idx) * mask
        up_xyz, up_feat = both[..., :3], both[..., 3:]

        xyz1 = xyz1_proj.reshape(b, h * w, 3)
        diff = up_xyz - xyz1[:, :, None, :]
        out = self.mlp(torch.cat([diff, up_feat], dim=-1), bn_momentum)
        out = torch.amax(out * mask, dim=2)  # (B, HW, C)
        return self.mlp2(torch.cat([out, feat1], dim=-1), bn_momentum)


class CostVolume(nn.Module):
    """Projection-aware attentive cost volume.

    Stage 1: each frame-1 point takes nsample_q windowed-KNN frame-2
    neighbours (radius 1000, i.e. unbounded), encodes (p1, p2, Δ, ‖Δ‖, f1,
    f2) and attends with a masked softmax over K.  Stage 2: self-aggregation
    over nsample first-K frame-1 neighbours with a second masked softmax.
    In both stages the softmax weights are not re-multiplied by the mask: a
    centre with no neighbours gets uniform weights over its masked slots.
    """

    def __init__(self, in1: int, in2: int, kernel_size1, kernel_size2, nsample: int,
                 nsample_q: int, distance: float, mlp1: Sequence[int], mlp2: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size1 = tuple(kernel_size1)
        self.kernel_size2 = tuple(kernel_size2)
        self.nsample = nsample
        self.nsample_q = nsample_q
        self.distance = distance
        c = mlp1[-1]
        self.cv_mlp1 = ConvMLP(10 + in1 + in2, mlp1, dtype)
        self.cv_xyz = ConvMLP(10, (c,), dtype)
        self.cv_sum_mlp = ConvMLP(2 * c, mlp2, dtype)
        self.cv_sum_xyz = ConvMLP(10, (c,), dtype)
        self.cv_agg_mlp = ConvMLP(c + in1 + c, mlp2, dtype)

    def forward(self, warped_xyz1_proj, xyz2_proj, feat1_proj, feat2_proj, perm=None,
                bn_momentum=0.99):
        b, h, w, _ = warped_xyz1_proj.shape
        n = h * w

        # ---- stage 1: cross-frame attention ------------------------------
        idx_q, mask_q = nbr.select_neighbors(
            warped_xyz1_proj, xyz2_proj, self.kernel_size2, self.nsample_q, 1000.0,
            mode=nbr.KNN,
        )
        both_q = nbr.gather_by_index(torch.cat([xyz2_proj, feat2_proj], dim=-1), idx_q) * mask_q
        qi_xyz, qi_feat = both_q[..., :3], both_q[..., 3:]  # (B, N, Kq, *)

        xyz1 = warped_xyz1_proj.reshape(b, n, 3)
        feat1 = feat1_proj.reshape(b, n, -1)
        kq = qi_xyz.shape[2]

        pi_xyz = xyz1[:, :, None, :].expand(b, n, kq, 3)
        pi_feat = feat1[:, :, None, :].expand(b, n, kq, feat1.shape[-1])
        diff = qi_xyz - pi_xyz
        euc = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-20)
        xyz_enc_in = torch.cat([pi_xyz, qi_xyz, diff, euc], dim=-1)
        feat_in = torch.cat([xyz_enc_in, pi_feat, qi_feat], dim=-1)

        feat_emb = self.cv_mlp1(feat_in, bn_momentum)
        xyz_enc = self.cv_xyz(xyz_enc_in, bn_momentum)
        attn = self.cv_sum_mlp(torch.cat([xyz_enc, feat_emb], dim=-1), bn_momentum)
        # the masked softmaxes in float32 (a Python float would not promote)
        attn = torch.where(mask_q > 0, attn.float(), _MASK_NEG)
        wq = torch.softmax(attn, dim=2)
        first = torch.sum(wq * feat_emb.float(), dim=2)  # (B, N, C)
        first_proj = first.reshape(b, h, w, -1)

        # ---- stage 2: self-aggregation ----------------------------------
        idx_p, mask_p = nbr.select_neighbors(
            warped_xyz1_proj, warped_xyz1_proj, self.kernel_size1, self.nsample,
            self.distance, mode=nbr.FIRST_K, perm=perm,
        )
        both_p = nbr.gather_by_index(
            torch.cat([warped_xyz1_proj, first_proj], dim=-1), idx_p
        ) * mask_p
        pc_grouped_xyz, pc_grouped_feat = both_p[..., :3], both_p[..., 3:]
        kp = pc_grouped_xyz.shape[2]

        pc_xyz_new = xyz1[:, :, None, :].expand(b, n, kp, 3)
        pc_feat_new = feat1[:, :, None, :].expand(b, n, kp, feat1.shape[-1])
        pc_diff = pc_grouped_xyz - pc_xyz_new
        pc_euc = torch.sqrt(torch.sum(pc_diff * pc_diff, dim=-1, keepdim=True) + 1e-20)
        pc_xyz_in = torch.cat([pc_xyz_new, pc_grouped_xyz, pc_diff, pc_euc], dim=-1)

        pc_xyz_enc = self.cv_sum_xyz(pc_xyz_in, bn_momentum)
        pc_attn = self.cv_agg_mlp(torch.cat([pc_xyz_enc, pc_feat_new, pc_grouped_feat], dim=-1),
                                  bn_momentum)
        pc_attn = torch.where(mask_p > 0, pc_attn.float(), _MASK_NEG)
        wp = torch.softmax(pc_attn, dim=2)
        return torch.sum(wp * pc_grouped_feat.float(), dim=2)


class FlowPredictor(nn.Module):
    """Concat(inputs) -> MLP."""

    def __init__(self, in_features: int, mlp: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = ConvMLP(in_features, mlp, dtype)

    def forward(self, inputs, bn_momentum=0.99):
        return self.mlp(torch.cat([v for v in inputs if v is not None], dim=-1), bn_momentum)
