"""SE(3) manifold operations: Exp/Log maps, batched and autodiff-friendly.

Port of ``efficientlo_net_tpu/ops/se3.py``.  The backend takes its factor
Jacobians from ``torch.func.jacfwd`` through these functions, so every one
is functional (no in-place ops, no branches on tensor values).

Numerics: every trig ratio is computed with a "safe" angle
(``sqrt(theta_sq + tiny)``) plus a Taylor branch selected by ``where``, and
both operands of each ``where`` stay finite, so values AND forward-mode
gradients stay finite at the identity: ``jacfwd`` at a zero twist is the
common case when linearizing factors.  Per-element scalars keep a trailing
axis of 1 (``keepdim``): under ``torch.func.jacfwd`` a 0-dim value that
meets a Python float can carry a float64 tangent, which an unsqueeze then
turns into a float64 operand of the next matmul.  ``so3_log`` recovers the
angle from ``atan2(|skew|, trace-1)``, which has clean gradients at
theta = 0 (the ``arccos`` form does not).  The theta = pi neighbourhood
remains genuinely singular (irrelevant for inter-keyframe motions).
"""

from __future__ import annotations

import torch

_SMALL = 1e-8   # theta_sq threshold for the Taylor branch
_TINY = 1e-24   # additive guard inside sqrt


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _trig_coeffs(theta_sq):
    """(a, b, c) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with safe grads.

    theta_sq: (..., 1) squared angle.  Returns (..., 1, 1)-broadcastable
    tensors.
    """
    t_sq = theta_sq[..., None]
    t = torch.sqrt(t_sq + _TINY)
    small = t_sq < _SMALL
    sin_t, cos_t = torch.sin(t), torch.cos(t)
    a = torch.where(small, 1.0 - t_sq / 6.0, sin_t / t)
    b = torch.where(small, 0.5 - t_sq / 24.0, (1.0 - cos_t) / (t_sq + _TINY))
    c = torch.where(small, 1.0 / 6.0 - t_sq / 120.0, (t - sin_t) / (t_sq * t + _TINY))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) rotation matrix (Rodrigues)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    a, b, _ = _trig_coeffs(theta_sq)
    k = hat(w)
    return _eye3(k) + a * k + b * (k @ k)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector."""
    w_hat = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )  # = 2 sin(theta) * axis
    s_sq = torch.sum(w_hat * w_hat, dim=-1, keepdim=True)   # 4 sin^2(theta)
    s = torch.sqrt(s_sq + _TINY)                    # 2 sin(theta), safe
    trace = torch.diagonal(r, dim1=-2, dim2=-1).sum(dim=-1, keepdim=True)
    theta = torch.atan2(s, trace - 1.0)             # clean grads at theta=0
    small = s_sq < _SMALL
    # w = theta / (2 sin theta) * w_hat;  series: 0.5 + theta^2/12,
    # with theta^2 ~ s_sq/4 near zero
    scale = torch.where(small, 0.5 + s_sq / 48.0, theta / s)
    return scale * w_hat


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (v, w) -> (..., 4, 4) transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    a, b, c = _trig_coeffs(theta_sq)
    k = hat(w)
    k2 = k @ k
    eye = _eye3(k)
    r = eye + a * k + b * k2
    j = eye + b * k + c * k2  # left Jacobian
    t = (j @ v[..., None])[..., 0]
    top = torch.cat([r, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) twist (v, w)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    w = so3_log(r)
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    k = hat(w)
    k2 = k @ k
    t_sq = theta_sq[..., None]
    th = torch.sqrt(t_sq + _TINY)
    small = t_sq < _SMALL
    # J^-1 = I - K/2 + coef K^2,
    # coef = (1 - theta cos(theta/2) / (2 sin(theta/2))) / theta^2
    half = th / 2.0
    coef = torch.where(
        small,
        1.0 / 12.0 + t_sq / 720.0,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _TINY)) / (t_sq + _TINY),
    )
    j_inv = _eye3(k) - 0.5 * k + coef * k2
    v = (j_inv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inv(m: torch.Tensor) -> torch.Tensor:
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    rt = r.transpose(-1, -2)
    ti = -(rt @ t[..., None])[..., 0]
    top = torch.cat([rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)
