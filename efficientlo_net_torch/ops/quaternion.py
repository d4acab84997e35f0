"""Quaternion algebra as batched tensor functions.

Port of ``efficientlo_net_tpu/ops/quaternion.py``.  Layout is ``(w, x, y, z)``
(scalar first); every function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b over the last axis (shape ``(..., 4)``)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse q* / |q|^2."""
    norm_sq = torch.sum(q * q, dim=-1, keepdim=True) + _EPS
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / norm_sq


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """L2-normalize with the double-epsilon guard of the reference."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + _EPS) + _EPS
    return q / n


def qrotate(q: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate ``points`` (..., N, 3) by quaternion ``q`` (..., 4): q p q^-1."""
    q = q[..., None, :]
    p4 = torch.cat([torch.zeros_like(points[..., :1]), points], dim=-1)
    return qmul(qmul(q, p4), qinv(q))[..., 1:]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3), non-unit-safe."""
    w, x, y, z = q.unbind(-1)
    nq = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(nq, min=1e-8)
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    row0 = torch.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], dim=-1)
    row1 = torch.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], dim=-1)
    row2 = torch.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def compose_pose(q_det, t_det, q_coarse, t_coarse):
    """Residual pose composition of the warp-refinement loop:
    q <- q_det ⊗ q_coarse;  t <- R(q_det) t_coarse + t_det."""
    t4 = torch.cat([torch.zeros_like(t_coarse[..., :1]), t_coarse], dim=-1)
    t_rot = qmul(qmul(q_det, t4), qinv(q_det))[..., 1:]
    return qmul(q_det, q_coarse), t_rot + t_det
