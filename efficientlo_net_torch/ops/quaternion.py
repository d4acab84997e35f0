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


def mat_to_euler_zyx(m: torch.Tensor):
    """Rotation matrix (..., 3, 3) -> (z, y, x) Euler angles, standard-form
    branch only (no gimbal-lock case), as the reference converts GT."""
    r11, r12, r13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    r23, r33 = m[..., 1, 2], m[..., 2, 2]
    cy = torch.sqrt(r33 * r33 + r23 * r23)
    return torch.atan2(-r12, r11), torch.atan2(r13, cy), torch.atan2(-r23, r33)


def euler_zyx_to_quat(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Euler (z then y then x) -> quaternion (..., 4)."""
    z, y, x = z / 2.0, y / 2.0, x / 2.0
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    return torch.stack(
        [
            cx * cy * cz - sx * sy * sz,
            cx * sy * sz + cy * cz * sx,
            cx * cz * sy - sx * cy * sz,
            cx * cy * sz + sx * cz * sy,
        ],
        dim=-1,
    )


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion through the zyx-Euler path."""
    return euler_zyx_to_quat(*mat_to_euler_zyx(m))


def quat_trans_to_mat4(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(q (..., 4), t (..., 3)) -> homogeneous transform (..., 4, 4)."""
    top = torch.cat([quat_to_mat(q), t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def compose_pose(q_det, t_det, q_coarse, t_coarse):
    """Residual pose composition of the warp-refinement loop:
    q <- q_det ⊗ q_coarse;  t <- R(q_det) t_coarse + t_det."""
    t4 = torch.cat([torch.zeros_like(t_coarse[..., :1]), t_coarse], dim=-1)
    t_rot = qmul(qmul(q_det, t4), qinv(q_det))[..., 1:]
    return qmul(q_det, q_coarse), t_rot + t_det


def transform_points(mat4: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous transforms (..., 4, 4) to points (..., N, 3)."""
    r, t = mat4[..., :3, :3], mat4[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", r, points) + t[..., None, :]
