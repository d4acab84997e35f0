"""Plain operations of the reference: quaternion algebra, the cylindrical
projection, the windowed neighbour selects and the gather.

Written out in plain PyTorch, float32, with no kernel: the arithmetic and
the order of every reduction follow the published network as the
benchmark's judged program computes it, so that the two agree to rounding.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-10
VALID_EPS = 1e-10
FIRST_K = "first_k"
KNN = "knn"


# ---- quaternions (w, x, y, z) -------------------------------------------------

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qinv(q):
    norm_sq = torch.sum(q * q, dim=-1, keepdim=True) + EPS
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1) / norm_sq


def qnormalize(q):
    return q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + EPS) + EPS)


def qrotate(q, points):
    """Rotate points (..., N, 3) by q (..., 4): q p q^-1."""
    q = q[..., None, :]
    p4 = torch.cat([torch.zeros_like(points[..., :1]), points], dim=-1)
    return qmul(qmul(q, p4), qinv(q))[..., 1:]


def mat_to_quat(m):
    """Rotation matrix -> quaternion through zyx-Euler angles (the standard
    branch, as the ground truth is converted in the original work)."""
    r11, r12, r13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    r23, r33 = m[..., 1, 2], m[..., 2, 2]
    cy = torch.sqrt(r33 * r33 + r23 * r23)
    z, y, x = torch.atan2(-r12, r11), torch.atan2(r13, cy), torch.atan2(-r23, r33)
    z, y, x = z / 2.0, y / 2.0, x / 2.0
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    return torch.stack([
        cx * cy * cz - sx * sy * sz,
        cx * sy * sz + cy * cz * sx,
        cx * cz * sy - sx * cy * sz,
        cx * cy * sz + sx * cz * sy,
    ], dim=-1)


def compose_pose(q_det, t_det, q_coarse, t_coarse):
    """q <- q_det q_coarse;  t <- R(q_det) t_coarse + t_det."""
    t4 = torch.cat([torch.zeros_like(t_coarse[..., :1]), t_coarse], dim=-1)
    t_rot = qmul(qmul(q_det, t4), qinv(q_det))[..., 1:]
    return qmul(q_det, q_coarse), t_rot + t_det


def transform_points(mat4, points):
    r, t = mat4[..., :3, :3], mat4[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", r, points) + t[..., None, :]


# ---- projection ----------------------------------------------------------------

_SENTINEL = 2**31 - 1
_IDX_BITS = 18


def pixel_coords(points, height, width, sensor):
    """(row, col, valid, r) of points (..., 3) on an (height, width) grid:
    col = int((pi - atan2(y, x)) / az_res), row = H - int(asin(z/r) / v_res
    + v_offset), both truncated toward zero and clipped."""
    az_res = 2.0 * math.pi / width
    up = sensor["vertical_fov_up_deg"] * math.pi / 180.0
    down = sensor["vertical_fov_down_deg"] * math.pi / 180.0
    v_res = (up - down) / max(height - 1, 1)
    v_off = -down / v_res
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r_sq = x * x + y * y + z * z
    valid = r_sq > 1e-10
    r = torch.sqrt(torch.where(valid, r_sq, torch.ones_like(r_sq)))
    col = ((math.pi - torch.atan2(y, x)) / az_res).to(torch.int32)
    beta = torch.asin(torch.clamp(z / r, -1.0, 1.0))
    row = height - (beta / v_res + v_off).to(torch.int32)
    return torch.clamp(row, 0, height - 1), torch.clamp(col, 0, width - 1), valid, r


def project(points, features, height, width, sensor):
    """Range image (B, H, W, 3) [and feature image] of points (B, N, 3): per
    pixel the point of least range quantized to 13 bits over 0-60 m, ties
    to the lowest index (one scatter-min of the packed key); empty pixels
    stay zero.  Used inside the 35 m crop only, as the network does."""
    b, n, _ = points.shape
    if n >= (1 << _IDX_BITS):
        raise ValueError(f"the packed key holds < 2**18 points, got {n}")
    row, col, valid, r = pixel_coords(points, height, width, sensor)
    num_pix = height * width
    pix = torch.where(valid, row.long() * width + col.long(), num_pix)
    r_q = torch.clamp((r * (8191.0 / 60.0)).to(torch.int32), 0, 8191)
    idx = torch.arange(n, dtype=torch.int32, device=points.device).expand(b, n)
    key = torch.where(valid, (r_q << _IDX_BITS) | idx, _SENTINEL)
    win = torch.full((b, num_pix + 1), _SENTINEL, dtype=torch.int32, device=points.device)
    win.scatter_reduce_(1, pix, key, reduce="amin", include_self=True)
    win = win[:, :num_pix]
    winner = torch.clamp(win & ((1 << _IDX_BITS) - 1), 0, n - 1).long()
    has_point = (win != _SENTINEL)[..., None]

    def take(values):
        got = torch.gather(values, 1, winner[..., None].expand(-1, -1, values.shape[-1]))
        got = torch.where(has_point, got, torch.zeros((), dtype=got.dtype, device=got.device))
        return got.reshape(b, height, width, values.shape[-1])

    img = take(points)
    return img, (img if features is None else take(features))


def crop(points, max_planar_radius):
    """Points (B, N, 3) with invalid (all-zero) points and those beyond the
    planar radius zeroed, and the (B, N, 1) keep mask."""
    valid = torch.any(points != 0.0, dim=-1)
    keep = (valid & (torch.linalg.vector_norm(points[..., :2], dim=-1)
                     <= max_planar_radius))[..., None]
    return points * keep, keep


# ---- windowed selects ------------------------------------------------------------

def _sq3(v):
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


def _window_index(h1, w1, h2, w2, kernel_size, center_stride, source_stride, device):
    """Flat grid-2 index (N, T) of every window slot of every strided centre,
    and whether the slot's row lies inside grid 2 (W wraps)."""
    kh, kw = kernel_size
    csh, csw = center_stride
    sh, sw = source_stride
    n_h, n_w = -(-h1 // csh), -(-w1 // csw)
    base_r = torch.arange(n_h, device=device) * csh // sh
    base_c = torch.arange(n_w, device=device) * csw // sw
    t = torch.arange(kh * kw, device=device)
    rows = base_r[:, None, None] + (t // kw - kh // 2)
    cols = torch.remainder(base_c[None, :, None] + (t % kw - kw // 2), w2)
    rows = rows.expand(n_h, n_w, kh * kw).reshape(n_h * n_w, kh * kw)
    cols = cols.expand(n_h, n_w, kh * kw).reshape(n_h * n_w, kh * kw)
    in_bounds = (rows >= 0) & (rows < h2)
    return rows.clamp(0, h2 - 1) * w2 + cols, in_bounds


def select(xyz1, xyz2, kernel_size, k, distance, center_stride=(1, 1),
           source_stride=(1, 1), mode=KNN, perm=None):
    """Up to K window neighbours in grid 2 of every strided centre of grid
    1: the first K valid ones within ``distance`` in (permuted) scan order,
    or the K nearest (ties to the lower slot).  Returns (idx (B, N, K) flat
    into H2*W2, 0 where masked; mask (B, N, K, 1) float)."""
    b, h1, w1, _ = xyz1.shape
    _, h2, w2, _ = xyz2.shape
    csh, csw = center_stride
    flat, in_bounds = _window_index(h1, w1, h2, w2, kernel_size, center_stride,
                                    source_stride, xyz1.device)
    cand = xyz2.reshape(b, h2 * w2, 3)[:, flat]
    cand = torch.where(in_bounds[None, :, :, None], cand,
                       torch.zeros((), dtype=cand.dtype, device=cand.device))
    centre = xyz1[:, ::csh, ::csw].reshape(b, flat.shape[0], 1, 3)
    d_sq = torch.clamp(_sq3(cand - centre), min=VALID_EPS)
    ok = (_sq3(cand) > VALID_EPS) & (d_sq <= distance * distance) & (_sq3(centre) > VALID_EPS)
    n, t = flat.shape
    if mode == FIRST_K:
        pos = torch.arange(t, device=xyz1.device)
        if perm is not None:
            pos = torch.argsort(perm.to(xyz1.device))
        score = torch.where(ok, (t - pos).to(torch.float32), -1.0)
        threshold = 0.0
    elif mode == KNN:
        score = torch.where(ok, -d_sq, -torch.inf)
        threshold = -torch.inf
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if k > t:
        raise ValueError(f"k={k} exceeds the window's {t} slots")
    vals, order = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, top_t = vals[..., :k], order[..., :k]
    mask = top_scores > threshold
    idx = torch.gather(flat.expand(b, n, t), 2, top_t)
    idx = torch.where(mask, idx, 0)
    return idx, mask[..., None].to(xyz1.dtype)


def gather(image, idx):
    """image (B, H, W, C) or (B, H*W, C), idx (B, N, K) -> (B, N, K, C)."""
    b, c = image.shape[0], image.shape[-1]
    flat = image.reshape(b, -1, c)
    n, k = idx.shape[1], idx.shape[2]
    index = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(flat, 1, index).reshape(b, n, k, c)
