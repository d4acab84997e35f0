"""Cylindrical range-image projection (packed scatter-min method).

Port of ``efficientlo_net_tpu/ops/projection.py``: ``pixel_coords`` with the
same truncation toward zero, and the packed method, whose winner per pixel
falls out of one int32 scatter-min over the key ``(r_q << 18) | idx`` (13-bit
range quantization in 7.3 mm steps over 0-60 m, 18-bit point index).  Within
one quantization step the lowest point index wins.  Invalid points
(``x == y == z == 0``) never scatter; empty pixels stay exactly (0, 0, 0).
"""

from __future__ import annotations

import math

import torch

from ..config import SensorConfig

_SENTINEL = 2**31 - 1
_IDX_BITS = 18


def pixel_coords(points: torch.Tensor, height: int, width: int, sensor: SensorConfig):
    """Map points (..., 3) to (row, col, valid, r) on an (height, width) grid:
      col = int((pi - atan2(y, x)) / az_res)          (truncation toward zero)
      row = H - int(asin(z/r) / v_res + v_offset)     (then clipped)
    The vertical intrinsics are the sensor's; the resolution follows the
    grid height, so coarse in-network grids recompute it."""
    az_res = 2.0 * math.pi / width
    up = sensor.vertical_fov_up_deg * math.pi / 180.0
    down = sensor.vertical_fov_down_deg * math.pi / 180.0
    v_res = (up - down) / max(height - 1, 1)
    v_off = -down / v_res

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r_sq = x * x + y * y + z * z
    valid = r_sq > 1e-10
    r = torch.sqrt(torch.where(valid, r_sq, torch.ones_like(r_sq)))

    col = ((math.pi - torch.atan2(y, x)) / az_res).to(torch.int32)
    beta = torch.asin(torch.clamp(z / r, -1.0, 1.0))
    row = height - (beta / v_res + v_off).to(torch.int32)

    row = torch.clamp(row, 0, height - 1)
    col = torch.clamp(col, 0, width - 1)
    return row, col, valid, r


def project_to_range_image(points, features, height: int, width: int, sensor: SensorConfig):
    """Batched packed projection: points (B, N, 3) [+ features (B, N, C)] ->
    range image (B, H, W, 3) [+ feature image (B, H, W, C)].

    Returns (xyz_image, feature_image); when ``features`` is None the feature
    image aliases the xyz image.  Safe only inside the 35 m-cropped network
    path (60 m range clip, < 2^18 points).
    """
    b, n, _ = points.shape
    if n >= (1 << _IDX_BITS):
        raise ValueError(f"packed projection supports < 2**18 points, got {n}")
    row, col, valid, r = pixel_coords(points, height, width, sensor)
    num_pix = height * width
    pix = torch.where(valid, row.long() * width + col.long(), num_pix)

    r_q = torch.clamp((r * (8191.0 / 60.0)).to(torch.int32), 0, 8191)
    idx = torch.arange(n, dtype=torch.int32, device=points.device).expand(b, n)
    key = torch.where(valid, (r_q << _IDX_BITS) | idx, _SENTINEL)

    win = torch.full((b, num_pix + 1), _SENTINEL, dtype=torch.int32, device=points.device)
    win.scatter_reduce_(1, pix, key, reduce="amin", include_self=True)
    win = win[:, :num_pix]
    has_point = (win != _SENTINEL)[..., None]
    winner = torch.clamp(win & ((1 << _IDX_BITS) - 1), 0, n - 1).long()

    def take(values):
        got = torch.gather(values, 1, winner[..., None].expand(-1, -1, values.shape[-1]))
        got = torch.where(has_point, got, torch.zeros((), dtype=got.dtype, device=got.device))
        return got.reshape(b, height, width, values.shape[-1])

    img = take(points)
    return img, (img if features is None else take(features))


def crop_and_project(points: torch.Tensor, sensor: SensorConfig) -> torch.Tensor:
    """Raw scans (B, N, 3) -> range images (B, H, W, 3), after the validity
    mask and the planar crop the network was trained with (eval inputs)."""
    valid = torch.any(points != 0.0, dim=-1)
    keep = valid & (torch.linalg.vector_norm(points[..., :2], dim=-1) <= sensor.max_planar_radius)
    img, _ = project_to_range_image(points * keep[..., None], None, sensor.height, sensor.width,
                                    sensor)
    return img
