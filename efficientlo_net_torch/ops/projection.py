"""Cylindrical range-image projection.

Port of ``efficientlo_net_tpu/ops/projection.py``: ``pixel_coords`` with the
same truncation toward zero, and the three ways to pick each pixel's point:

* ``sort`` (the default, exact): a stable sort of the points by (pixel,
  range) and a binary search for each pixel's first point;
* ``scatter`` (exact): a float scatter-min of the range per pixel, then an
  int scatter-min of the index among the points at that minimum;
* ``packed``: one int32 scatter-min over the key ``(r_q << 18) | idx``
  (13-bit range quantization in 7.3 mm steps over 0-60 m, 18-bit point
  index).  Within one quantization step, and everywhere beyond 60 m, the
  lowest point index wins, not the nearest point.  Safe only inside the
  35 m-cropped network path, which names it.

The exact methods keep the nearest point of each pixel, ties to the lowest
point index, so they give the same image bit for bit.  Invalid points
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


def _winners_sort(pix, valid, r, num_pix):
    """(B, num_pix) winning point index and occupancy: the batch is one
    stable sort by range, then by pixel id (each cloud's ids offset by its
    batch index), so each pixel's run starts at its nearest point, ties in
    index order; ``searchsorted`` finds the runs."""
    b, n = pix.shape
    seg = num_pix + 1  # the invalid points' sentinel pixel closes each cloud's segment
    key = pix + seg * torch.arange(b, device=pix.device)[:, None]
    by_range = torch.sort(r.reshape(-1), stable=True).indices
    key_s, by_key = torch.sort(key.reshape(-1)[by_range], stable=True)
    order = by_range[by_key]
    want = (torch.arange(num_pix, device=pix.device)
            + seg * torch.arange(b, device=pix.device)[:, None]).reshape(-1)
    pos = torch.clamp(torch.searchsorted(key_s, want), max=b * n - 1)
    found = key_s[pos] == want
    winner = order[pos] - n * torch.arange(b, device=pix.device).repeat_interleave(num_pix)
    # an empty pixel's search ends in another pixel's run, maybe another cloud's
    winner = torch.where(found, winner, 0)
    return winner.reshape(b, num_pix), found.reshape(b, num_pix)


def _winners_scatter(pix, valid, r, num_pix):
    """(B, num_pix) winning point index and occupancy: the least range per
    pixel by one float scatter-min, then the least index among the points
    at that range by an int scatter-min."""
    b, n = pix.shape
    inf = torch.full((), math.inf, dtype=r.dtype, device=r.device)
    r_masked = torch.where(valid, r, inf)
    min_r = torch.full((b, num_pix + 1), math.inf, dtype=r.dtype, device=r.device)
    min_r.scatter_reduce_(1, pix, r_masked, reduce="amin", include_self=True)
    is_min = valid & (r_masked <= torch.gather(min_r, 1, pix))
    idx = torch.arange(n, device=pix.device).expand(b, n)
    cand = torch.where(is_min, idx, n)
    win = torch.full((b, num_pix + 1), n, dtype=torch.int64, device=pix.device)
    win.scatter_reduce_(1, pix, cand, reduce="amin", include_self=True)
    win = win[:, :num_pix]
    return torch.clamp(win, max=n - 1), win < n


def _winners_packed(pix, valid, r, num_pix):
    """(B, num_pix) winning point index and occupancy from one int32
    scatter-min of the packed (quantized range, index) key."""
    b, n = pix.shape
    if n >= (1 << _IDX_BITS):
        raise ValueError(f"packed projection supports < 2**18 points, got {n}")
    r_q = torch.clamp((r * (8191.0 / 60.0)).to(torch.int32), 0, 8191)
    idx = torch.arange(n, dtype=torch.int32, device=pix.device).expand(b, n)
    key = torch.where(valid, (r_q << _IDX_BITS) | idx, _SENTINEL)
    win = torch.full((b, num_pix + 1), _SENTINEL, dtype=torch.int32, device=pix.device)
    win.scatter_reduce_(1, pix, key, reduce="amin", include_self=True)
    win = win[:, :num_pix]
    return torch.clamp(win & ((1 << _IDX_BITS) - 1), 0, n - 1).long(), win != _SENTINEL


_WINNERS = {"sort": _winners_sort, "scatter": _winners_scatter, "packed": _winners_packed}


def project_to_range_image(points, features, height: int, width: int, sensor: SensorConfig,
                           method: str = "sort"):
    """Batched projection: points (B, N, 3) [+ features (B, N, C)] ->
    range image (B, H, W, 3) [+ feature image (B, H, W, C)].

    Returns (xyz_image, feature_image); when ``features`` is None the feature
    image aliases the xyz image.  ``method``: "sort" (exact, the default),
    "scatter" (exact, the same image) or "packed" (7.3 mm range
    quantization, 60 m clip, < 2^18 points: the 35 m-cropped network path
    names it).  Gradients reach the winning points and features.
    """
    if method not in _WINNERS:
        raise ValueError(f"unknown projection method {method!r}; one of {tuple(_WINNERS)}")
    b, n, _ = points.shape
    row, col, valid, r = pixel_coords(points, height, width, sensor)
    num_pix = height * width
    pix = torch.where(valid, row.long() * width + col.long(), num_pix)
    winner, has_point = _WINNERS[method](pix, valid, r, num_pix)
    has_point = has_point[..., None]

    def take(values):
        got = torch.gather(values, 1, winner[..., None].expand(-1, -1, values.shape[-1]))
        got = torch.where(has_point, got, torch.zeros((), dtype=got.dtype, device=got.device))
        return got.reshape(b, height, width, values.shape[-1])

    img = take(points)
    return img, (img if features is None else take(features))


def crop_and_project(points: torch.Tensor, sensor: SensorConfig) -> torch.Tensor:
    """Raw scans (B, N, 3) -> range images (B, H, W, 3), after the validity
    mask and the planar crop the network was trained with (eval inputs);
    the crop makes the packed method safe."""
    valid = torch.any(points != 0.0, dim=-1)
    keep = valid & (torch.linalg.vector_norm(points[..., :2], dim=-1) <= sensor.max_planar_radius)
    img, _ = project_to_range_image(points * keep[..., None], None, sensor.height, sensor.width,
                                    sensor, method="packed")
    return img
