"""Point-to-plane scan factors from range images.

Port of ``efficientlo_net_tpu/backend/scan_factors.py``, with its
map-block reduction over a process group.  Keyframe range
images contribute geometric residuals to the window optimization:

* surface normals estimated directly on the ordered (H, W) range image:
  cross product of azimuth/elevation central differences, with cylindrical
  W wrap;
* projective data association: frame-j points are warped by the current
  relative pose and looked up in frame i's range image (one gather per
  point: the range image *is* the spatial index);
* residual per correspondence: r = n_i . (T_i^-1 T_j p_j - q_i), the
  point-to-plane distance, with Jacobians from ``torch.func.jacfwd`` on the
  SE(3) right-delta (the convention of ``backend/pose_graph.py``), batched
  over points and pairs by ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import jacfwd, vmap

from ..config import SensorConfig
from ..ops import se3
from ..ops.projection import pixel_coords
from .pose_graph import _share, full_fp32, reduce_system, scatter_blocks

_VALID_EPS = 1e-10


def _roll_rows(x: torch.Tensor, down: bool) -> torch.Tensor:
    """Shift along H by one, clamping at the edge (no wrap)."""
    return torch.cat([x[1:], x[-1:]]) if down else torch.cat([x[:1], x[:-1]])


def compute_normals(xyz_img: torch.Tensor, min_norm: float = 1e-6,
                    planarity_tol: float = 0.1):
    """Per-pixel surface normals of a (H, W, 3) range image.

    n = normalize(d_azimuth x d_elevation) via central differences; the W
    axis wraps cylindrically, the H axis clamps.  Returns (normals (H, W, 3),
    valid (H, W) bool); normals are zero where invalid.  Sign is made
    consistent by orienting every normal toward the sensor origin.

    ``planarity_tol`` (meters) rejects pixels whose 4-neighbourhood does not
    lie on the fitted plane, i.e. depth-discontinuity and surface-boundary
    pixels, whose cross-product "normals" would bias point-to-plane
    residuals.
    """
    valid = torch.sum(xyz_img * xyz_img, dim=-1) > _VALID_EPS

    left = torch.roll(xyz_img, 1, dims=1)
    right = torch.roll(xyz_img, -1, dims=1)
    up = _roll_rows(xyz_img, down=False)
    down = _roll_rows(xyz_img, down=True)
    v_l = torch.roll(valid, 1, dims=1)
    v_r = torch.roll(valid, -1, dims=1)
    v_u = _roll_rows(valid, down=False)
    v_d = _roll_rows(valid, down=True)

    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = valid & v_l & v_r & v_u & v_d & (norm[..., 0] > min_norm)
    zero = torch.zeros((), dtype=n.dtype, device=n.device)
    n = torch.where(ok[..., None], n / torch.clamp(norm, min=min_norm), zero)
    # planarity: all 4 neighbours must lie on the plane through the centre
    flat = torch.stack(
        [torch.abs(torch.sum(n * (nb - xyz_img), dim=-1)) for nb in (left, right, up, down)]
    ).amax(dim=0)
    ok = ok & (flat <= planarity_tol)
    n = torch.where(ok[..., None], n, zero)
    # orient toward the sensor: n . p < 0 (p points away from origin)
    flip = torch.sum(n * xyz_img, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n), ok


@dataclasses.dataclass
class Correspondences:
    """Fixed-size point-to-plane correspondence block for one scan pair."""

    p_j: torch.Tensor   # (P, 3) points in frame j
    q_i: torch.Tensor   # (P, 3) anchor points in frame i
    n_i: torch.Tensor   # (P, 3) unit normals in frame i
    w: torch.Tensor     # (P,) weights (0 = padding / rejected)

    def subsampled(self, stride: int, scale: float = 1.0) -> "Correspondences":
        """Every ``stride``-th correspondence, weights times ``scale``."""
        return Correspondences(p_j=self.p_j[::stride], q_i=self.q_i[::stride],
                               n_i=self.n_i[::stride], w=self.w[::stride] * scale)


def _lookup(p_in_i, xyz_i, normals_i, sensor):
    """Frame-i anchor point and normal at each warped point's pixel, and
    the projection's validity."""
    h, w, _ = xyz_i.shape
    row, col, valid_proj, _ = pixel_coords(p_in_i, h, w, sensor)
    flat = row.long() * w + col.long()
    return xyz_i.reshape(-1, 3)[flat], normals_i.reshape(-1, 3)[flat], valid_proj


def _anchor_valid(q, n):
    return (torch.sum(q * q, dim=-1) > _VALID_EPS) & (torch.sum(n * n, dim=-1) > 0.5)


@full_fp32()
def projective_association(
    xyz_j: torch.Tensor,
    xyz_i: torch.Tensor,
    normals_i: torch.Tensor,
    t_ij: torch.Tensor,
    sensor: SensorConfig,
    max_dist: float = 1.0,
    normals_j: Optional[torch.Tensor] = None,
    min_normal_dot: float = 0.8,
    max_plane_dist: Optional[float] = None,
) -> Correspondences:
    """Associate every valid frame-j pixel with a frame-i surface patch.

    xyz_j / xyz_i: (H, W, 3) range images; t_ij: (4, 4) current estimate of
    i_T_j.  Frame-j points are warped into frame i, projected onto frame i's
    grid (``pixel_coords``: the same truncation semantics as the network's
    re-projections), and matched with the anchor point + normal at that
    pixel.  All shapes static: P = H * W.

    Gating (each rejected pair gets weight 0):
      * euclidean distance > ``max_dist``;
      * |point-to-plane distance| > ``max_plane_dist`` (defaults to
        ``max_dist / 2``: rejects cross-plane matches that bias the
        optimum);
      * when ``normals_j`` is given: rotated frame-j normal disagreeing with
        the anchor normal (dot < ``min_normal_dot``), the standard
        normal-consistency filter.
    """
    p = xyz_j.reshape(-1, 3)
    valid_j = torch.sum(p * p, dim=-1) > _VALID_EPS
    p_in_i = p @ t_ij[:3, :3].T + t_ij[:3, 3]
    q, n, valid_proj = _lookup(p_in_i, xyz_i, normals_i, sensor)
    dist = torch.linalg.vector_norm(p_in_i - q, dim=-1)
    plane_dist = torch.abs(torch.sum(n * (p_in_i - q), dim=-1))
    if max_plane_dist is None:
        max_plane_dist = max_dist / 2.0
    ok = valid_j & valid_proj & _anchor_valid(q, n) & (dist <= max_dist) & (
        plane_dist <= max_plane_dist)
    if normals_j is not None:
        nj = normals_j.reshape(-1, 3) @ t_ij[:3, :3].T
        ok = ok & (torch.sum(n * nj, dim=-1) >= min_normal_dot)
    return Correspondences(p_j=p, q_i=q, n_i=n, w=ok.to(xyz_j.dtype))


@dataclasses.dataclass
class ScanFactorSet:
    """Point-to-plane factors between window nodes (padded, static shapes)."""

    src: torch.Tensor   # (S,) int64 node i (anchor frame)
    dst: torch.Tensor   # (S,) int64 node j (point frame)
    p_j: torch.Tensor   # (S, P, 3)
    q_i: torch.Tensor   # (S, P, 3)
    n_i: torch.Tensor   # (S, P, 3)
    w: torch.Tensor     # (S, P)


def make_scan_factors(pairs, correspondences) -> ScanFactorSet:
    """pairs: [(i, j)] node ids; correspondences: [Correspondences], all on
    one device."""
    dev = correspondences[0].p_j.device
    return ScanFactorSet(
        src=torch.as_tensor([p[0] for p in pairs], dtype=torch.int64, device=dev),
        dst=torch.as_tensor([p[1] for p in pairs], dtype=torch.int64, device=dev),
        p_j=torch.stack([c.p_j for c in correspondences]),
        q_i=torch.stack([c.q_i for c in correspondences]),
        n_i=torch.stack([c.n_i for c in correspondences]),
        w=torch.stack([c.w for c in correspondences]),
    )


def _point_residual(t_i, t_j, p, q, n):
    """r = n . (T_i^-1 T_j p - q); scalar."""
    x_w = t_j[:3, :3] @ p + t_j[:3, 3]
    x_i = t_i[:3, :3].T @ (x_w - t_i[:3, 3])
    return torch.dot(n, x_i - q)


def _point_residual_and_jacobians(t_i, t_j, p, q, n):
    """Residual + Jacobians w.r.t. right-multiplicative deltas of both
    poses (same convention as pose_graph._residual_and_jacobians)."""

    def r_of(d_i, d_j):
        r = _point_residual(t_i @ se3.se3_exp(d_i), t_j @ se3.se3_exp(d_j), p, q, n)
        return r, r

    zero = torch.zeros((6,), dtype=t_i.dtype, device=t_i.device)
    (j_i, j_j), r = jacfwd(r_of, argnums=(0, 1), has_aux=True)(zero, zero)  # (6,) each
    return r, j_i, j_j


def _pair_blocks(t_i, t_j, p_j, q_i, n_i, w):
    """One scan pair's weighted normal-equation blocks, reduced over points.

    Returns (h_ii, h_ij, h_jj (6,6), b_i, b_j (6,), chi2).
    """
    r, j_i, j_j = vmap(_point_residual_and_jacobians, in_dims=(None, None, 0, 0, 0))(
        t_i, t_j, p_j, q_i, n_i)
    wr = w * r
    h_ii = torch.einsum("p,pa,pb->ab", w, j_i, j_i)
    h_jj = torch.einsum("p,pa,pb->ab", w, j_j, j_j)
    h_ij = torch.einsum("p,pa,pb->ab", w, j_i, j_j)
    b_i = torch.einsum("pa,p->a", j_i, wr)
    b_j = torch.einsum("pa,p->a", j_j, wr)
    chi2 = torch.sum(wr * r)
    return h_ii, h_ij, h_jj, b_i, b_j, chi2


def accumulate_scan_factors(poses, sf: ScanFactorSet):
    """(H, b, chi2) over the window from all scan factors: vectorized over
    pairs, reduced over points."""
    t_i = poses[sf.src]
    t_j = poses[sf.dst]
    h_ii, h_ij, h_jj, b_i, b_j, chi2 = vmap(_pair_blocks)(t_i, t_j, sf.p_j, sf.q_i, sf.n_i, sf.w)

    n = poses.shape[0]
    h = torch.zeros((6 * n, 6 * n), dtype=poses.dtype, device=poses.device)
    scatter_blocks(h, h_ii, sf.src, sf.src)
    scatter_blocks(h, h_jj, sf.dst, sf.dst)
    scatter_blocks(h, h_ij, sf.src, sf.dst)
    scatter_blocks(h, h_ij.transpose(-1, -2), sf.dst, sf.src)

    b = torch.zeros((n, 6), dtype=poses.dtype, device=poses.device)
    b.index_add_(0, sf.src, b_i)
    b.index_add_(0, sf.dst, b_j)
    return h, b.reshape(-1), torch.sum(chi2)


def make_distributed_scan_reduce(group):
    """Map-block partitioning: each rank of ``group`` (a process group)
    reduces its contiguous share of every scan factor's point axis, and one
    all-reduce assembles the window system.  Returns ``reduce_fn(poses, sf)
    -> (H, b, chi2)``, the same on every rank."""

    def reduce_fn(poses, sf: ScanFactorSet):
        share = _share(sf.p_j.shape[1], group, "the scan factors' point count")
        block = ScanFactorSet(src=sf.src, dst=sf.dst, p_j=sf.p_j[:, share], q_i=sf.q_i[:, share],
                              n_i=sf.n_i[:, share], w=sf.w[:, share])
        return reduce_system(*accumulate_scan_factors(poses, block), group)

    return reduce_fn


def correspondences_for_pair(
    xyz_i: torch.Tensor,
    xyz_j: torch.Tensor,
    t_i: torch.Tensor,
    t_j: torch.Tensor,
    sensor: SensorConfig,
    max_dist: float = 1.0,
    subsample: Optional[int] = None,
) -> Correspondences:
    """Convenience: normals on both frames + normal-gated projective
    association of frame j at the current estimate i_T_j = T_i^-1 T_j."""
    normals, _ = compute_normals(xyz_i)
    normals_j, _ = compute_normals(xyz_j)
    t_ij = se3.se3_inv(t_i) @ t_j
    corr = projective_association(xyz_j, xyz_i, normals, t_ij, sensor, max_dist,
                                  normals_j=normals_j)
    return corr.subsampled(subsample) if subsample else corr


# ---------------------------------------------------------------------------
# pairwise ICP refinement (loop-closure measurement sharpening)
# ---------------------------------------------------------------------------

@full_fp32()
def icp_refine(
    xyz_i: torch.Tensor,
    xyz_j: torch.Tensor,
    t_ij0: torch.Tensor,
    sensor: SensorConfig,
    iters: int = 12,
    max_dist: float = 2.0,
    subsample: int = 2,
):
    """Point-to-plane ICP between two range images on their device,
    re-associating every iteration, starting from ``t_ij0`` (an initial
    guess of i_T_j, e.g. a loop-closure measurement from the odometry
    network).

    The network is trained on consecutive-frame motion (~0.6-0.9 m); a
    revisit pair sits meters apart, so its raw measurement is only a seed.
    This polishes it against the actual surfaces (the same projective
    association + point-to-plane residual the window scan factors use) and
    returns diagnostics for acceptance gating, as tensors:

        (t_ij, inlier_frac, rms)

    * ``inlier_frac``: fraction of valid frame-j pixels that associated in
      the final iteration (0 when the pair does not overlap);
    * ``rms``: weighted RMS point-to-plane residual (meters) at the result.

    Left-multiplicative update: T <- Exp(delta) T with delta = (v, w)
    (se3.se3_exp twist ordering), so each row's Jacobian is
    J = [n, (T p) x n].
    """
    normals_i, _ = compute_normals(xyz_i)
    normals_j, _ = compute_normals(xyz_j)
    s = max(1, subsample)
    p_all = xyz_j.reshape(-1, 3)[::s]
    nj_all = normals_j.reshape(-1, 3)[::s]
    valid_j = torch.sum(p_all * p_all, dim=-1) > _VALID_EPS
    n_valid = torch.clamp(torch.sum(valid_j.to(torch.float32)), min=1.0)
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=xyz_i.device)

    def associate(t):
        y = p_all @ t[:3, :3].T + t[:3, 3]
        q, n, valid_proj = _lookup(y, xyz_i, normals_i, sensor)
        dist = torch.linalg.vector_norm(y - q, dim=-1)
        r = torch.sum(n * (y - q), dim=-1)
        nj_rot = nj_all @ t[:3, :3].T
        ok = (valid_j & valid_proj & _anchor_valid(q, n)
              & (dist <= max_dist) & (torch.abs(r) <= max_dist / 2.0)
              & (torch.sum(n * nj_rot, dim=-1) >= 0.8))
        return y, q, n, r, ok.to(xyz_i.dtype)

    t = t_ij0.to(torch.float32)
    for _ in range(iters):
        y, q, n, r, wgt = associate(t)
        jac = torch.cat([n, torch.linalg.cross(y, n, dim=-1)], dim=-1)   # (P, 6)
        a = (jac * wgt[:, None]).T @ jac + eye6
        g = (jac * wgt[:, None]).T @ r
        t = se3.se3_exp(-torch.linalg.solve(a, g)) @ t
    _, _, _, r, wgt = associate(t)
    inlier_frac = torch.sum(wgt) / n_valid
    rms = torch.sqrt(torch.sum(wgt * r * r) / torch.clamp(torch.sum(wgt), min=1.0))
    return t, inlier_frac, rms

