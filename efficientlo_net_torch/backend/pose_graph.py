"""Windowed pose-graph optimization: Gauss-Newton on SE(3) with a Schur
marginalization prior.

Port of ``efficientlo_net_tpu/backend/pose_graph.py``:

* factor Jacobians from ``torch.func.jacfwd`` on the SE(3) Exp/Log residual
  under ``torch.func.vmap`` over factors (no hand-derived block formulas),
* normal-equation assembly as one scatter-add over all factors,
* sliding-window marginalization via Schur complement on the eliminated
  poses' blocks;
* with a process group, the (H, b, chi2) reduction runs distributed: each
  rank accumulates its contiguous share of the factors (and of the scan
  factors' points) and one all-reduce sums them, as the JAX package's
  ``shard_map`` with a ``psum`` does.

State convention: node i holds world_T_i (4, 4).  A factor (i, j, Z, w)
constrains Z ~ T_i^-1 T_j with residual r = Log(Z^-1 T_i^-1 T_j) and weight
w (scalar information multiplier; anisotropic 6x6 information also accepted).
Local update: T_i <- T_i Exp(delta_i).

Precision: every solver entry point (``optimize``, ``assemble_system``,
``_prior_contribution``, ``marginalize``) runs its body under
``full_fp32``, so float32 matmuls stay float32 on the card whatever the
caller set.  Reduced-precision operand passes are fine for the network and
catastrophic for normal equations: the JAX package measured 8.5 m of
position error on a 121-keyframe zero-residual chain before it forced full
precision.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..device import resolve_device
from ..ops import se3
from ..parallel.distributed import all_reduce_
from ..parallel.mesh import axis_group


@contextlib.contextmanager
def full_fp32():
    """float32 matmuls, bmm and einsum run in full float32 (no TF32) inside
    the block; the caller's ``torch.get_float32_matmul_precision()`` is
    restored on exit.  Usable as a decorator (``@full_fp32()``)."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


@dataclasses.dataclass
class FactorGraph:
    """Factor container, padded to a fixed capacity."""

    src: torch.Tensor      # (F,) int64 node index i
    dst: torch.Tensor      # (F,) int64 node index j
    meas: torch.Tensor     # (F, 4, 4) measured relative transform Z
    weight: torch.Tensor   # (F,) or (F, 6, 6) information weight
    valid: torch.Tensor    # (F,) float 1/0 padding mask
    # (F,) float 1/0: factors eligible for the IRLS robust kernel (all-ones
    # by default; e.g. loop closures only, keeping odometry-chain factors
    # quadratic: a chain link with a moderate residual must not deweight)
    robust_mask: torch.Tensor
    num_nodes: int


def make_factors(src, dst, meas, weight=None, num_nodes=None, capacity=None,
                 robust_mask=None, device="cuda") -> FactorGraph:
    """Factors from numpy-like arrays, padded with identity measurements of
    zero weight up to ``capacity``, on ``device``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    meas = np.asarray(meas, dtype=np.float32)
    f = len(src)
    if weight is None:
        weight = np.ones((f,), dtype=np.float32)
    weight = np.asarray(weight, dtype=np.float32)
    if robust_mask is None:
        robust_mask = np.ones((f,), dtype=np.float32)
    robust_mask = np.asarray(robust_mask, dtype=np.float32)
    if num_nodes is None:
        num_nodes = int(max(src.max(), dst.max())) + 1
    valid = np.ones((f,), dtype=np.float32)
    if capacity is not None and capacity > f:
        pad = capacity - f
        src = np.concatenate([src, np.zeros(pad, np.int64)])
        dst = np.concatenate([dst, np.zeros(pad, np.int64)])
        meas = np.concatenate([meas, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        wpad_shape = (pad,) + weight.shape[1:]
        weight = np.concatenate([weight, np.zeros(wpad_shape, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        robust_mask = np.concatenate([robust_mask, np.ones(pad, np.float32)])
    dev = resolve_device(device)
    return FactorGraph(
        *(torch.as_tensor(a, device=dev) for a in (src, dst, meas, weight, valid, robust_mask)),
        num_nodes=num_nodes,
    )


def factor_residual(t_i, t_j, z):
    """r = Log(Z^-1 T_i^-1 T_j), shape (..., 6)."""
    return se3.se3_log(se3.se3_inv(z) @ se3.se3_inv(t_i) @ t_j)


def _residual_and_jacobians(t_i, t_j, z):
    """Residual plus Jacobians w.r.t. local deltas of both endpoints."""

    def r_of(delta_i, delta_j):
        r = factor_residual(t_i @ se3.se3_exp(delta_i), t_j @ se3.se3_exp(delta_j), z)
        return r, r

    zero = torch.zeros((6,), dtype=t_i.dtype, device=t_i.device)
    # one forward-mode pass over both endpoints' 12 tangents; the residual
    # comes back as the auxiliary output
    (j_i, j_j), r = jacfwd(r_of, argnums=(0, 1), has_aux=True)(zero, zero)  # (6, 6) each
    return r, j_i, j_j


def scatter_blocks(h: torch.Tensor, blocks: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> None:
    """h[6 rows_f + a, 6 cols_f + c] += blocks[f, a, c] for every f, in
    place; rows / cols: (F,) node indices, blocks: (F, 6, 6)."""
    fi = torch.arange(6, device=h.device)
    rr = rows[:, None] * 6 + fi[None, :]          # (F, 6)
    cc = cols[:, None] * 6 + fi[None, :]
    h.index_put_((rr[:, :, None].expand(-1, 6, 6), cc[:, None, :].expand(-1, 6, 6)),
                 blocks, accumulate=True)


def _accumulate(poses, factors: FactorGraph, robust=None):
    """(H, b, chi2) from a block of factors, vectorized.

    ``robust = (kernel, delta)`` scales each factor's information by an IRLS
    weight of the whitened residual norm chi = ||r||_Sigma:

    * ``("huber", d)``: min(1, d/chi): bounds influence linearly; good for
      moderately heavy tails, still pulled by gross outliers.
    * ``("gm", d)``: Geman-McClure (d^2/(d^2+chi^2))^2: redescending: a
      false loop closure's weight decays as chi^-4, effectively switching
      the factor off (the "switchable constraints" behaviour).

    The reported chi2 is the corresponding robust cost rho(chi)."""
    t_i = poses[factors.src]
    t_j = poses[factors.dst]
    r, j_i, j_j = vmap(_residual_and_jacobians)(t_i, t_j, factors.meas)

    if factors.weight.dim() == 1:
        eye = torch.eye(6, dtype=r.dtype, device=r.device)
        info = factors.weight[:, None, None] * eye.expand(r.shape[0], 6, 6)
    else:
        info = factors.weight
    info = info * factors.valid[:, None, None]

    if robust is not None:
        kernel, delta = robust
        chi_sq = torch.clamp((r[:, None, :] @ info @ r[..., None])[:, 0, 0], min=1e-12)
        if kernel == "huber":
            chi_f = torch.sqrt(chi_sq)
            scale = torch.clamp(delta / chi_f, max=1.0)
            rho = torch.where(chi_f <= delta, chi_sq, delta * (2.0 * chi_f - delta))
        elif kernel == "gm":
            d2 = delta * delta
            scale = (d2 / (d2 + chi_sq)) ** 2
            rho = d2 * chi_sq / (d2 + chi_sq)
        else:
            raise ValueError(f"unknown robust kernel {kernel!r}")
        # factors outside robust_mask stay quadratic (scale 1, rho = chi^2)
        scale = torch.where(factors.robust_mask > 0, scale, torch.ones_like(scale))
        rho = torch.where(factors.robust_mask > 0, rho, chi_sq)
        info = info * scale[:, None, None]

    n = poses.shape[0]
    dim = 6 * n

    wr = (info @ r[..., None])[..., 0]          # (F, 6)
    chi2 = torch.sum(r * wr)
    if robust is not None:
        chi2 = torch.sum(rho * factors.valid)

    # block contributions
    j_i_t, j_j_t = j_i.transpose(-1, -2), j_j.transpose(-1, -2)
    h_ii = j_i_t @ info @ j_i   # (F, 6, 6)
    h_jj = j_j_t @ info @ j_j
    h_ij = j_i_t @ info @ j_j
    b_i = (j_i_t @ wr[..., None])[..., 0]
    b_j = (j_j_t @ wr[..., None])[..., 0]

    h = torch.zeros((dim, dim), dtype=r.dtype, device=r.device)
    scatter_blocks(h, h_ii, factors.src, factors.src)
    scatter_blocks(h, h_jj, factors.dst, factors.dst)
    scatter_blocks(h, h_ij, factors.src, factors.dst)
    scatter_blocks(h, h_ij.transpose(-1, -2), factors.dst, factors.src)

    bb = torch.zeros((n, 6), dtype=r.dtype, device=r.device)
    bb.index_add_(0, factors.src, b_i)
    bb.index_add_(0, factors.dst, b_j)
    return h, bb.reshape(-1), chi2


@dataclasses.dataclass(frozen=True)
class GaussNewtonConfig:
    iterations: int = 10
    damping: float = 1e-6
    prior_weight: float = 1e6  # gauge fix on node 0
    # IRLS robustification threshold on the whitened residual norm
    # ||r||_Sigma; None disables.  ~1.0 leaves healthy residuals untouched.
    robust_delta: Optional[float] = None
    # "huber" (bounded influence) or "gm" (Geman-McClure, redescending:
    # gross outliers such as false loop closures are switched off)
    robust_kernel: str = "huber"

    @property
    def robust(self):
        return None if self.robust_delta is None else (self.robust_kernel, self.robust_delta)


@dataclasses.dataclass
class PriorFactor:
    """Dense Gaussian prior left behind by Schur marginalization.

    Quadratic cost 0.5 d^T H d + b^T d over the stacked local deltas
    d_i = Log(lin_T_i^-1 T_i) of the covered nodes (right-multiplicative
    convention, matching the solver's update T <- T Exp(delta))."""

    node_ids: np.ndarray     # (m,) node indices (window-local)
    h: torch.Tensor          # (6m, 6m)
    b: torch.Tensor          # (6m,)
    lin_poses: torch.Tensor  # (m, 4, 4) linearization points

    def shifted(self, new_ids: np.ndarray) -> "PriorFactor":
        """Same prior, re-labelled with new node indices."""
        return PriorFactor(node_ids=np.asarray(new_ids), h=self.h, b=self.b,
                           lin_poses=self.lin_poses)


def _block_ids(nodes, device) -> torch.Tensor:
    """Row indices 6 i + (0..5) of the nodes' blocks, as an int64 tensor."""
    ids = (np.asarray(nodes, dtype=np.int64)[:, None] * 6 + np.arange(6)[None, :]).reshape(-1)
    return torch.as_tensor(ids, device=device)


@full_fp32()
def _prior_contribution(poses, prior: PriorFactor):
    """(H_add, b_add, chi2_add) of the marginalization prior at ``poses``."""
    n = poses.shape[0]
    dim = 6 * n
    sel = _block_ids(prior.node_ids, poses.device)
    t = poses[torch.as_tensor(np.asarray(prior.node_ids, dtype=np.int64), device=poses.device)]
    lin = prior.lin_poses.to(poses.dtype)
    delta = se3.se3_log(se3.se3_inv(lin) @ t).reshape(-1)   # (6m,)
    grad = prior.b + prior.h @ delta                        # d/d(delta) of the cost
    chi2 = 0.5 * delta @ prior.h @ delta + prior.b @ delta

    h_add = torch.zeros((dim, dim), dtype=poses.dtype, device=poses.device)
    h_add.index_put_((sel[:, None].expand(-1, len(sel)), sel[None, :].expand(len(sel), -1)),
                     prior.h.to(poses.dtype), accumulate=True)
    b_add = torch.zeros((dim,), dtype=poses.dtype, device=poses.device)
    b_add.index_add_(0, sel, grad.to(poses.dtype))
    return h_add, b_add, chi2


def _solve_step(poses, factors, cfg: GaussNewtonConfig, reduce_fn, prior=None,
                scan_terms=None):
    h, b, chi2 = reduce_fn(poses, factors)
    n = poses.shape[0]
    dim = 6 * n
    if scan_terms is not None:
        scan_factors, scan_reduce = scan_terms
        h_s, b_s, chi2_s = scan_reduce(poses, scan_factors)
        h = h + h_s
        b = b + b_s
        chi2 = chi2 + chi2_s
    if prior is not None:
        h_p, b_p, chi2_p = _prior_contribution(poses, prior)
        h = h + h_p
        b = b + b_p
        chi2 = chi2 + chi2_p
    # gauge prior on node 0
    gauge = torch.zeros((dim,), dtype=h.dtype, device=h.device)
    gauge[:6] = cfg.prior_weight
    h = h + torch.diag(gauge) + cfg.damping * torch.eye(dim, dtype=h.dtype, device=h.device)
    delta = torch.linalg.solve(h, -b).reshape(n, 6)
    return poses @ se3.se3_exp(delta), chi2


@full_fp32()
def optimize(
    poses: torch.Tensor,
    factors: FactorGraph,
    cfg: GaussNewtonConfig = GaussNewtonConfig(),
    prior: Optional[PriorFactor] = None,
    scan_factors=None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the window, on ``poses``' device.  Returns (poses,
    chi2 history (iterations,)): entry k is the cost at the poses step k
    started from.

    ``prior`` carries marginalized keyframes' information (see PriorFactor).
    ``scan_factors`` (a ``scan_factors.ScanFactorSet``) adds point-to-plane
    residuals from the keyframes' range images, re-linearized every
    iteration.  ``group`` (a process group, or a one-dimensional
    ``DeviceMesh``) shards the factor axis, and the scan factors' point
    axis, over its ranks, each passing the same arguments; the factor
    capacity and the point count must divide by its size.  Every rank
    returns the same poses.
    """
    from .scan_factors import accumulate_scan_factors, make_distributed_scan_reduce

    group = axis_group(group)
    if group is None:
        reduce_fn = functools.partial(_accumulate, robust=cfg.robust)
        scan_reduce = accumulate_scan_factors
    else:
        reduce_fn = _make_distributed_reduce(group, robust=cfg.robust)
        scan_reduce = make_distributed_scan_reduce(group)
    scan_terms = None if scan_factors is None else (scan_factors, scan_reduce)
    history = []
    for _ in range(cfg.iterations):
        poses, chi2 = _solve_step(poses, factors, cfg, reduce_fn, prior, scan_terms)
        history.append(chi2)
    return poses, torch.stack(history)


def _share(n: int, group, what: str) -> slice:
    """This rank's contiguous share of ``n`` items over ``group``."""
    rank, size = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    if n % size:
        raise ValueError(f"{what} of {n} does not split over {size} ranks")
    return slice(rank * n // size, (rank + 1) * n // size)


def reduce_system(h, b, chi2, group):
    """(H, b, chi2) summed over the ranks of ``group``: one all-reduce."""
    flat = all_reduce_(torch.cat([h.reshape(-1), b, chi2.reshape(1)]), group)
    return flat[:h.numel()].view_as(h), flat[h.numel():-1], flat[-1]


def _make_distributed_reduce(group, robust=None):
    def reduce_fn(poses, factors: FactorGraph):
        share = _share(factors.src.shape[0], group, "the factor capacity")
        block = FactorGraph(src=factors.src[share], dst=factors.dst[share],
                            meas=factors.meas[share], weight=factors.weight[share],
                            valid=factors.valid[share], robust_mask=factors.robust_mask[share],
                            num_nodes=factors.num_nodes)
        return reduce_system(*_accumulate(poses, block, robust=robust), group)

    return reduce_fn


# ---------------------------------------------------------------------------
# sliding-window marginalization (Schur complement)
# ---------------------------------------------------------------------------

@full_fp32()
def marginalize(h: torch.Tensor, b: torch.Tensor, keep: np.ndarray,
                drop: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schur-complement elimination of the ``drop`` nodes from (H, b).

    Returns the reduced system over ``keep`` nodes:
      H' = H_kk - H_kd H_dd^-1 H_dk,   b' = b_k - H_kd H_dd^-1 b_d
    the information-preserving prior left behind when old keyframes leave
    the window.
    """
    ki = _block_ids(keep, h.device)
    di = _block_ids(drop, h.device)
    h_kk = h[ki[:, None], ki[None, :]]
    h_kd = h[ki[:, None], di[None, :]]
    h_dd = h[di[:, None], di[None, :]]
    b_k = b[ki]
    b_d = b[di]
    # small diagonal regularization for numerical stability
    h_dd = h_dd + 1e-8 * torch.eye(h_dd.shape[0], dtype=h.dtype, device=h.device)
    sol = torch.linalg.solve(h_dd, torch.cat([h_kd.T, b_d[:, None]], dim=1))
    h_dd_inv_h_dk = sol[:, :-1]
    h_dd_inv_b_d = sol[:, -1]
    return h_kk - h_kd @ h_dd_inv_h_dk, b_k - h_kd @ h_dd_inv_b_d


@full_fp32()
def assemble_system(poses, factors: FactorGraph):
    """Public (H, b, chi2) assembly, for marginalization workflows."""
    return _accumulate(poses, factors)
