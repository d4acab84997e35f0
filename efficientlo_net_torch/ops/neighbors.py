"""Windowed neighbour selection over the ordered cylindrical range image.

Port of ``efficientlo_net_tpu/ops/neighbors.py``.  For every centre of the
centre-strided grid, scan a static (kh, kw) window of the source grid (W
wraps round the cylinder, rows outside the grid are invalid), keep the
candidates that are valid (non-zero) and within a radius of a valid centre,
and return the first K in scan order (``FIRST_K``, optionally in a permuted
scan order) or the K nearest (``KNN``, ties to the lowest window slot).

``select_neighbors`` and ``select_and_group`` call the ``torch.library``
operators that ``window_select`` registers: for CUDA tensors they launch its
CUDA kernels, for CPU tensors they run the plain PyTorch versions
(``*_plain``).  The plain versions are also the reference the kernels are
checked against.  The selects carry no gradient (indices and masks);
``gather_by_index`` carries it into the gathered values.  Inside
``plain_selects()`` both run the plain versions inline, with no operator:
``serving.export`` traces a portable artifact so.  Each call counts
``select.<mode>`` in ``utils.profiling``, whichever version runs: while
recording, the count is filed under the innermost open span, which names
the call's place in the network.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling

FIRST_K = "first_k"
KNN = "knn"

_VALID_EPS = 1e-10
_inline_plain = contextvars.ContextVar("plain_selects", default=False)


def _sq3(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over the last axis of size 3, summed as (x*x + y*y) + z*z: the
    CUDA kernels use the same order, so validity, radius and KNN decisions
    agree bit for bit."""
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


def window_offsets(kernel_h: int, kernel_w: int) -> np.ndarray:
    """(T, 2) window offsets (row, column) in kernel raster order: slot t is
    (t // kw - kh // 2, t % kw - kw // 2)."""
    kh_half, kw_half = kernel_h // 2, kernel_w // 2
    idx = np.arange(kernel_h * kernel_w)
    return np.stack([idx // kernel_w - kh_half, idx % kernel_w - kw_half], axis=-1)


def grid_centers(height: int, width: int, stride_h: int = 1, stride_w: int = 1) -> np.ndarray:
    """(N, 2) int32 centre coordinates (row, column): every (stride_h,
    stride_w)-th pixel of a (height, width) grid, in raster order."""
    hh = np.arange(0, height, stride_h)
    ww = np.arange(0, width, stride_w)
    h_grid, w_grid = np.meshgrid(hh, ww, indexing="ij")
    return np.stack([h_grid.reshape(-1), w_grid.reshape(-1)], axis=-1).astype(np.int32)


def _window_index(h1, w1, h2, w2, kernel_size, center_stride, source_stride, device):
    """Flat grid-2 index (N, T) of every window slot of every centre, and
    whether its row lies inside grid 2.  Centre (i, j) is grid-1 pixel
    (i*csh, j*csw); its window is based at ((i*csh)//sh, (j*csw)//sw)."""
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


def window_candidates(src, kernel_size, center_stride=(1, 1), source_stride=(1, 1),
                      centre_hw=None):
    """Window candidates of ``src`` (B, H2, W2, C): returns (cand (B, N, T, C),
    flat (N, T)), a gather over the W-wrapped grid with the flat grid-2 index
    of every slot.  Slots on rows outside the grid are zero vectors, i.e.
    invalid candidates.  ``centre_hw`` is the (H1, W1) of the centre grid
    (default: the source's own)."""
    b, h2, w2, c = src.shape
    h1, w1 = centre_hw or (h2, w2)
    flat, in_bounds = _window_index(
        h1, w1, h2, w2, kernel_size, center_stride, source_stride, src.device
    )
    cand = src.reshape(b, h2 * w2, c)[:, flat]
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    return torch.where(in_bounds[None, :, :, None], cand, zero), flat


def _iterative_top_k(scores: torch.Tensor, k: int):
    """Top-k over the last axis, ties to the lowest index: a stable
    descending sort, cut at k."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds the window's {scores.shape[-1]} slots")
    vals, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def candidate_mask(xyz1, xyz2, kernel_size, distance, center_stride=(1, 1),
                   source_stride=(1, 1)):
    """The window test of every slot: returns (ok (B, N, T) bool, d_sq
    (B, N, T), flat (N, T)).  A slot counts if the centre and the candidate
    are valid (|p|^2 > 1e-10) and max(d^2, 1e-10) <= distance^2."""
    b, h1, w1, _ = xyz1.shape
    csh, csw = center_stride
    cand, flat = window_candidates(
        xyz2, kernel_size, center_stride, source_stride, centre_hw=(h1, w1)
    )  # (B, N, T, 3), (N, T)
    centre = xyz1[:, ::csh, ::csw].reshape(b, flat.shape[0], 1, 3)
    d_sq = torch.clamp(_sq3(cand - centre), min=_VALID_EPS)
    ok = (
        (_sq3(cand) > _VALID_EPS)
        & (d_sq <= distance * distance)
        & (_sq3(centre) > _VALID_EPS)
    )
    return ok, d_sq, flat


def select_neighbors_plain(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    center_stride: Tuple[int, int] = (1, 1),
    source_stride: Tuple[int, int] = (1, 1),
    mode: str = KNN,
    perm: Optional[torch.Tensor] = None,
):
    """Plain PyTorch select.  Returns (idx (B, N, K) int32 flat into H2*W2,
    0 where masked; mask (B, N, K, 1) float).  The K slots come in scan order
    (FIRST_K) or ascending distance (KNN)."""
    ok, d_sq, flat = candidate_mask(
        xyz1, xyz2, kernel_size, distance, center_stride, source_stride
    )
    b, n, t = ok.shape

    if mode == FIRST_K:
        # score = T - scan position; with a permuted scan order the position
        # of window slot s is inv_perm[s]
        pos = torch.arange(t, device=xyz1.device)
        if perm is not None:
            pos = torch.argsort(torch.as_tensor(perm, device=xyz1.device))
        score = torch.where(ok, (t - pos).to(torch.float32), -1.0)
        threshold = 0.0
    elif mode == KNN:
        score = torch.where(ok, -d_sq, -torch.inf)
        threshold = -torch.inf
    else:
        raise ValueError(f"unknown mode {mode!r}")

    top_scores, top_t = _iterative_top_k(score, k)
    mask = top_scores > threshold
    idx = torch.gather(flat.expand(b, n, t), 2, top_t)
    idx = torch.where(mask, idx, 0).to(torch.int32)
    return idx, mask[..., None].to(xyz1.dtype)


def fill_empty_slots_with_first(idx: torch.Tensor, mask: torch.Tensor):
    """The reference CUDA ops' ``flag_copy=1`` mode: every empty slot of a
    centre that selected anything takes its first neighbour, and its mask
    becomes full.  idx (B, N, K), mask (B, N, K, 1); returns both.  No call
    site of the network uses it (they all select with ``flag_copy=0``)."""
    has_any = mask[:, :, :1, :] > 0   # slot 0 is filled iff any slot is
    filled = torch.where(mask[..., 0] > 0, idx, idx[:, :, :1])
    new_mask = torch.where(has_any, torch.ones_like(mask), mask)
    return torch.where(has_any[..., 0], filled, idx), new_mask


def select_neighbors_at(xyz1, xyz2, centers_hw, kernel_size, k, distance, stride=(1, 1),
                        mode=KNN, perm=None):
    """The plain select at explicit centres, a test oracle: ``centers_hw``
    (N, 2) holds any grid-1 pixels (row, column), not only a strided grid;
    centre (h, w) scans the window of grid 2 based at (h // sh, w // sw) of
    ``stride``, in the scan order ``perm`` permutes.  Returns (idx (B, N, K)
    int32 flat into H2*W2, 0 where masked; mask (B, N, K, 1))."""
    b, h1, w1, _ = xyz1.shape
    _, h2, w2, _ = xyz2.shape
    kh, kw = kernel_size
    t = kh * kw
    sh, sw = stride
    dev = xyz1.device
    centres = torch.as_tensor(centers_hw, dtype=torch.long, device=dev)
    offs = torch.as_tensor(window_offsets(kh, kw), device=dev)
    if perm is not None:
        offs = offs[torch.as_tensor(perm, device=dev).long()]
    cand_h = (centres[:, 0] // sh)[:, None] + offs[None, :, 0]                  # (N, T)
    cand_w = torch.remainder((centres[:, 1] // sw)[:, None] + offs[None, :, 1], w2)
    in_bounds = (cand_h >= 0) & (cand_h < h2)
    cand_flat = cand_h.clamp(0, h2 - 1) * w2 + cand_w

    centre = xyz1.reshape(b, h1 * w1, 3)[:, centres[:, 0] * w1 + centres[:, 1]]  # (B, N, 3)
    cand = xyz2.reshape(b, h2 * w2, 3)[:, cand_flat]                             # (B, N, T, 3)
    d_sq = torch.clamp(_sq3(cand - centre[:, :, None, :]), min=_VALID_EPS)
    ok = (in_bounds[None] & (_sq3(cand) > _VALID_EPS) & (d_sq <= distance * distance)
          & (_sq3(centre) > _VALID_EPS)[:, :, None])
    if mode == FIRST_K:
        pos = torch.arange(t, dtype=torch.float32, device=dev)
        score = torch.where(ok, t - pos, -1.0)
        threshold = 0.0
    elif mode == KNN:
        score = torch.where(ok, -d_sq, -torch.inf)
        threshold = -torch.inf
    else:
        raise ValueError(f"unknown mode {mode!r}")
    top_scores, top_t = _iterative_top_k(score, k)
    mask = top_scores > threshold
    idx = torch.gather(cand_flat.expand(b, *cand_flat.shape), 2, top_t)
    idx = torch.where(mask, idx, 0).to(torch.int32)
    return idx, mask[..., None].to(xyz1.dtype)


def gather_by_index(image: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, C) or (B, H*W, C), idx (B, N, K) flat -> (B, N, K, C)."""
    b, c = image.shape[0], image.shape[-1]
    flat = image.reshape(b, -1, c)
    n, k = idx.shape[1], idx.shape[2]
    index = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(flat, 1, index).reshape(b, n, k, c)


def select_and_group_plain(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    center_stride: Tuple[int, int] = (1, 1),
    mode: str = FIRST_K,
    perm: Optional[torch.Tensor] = None,
):
    """Plain PyTorch select + group on one grid.  Returns (grouped_xyz
    (B,N,K,3), grouped_feat (B,N,K,C), mask (B,N,K,1)), zero where masked."""
    idx, mask = select_neighbors_plain(
        xyz, xyz, kernel_size, k, distance, center_stride=center_stride,
        mode=mode, perm=perm,
    )
    gxyz, gfeat, mask = _group(xyz, feats, idx, mask)
    # separate buffers: the CPU operator's outputs may not alias each other
    return gxyz.contiguous(), gfeat.contiguous(), mask


def _group(xyz, feats, idx, mask):
    """Gather the selected (xyz, feature) rows, zero where masked; the
    values are differentiable in ``xyz`` and ``feats``."""
    both = gather_by_index(torch.cat([xyz, feats], dim=-1), idx) * mask
    return both[..., :3], both[..., 3:], mask


@contextlib.contextmanager
def plain_selects():
    """Inside the block, ``select_neighbors`` and ``select_and_group`` run
    the plain versions inline on CPU tensors, with no custom operator: a
    traced graph then holds plain PyTorch operations only.  The counterpart
    of the JAX package's ``ELO_NEIGHBOR_IMPL=fast`` for a portable export.
    CPU only: a select on a CUDA tensor inside the block raises, so no path
    that runs on a card can give way to the plain version."""
    token = _inline_plain.set(True)
    try:
        yield
    finally:
        _inline_plain.reset(token)


def _inline_plain_on(t: torch.Tensor) -> bool:
    """True inside ``plain_selects()``; raises there for a CUDA tensor."""
    if not _inline_plain.get():
        return False
    if t.is_cuda:
        raise RuntimeError(
            "plain_selects() is CPU only: a CUDA tensor goes through the kernel")
    return True


def _ops():
    """``torch.ops.efficientlo``, registered by importing ``window_select``."""
    from . import window_select  # noqa: F401

    return torch.ops.efficientlo


def _op_args(kernel_size, k, distance, center_stride, mode, perm, device):
    """The operators' scalar arguments as their schema types; the scan
    permutation as a tensor on ``device``."""
    perm = None if perm is None else torch.as_tensor(perm, device=device)
    return ([int(v) for v in kernel_size], int(k), float(distance),
            [int(v) for v in center_stride], str(mode), perm)


def select_neighbors(xyz1, xyz2, kernel_size, k, distance, center_stride=(1, 1),
                     source_stride=(1, 1), mode=KNN, perm=None):
    """Select up to K window neighbours for every centre of the strided grid.

    xyz1 (B, H1, W1, 3) holds the centres (its center_stride-strided pixels
    in raster order); xyz2 (B, H2, W2, 3) is searched; source_stride maps
    grid-1 coordinates to grid-2 windows.  Returns (idx (B, N, K) int32 flat
    into H2*W2, 0 where masked; mask (B, N, K, 1)).  Through
    ``efficientlo::window_select``: CUDA tensors go to the ``window_select``
    kernel, CPU tensors to ``select_neighbors_plain``.
    """
    profiling.count(f"select.{mode}")
    if _inline_plain_on(xyz1):
        return select_neighbors_plain(xyz1, xyz2, kernel_size, k, distance, center_stride,
                                      source_stride, mode, perm)
    ks, k, distance, cs, mode, perm = _op_args(kernel_size, k, distance, center_stride, mode,
                                               perm, xyz1.device)
    return _ops().window_select(xyz1.detach(), xyz2.detach(), ks, k, distance, cs,
                                [int(v) for v in source_stride], mode, perm)


def select_and_group(xyz, feats, kernel_size, k, distance, center_stride=(1, 1),
                     mode=FIRST_K, perm=None, fused=False):
    """Select + group on one grid (the DownConv path).  Returns (grouped_xyz
    (B,N,K,3), grouped_feat (B,N,K,C), mask (B,N,K,1)).

    ``fused=True`` (eval) calls ``efficientlo::select_and_group``: the fused
    kernel for CUDA tensors, the plain version for CPU tensors; its values
    carry no gradient.  ``fused=False`` (training) selects with
    ``select_neighbors`` and gathers with ``gather_by_index``, so gradients
    flow into ``xyz`` and ``feats``."""
    if fused and not _inline_plain_on(xyz):
        profiling.count(f"select.{mode}")
        ks, k, distance, cs, mode, perm = _op_args(kernel_size, k, distance, center_stride,
                                                   mode, perm, xyz.device)
        return _ops().select_and_group(xyz.detach(), feats.detach(), ks, k, distance, cs,
                                       mode, perm)
    idx, mask = select_neighbors(xyz, xyz, kernel_size, k, distance,
                                 center_stride=center_stride, mode=mode, perm=perm)
    return _group(xyz, feats, idx, mask)
