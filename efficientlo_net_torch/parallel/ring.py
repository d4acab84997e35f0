"""W-axis (azimuth) ring for the windowed neighbour selects.

The port's copy of ``efficientlo_net_tpu/parallel/ring.py`` on
``torch.distributed``.  The cylindrical range image's W axis is split into
contiguous azimuth sectors, one per rank of a ring; each rank widens its
block with ``halo = kw // 2`` columns from each ring neighbour
(``halo_exchange_w``: point-to-point sends) and selects for its own centres
on the widened block, where every window stays inside the block.  The
selection scans the candidates in the unsharded order, so indices and masks
are bit-identical to ``ops.neighbors.select_neighbors``.

The ring is the ``"ring"`` dimension of a ``DeviceMesh`` (whose ``"data"``
dimension, if any, splits the batch) or a process group that is the ring.
The block functions take this rank's blocks (B_loc, H, W/R, C) and return
its centre sector, laid out (B_loc, n_h, n_w/R, K, ...) so that
``gather_w`` puts the sectors back in raster order.  On the card the
selects run the CUDA kernels of ``ops/window_select.py`` on the widened
block (their centre and source column offsets and centre count); the plain
block version ``_select_on_block`` serves CPU tensors only.

Gradients.  ``halo_exchange_w``, ``shard_w`` and ``gather_w`` are autograd
functions: the halo exchange's backward returns each received halo's
gradient to the rank that owns those columns (``fold_halo_grad``), and
``shard_w`` and ``gather_w`` are each other's duals (the one's backward
all-gathers the sector gradients, the other's keeps this rank's sector of
the incoming gradient).  The contract is the replicated one of
``ring_select_and_group_replicated``: every rank passes the whole arrays
and computes the same loss from the whole result, so every rank ends with
the whole input gradient, as JAX's global ``jax.grad`` gives it.
``ring_select_and_group``'s grouped values carry the gradient into ``xyz``
and ``feats``; indices and masks carry none.

Divisibility (``_validate``, ValueError as in the JAX package): R divides
both grid widths and the centre count, centre columns tile W1, a strided
source maps W1 onto W2, and halo <= W2 / R (one hop).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import window_select as ws
from ..ops.neighbors import FIRST_K, KNN, _iterative_top_k, _sq3, window_offsets
from .mesh import DATA_AXIS, RING_AXIS, axis_group, batch_sharding

_VALID_EPS = 1e-10


def _rank_in(group) -> Tuple[int, int]:
    """(index, size) of this rank in ``group``; (0, 1) for no group."""
    if group is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _swap_edges(to_right: torch.Tensor, to_left: torch.Tensor, group, tags: Tuple[int, int]):
    """Send ``to_right`` to the right ring neighbour and ``to_left`` to the
    left one; returns (what the left neighbour sent right, what the right
    neighbour sent left).  Two sends and two receives in one
    ``batch_isend_irecv``; with one rank each side receives its own."""
    index, n = _rank_in(group)
    if n == 1:
        return to_right, to_left
    # peers by global rank; in a ring of two both neighbours are one rank, so
    # the two directions differ in tag (gloo) and in posting order (NCCL)
    right = dist.get_global_rank(group, (index + 1) % n)
    left = dist.get_global_rank(group, (index - 1) % n)
    from_left = torch.empty_like(to_right)
    from_right = torch.empty_like(to_left)
    ops = [
        dist.P2POp(dist.isend, to_right, right, group, tag=tags[0]),
        dist.P2POp(dist.irecv, from_left, left, group, tag=tags[0]),
        dist.P2POp(dist.isend, to_left, left, group, tag=tags[1]),
        dist.P2POp(dist.irecv, from_right, right, group, tag=tags[1]),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def fold_halo_grad(grad_wide: torch.Tensor, halo: int, from_left: torch.Tensor,
                   from_right: torch.Tensor) -> torch.Tensor:
    """The gradient of a rank's sector from that of its widened block
    (B, H, halo + W_loc + halo, C): the middle columns, plus on the first
    ``halo`` columns ``from_left`` (the left neighbour's right-halo
    gradient: those columns were its right halo) and on the last ``halo``
    ``from_right`` (the right neighbour's left-halo gradient)."""
    out = grad_wide[:, :, halo:grad_wide.shape[2] - halo].clone()
    out[:, :, :halo] += from_left
    out[:, :, -halo:] += from_right
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        # my right edge is my right neighbour's left halo, and vice versa
        from_left, from_right = _swap_edges(x[:, :, -halo:].contiguous(),
                                            x[:, :, :halo].contiguous(), group, (1, 2))
        return torch.cat([from_left, x, from_right], dim=2)

    @staticmethod
    def backward(ctx, grad):
        halo = ctx.halo
        # each halo's gradient goes back to the rank whose edge it was
        from_left, from_right = _swap_edges(grad[:, :, -halo:].contiguous(),
                                            grad[:, :, :halo].contiguous(), ctx.group, (3, 4))
        return fold_halo_grad(grad, halo, from_left, from_right), None, None


def halo_exchange_w(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Widen a (B, H, W_loc, C) block with ``halo`` columns from each ring
    neighbour: (B, H, halo + W_loc + halo, C).  With one rank the block
    wraps onto itself (a cylinder of one sector).  Its backward folds the
    widened block's gradient back onto the sectors (``fold_halo_grad``)."""
    if halo == 0:
        return x
    return _HaloExchange.apply(x, halo, group)


def _select_on_block(
    xyz1_blk, xyz2_wide, ring_index,
    *, kernel_size, k, distance, center_stride, source_stride,
    halo, w1, w2, h2, mode, perm,
):
    """The plain block select (CPU tensors): one azimuth sector's centres
    against its halo-widened source block, in the unsharded scan order.
    Returns (idx (B, n_h, n_w_loc, K) int32 GLOBAL flat into (h2, w2),
    mask (B, n_h, n_w_loc, K, 1), idx_local (B, n_loc, K) int32 flat into
    the widened block)."""
    b, h1, w1_loc = xyz1_blk.shape[:3]
    kh, kw = kernel_size
    t = kh * kw
    csh, csw = center_stride
    sh, sw = source_stride
    w2_wide = xyz2_wide.shape[2]
    dev = xyz1_blk.device

    n_h = -(-h1 // csh)
    n_w_loc = w1_loc // csw
    n_loc = n_h * n_w_loc

    # centres: strided pixels of the local grid-1 block
    center_xyz = xyz1_blk[:, ::csh, ::csw].reshape(b, n_loc, 3)
    center_valid = _sq3(center_xyz) > _VALID_EPS

    # window base coordinates on the widened grid-2 block
    base_rows = torch.arange(0, n_h * csh, csh, device=dev) // sh
    base_cols = torch.arange(0, n_w_loc * csw, csw, device=dev) // sw + halo
    base_r = base_rows.repeat_interleave(n_w_loc)   # (n_loc,)
    base_c = base_cols.repeat(n_h)                  # (n_loc,)

    offs = torch.as_tensor(window_offsets(kh, kw), device=dev)   # (T, 2)
    if perm is not None:
        offs = offs[torch.as_tensor(perm, device=dev).long()]

    cand_h = base_r[:, None] + offs[None, :, 0]      # (n_loc, T)
    cand_c = base_c[:, None] + offs[None, :, 1]      # in bounds by the halo
    in_bounds = (cand_h >= 0) & (cand_h < h2)
    cand_flat = cand_h.clamp(0, h2 - 1) * w2_wide + cand_c

    cand_xyz = xyz2_wide.reshape(b, -1, 3)[:, cand_flat]          # (B, n_loc, T, 3)
    cand_valid = _sq3(cand_xyz) > _VALID_EPS
    d_sq = torch.clamp(_sq3(cand_xyz - center_xyz[:, :, None, :]), min=_VALID_EPS)

    ok = in_bounds[None] & cand_valid & (d_sq <= distance * distance) \
        & center_valid[:, :, None]

    if mode == FIRST_K:
        pos = torch.arange(t, dtype=torch.float32, device=dev)
        score = torch.where(ok, t - pos, -1.0)
        threshold = 0.0
    elif mode == KNN:
        score = torch.where(ok, -d_sq, -torch.inf)
        threshold = -torch.inf
    else:
        raise ValueError(f"unknown mode {mode!r}")

    top_scores, top_pos = _iterative_top_k(score, k)              # (B, n_loc, K)
    mask = top_scores > threshold

    sel_h = torch.gather(cand_h.expand(b, n_loc, t), 2, top_pos).clamp(0, h2 - 1)
    sel_c = torch.gather(cand_c.expand(b, n_loc, t), 2, top_pos)
    idx_local = torch.where(mask, sel_h * w2_wide + sel_c, 0).to(torch.int32)
    mask = mask[..., None].to(xyz1_blk.dtype)
    idx = _global_index(idx_local, mask, w2_wide, w2, halo, ring_index)
    return idx.reshape(b, n_h, n_w_loc, k), mask.reshape(b, n_h, n_w_loc, k, 1), idx_local


def _validate(w1, w2, n_w, csw, sw, kw, ring_size):
    if w1 % ring_size or w2 % ring_size:
        raise ValueError(
            f"ring size {ring_size} must divide both grid widths ({w1}, {w2})"
        )
    if n_w % ring_size:
        raise ValueError(
            f"ring size {ring_size} must divide the center count {n_w}"
        )
    if csw * n_w != w1:
        raise ValueError(
            f"center stride {csw} does not tile W1={w1} exactly (n_w={n_w})"
        )
    if sw > 1 and sw * w2 != w1:
        raise ValueError(
            f"source stride {sw} does not map W1={w1} onto W2={w2} exactly"
        )
    halo = kw // 2
    if halo > w2 // ring_size:
        raise ValueError(
            f"halo {halo} exceeds the {w2 // ring_size}-column sector; "
            f"window ({kw}) is too wide for ring size {ring_size} — "
            "keep this level replicated (docs/w_axis_sharding.md)"
        )
    return halo


def _global_index(idx_local, mask, w2_wide, w2, halo, ring_index):
    """Flat indices into the widened block -> global flat indices into the
    (h2, w2) grid, 0 where ``mask`` (..., 1) is 0: subtract the halo, add the
    sector start, wrap at the azimuth seam."""
    w2_loc = w2_wide - 2 * halo
    sel_h, sel_c = idx_local // w2_wide, idx_local % w2_wide
    global_c = torch.remainder(sel_c - halo + ring_index * w2_loc, w2)
    return torch.where(mask[..., 0] > 0, sel_h * w2 + global_c, 0).to(torch.int32)


def ring_select_neighbors(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    *,
    mesh,
    ring_axis: str = RING_AXIS,
    center_stride: Tuple[int, int] = (1, 1),
    source_stride: Tuple[int, int] = (1, 1),
    mode: str = KNN,
    perm: Optional[torch.Tensor] = None,
):
    """Ring-sharded ``select_neighbors`` on this rank's blocks.

    xyz1 (B, H1, W1/R, 3), xyz2 (B, H2, W2/R, 3): this rank's sectors of
    both grids; ``mesh`` a ``DeviceMesh`` with a ``ring_axis`` dimension, or
    the ring's process group.  Returns this rank's centre sector: idx
    (B, n_h, n_w/R, K) int32 GLOBAL flat indices into grid 2 and mask
    (B, n_h, n_w/R, K, 1), bit-identical to those rows of the unsharded op.
    CUDA tensors go through the ``window_select`` kernel, CPU tensors through
    ``_select_on_block``."""
    group = axis_group(mesh, ring_axis)
    ring_index, ring_size = _rank_in(group)
    b, h1, w1_loc, _ = xyz1.shape
    _, h2, w2_loc, _ = xyz2.shape
    kh, kw = kernel_size
    csh, csw = center_stride
    sh, sw = source_stride
    w1, w2 = w1_loc * ring_size, w2_loc * ring_size
    n_h = -(-h1 // csh)
    n_w = -(-w1 // csw)
    halo = _validate(w1, w2, n_w, csw, sw, kw, ring_size)
    n_w_loc = n_w // ring_size

    x2_wide = halo_exchange_w(xyz2.detach(), halo, group)
    if not xyz1.is_cuda:
        idx4, mask5, _ = _select_on_block(
            xyz1.detach(), x2_wide, ring_index,
            kernel_size=(kh, kw), k=k, distance=float(distance),
            center_stride=(csh, csw), source_stride=(sh, sw),
            halo=halo, w1=w1, w2=w2, h2=h2, mode=mode, perm=perm,
        )
        return idx4, mask5
    idx_local, mask = ws.window_select(
        xyz1.detach().contiguous(), x2_wide.contiguous(), (kh, kw), k, float(distance),
        (csh, csw), (sh, sw), mode, perm,
        centre_col_offset=0, source_col_offset=halo, n_w=n_w_loc,
    )
    idx = _global_index(idx_local, mask, x2_wide.shape[2], w2, halo, ring_index)
    return idx.reshape(b, n_h, n_w_loc, k), mask.reshape(b, n_h, n_w_loc, k, 1)


def _group_on_block(xyz_blk, src_wide, ring_index, *, kernel_size, k, distance, center_stride,
                    mode, perm, halo, w, h, fused):
    """One rank's select + grouping on its halo-widened [xyz | feats] block
    ``src_wide`` (B, H, halo + W_loc + halo, 3 + C), for the centres of its
    sector ``xyz_blk`` (B, H, W_loc, 3).  Returns (grouped_xyz, grouped_feat,
    mask), each (B, n_h, n_w_loc, K, ...).

    ``fused`` on the card: the ``select_and_group`` kernel, whose values
    carry no gradient.  Otherwise, and for CPU tensors, the
    ``window_select`` kernel (CUDA) or ``_select_on_block`` (CPU) selects,
    and a gather from ``src_wide`` groups, so the values carry the gradient
    into it."""
    b = xyz_blk.shape[0]
    c = src_wide.shape[-1] - 3
    csh, csw = center_stride
    n_h = -(-h // csh)
    n_w_loc = xyz_blk.shape[2] // csw
    n_loc = n_h * n_w_loc
    xyz_wide = src_wide[..., :3].detach().contiguous()
    if xyz_blk.is_cuda and fused:
        gx, gf, m = ws.select_and_group(
            xyz_wide, src_wide[..., 3:].detach().contiguous(), kernel_size, k, float(distance),
            center_stride, mode, perm, centre_col_offset=halo, source_col_offset=halo, n_w=n_w_loc,
        )
    else:
        if xyz_blk.is_cuda:
            idx_local, m = ws.window_select(
                xyz_blk.detach().contiguous(), xyz_wide, kernel_size, k, float(distance),
                center_stride, (1, 1), mode, perm,
                centre_col_offset=0, source_col_offset=halo, n_w=n_w_loc,
            )
        else:
            _, m, idx_local = _select_on_block(
                xyz_blk.detach(), xyz_wide, ring_index,
                kernel_size=kernel_size, k=k, distance=float(distance),
                center_stride=center_stride, source_stride=(1, 1),
                halo=halo, w1=w, w2=w, h2=h, mode=mode, perm=perm,
            )
        flat_wide = src_wide.reshape(b, -1, 3 + c)
        sel = torch.gather(flat_wide, 1, idx_local.reshape(b, n_loc * k, 1).long()
                           .expand(b, n_loc * k, 3 + c)).reshape(b, n_loc, k, 3 + c)
        m = m.reshape(b, n_loc, k, 1)
        sel = sel * m
        gx, gf = sel[..., :3], sel[..., 3:]
    return (gx.reshape(b, n_h, n_w_loc, k, 3), gf.reshape(b, n_h, n_w_loc, k, c),
            m.reshape(b, n_h, n_w_loc, k, 1))


def ring_select_and_group(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    *,
    mesh,
    ring_axis: str = RING_AXIS,
    center_stride: Tuple[int, int] = (1, 1),
    mode: str = FIRST_K,
    perm: Optional[torch.Tensor] = None,
    fused: bool = False,
):
    """Ring-sharded select + grouping (the DownConv front end) on this
    rank's blocks xyz (B, H, W/R, 3) and feats (B, H, W/R, C).

    The values come from the halo-widened block itself, never from a global
    gather.  Returns this rank's centre sector (grouped_xyz (B, n_h, n_w/R,
    K, 3), grouped_feat (B, n_h, n_w/R, K, C), mask (B, n_h, n_w/R, K, 1)),
    equal to those rows of ``ops.neighbors.select_and_group``.  As there,
    ``fused=True`` (eval) groups CUDA tensors with the fused
    ``select_and_group`` kernel, whose values carry no gradient;
    ``fused=False`` (training) selects with the ``window_select`` kernel and
    gathers, so the values carry the gradient into ``xyz`` and ``feats``,
    through the halo exchange.  CPU tensors select with the plain
    ``_select_on_block`` and gather either way."""
    group = axis_group(mesh, ring_axis)
    ring_index, ring_size = _rank_in(group)
    h, w_loc = xyz.shape[1:3]
    kh, kw = kernel_size
    csh, csw = center_stride
    w = w_loc * ring_size
    n_w = -(-w // csw)
    halo = _validate(w, w, n_w, csw, 1, kw, ring_size)
    src_wide = halo_exchange_w(torch.cat([xyz, feats], dim=-1), halo, group)
    return _group_on_block(xyz, src_wide, ring_index, kernel_size=(kh, kw), k=k,
                           distance=distance, center_stride=(csh, csw), mode=mode, perm=perm,
                           halo=halo, w=w, h=h, fused=fused)


def _data_split(mesh, b: int):
    """(group, index, count) of the mesh's data dimension where it splits
    ``b`` rows; else (None, 0, 1): a batch that does not divide stays
    replicated over it, as in the JAX package."""
    if isinstance(mesh, DeviceMesh):
        index, count = batch_sharding(mesh)
        if count > 1 and b % count == 0:
            return mesh.get_group(DATA_AXIS), index, count
    return None, 0, 1


def _sector_slices(mesh, ring_axis, b: int, w: int):
    """(rows, columns) of this rank's part of a replicated (b, ., w, ...)
    array: its W sector, and its rows where the mesh's data dimension
    splits ``b``."""
    ring_index, ring_size = _rank_in(axis_group(mesh, ring_axis))
    if w % ring_size:
        raise ValueError(f"ring size {ring_size} must divide the grid width {w}")
    _, row, rows = _data_split(mesh, b)
    b_loc, w_loc = b // rows, w // ring_size
    return (slice(row * b_loc, (row + 1) * b_loc),
            slice(ring_index * w_loc, (ring_index + 1) * w_loc))


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _gather_sectors(x: torch.Tensor, mesh, ring_axis: str, b: int) -> torch.Tensor:
    """Every rank's (rows, sector) part concatenated back: along W over the
    ring, then along the rows over the data dimension where it split the
    ``b`` global rows."""
    group = axis_group(mesh, ring_axis)
    if _rank_in(group)[1] > 1:
        x = _all_gather_cat(x, group, 2)
    data_group, _, rows = _data_split(mesh, b)
    if rows > 1:
        x = _all_gather_cat(x, data_group, 0)
    return x


class _ShardW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ring_axis):
        ctx.mesh, ctx.ring_axis, ctx.b = mesh, ring_axis, x.shape[0]
        rows, cols = _sector_slices(mesh, ring_axis, x.shape[0], x.shape[2])
        return x[rows, :, cols]

    @staticmethod
    def backward(ctx, grad):
        # every rank's sector gradient: the whole input's, on every rank
        return _gather_sectors(grad, ctx.mesh, ctx.ring_axis, ctx.b), None, None


class _GatherW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ring_axis, batch):
        ctx.mesh, ctx.ring_axis = mesh, ring_axis
        out = _gather_sectors(x, mesh, ring_axis, batch)
        ctx.b, ctx.w = out.shape[0], out.shape[2]
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank computed the same loss from the whole output: this
        # rank's share of its gradient is its own sector's, not a sum
        rows, cols = _sector_slices(ctx.mesh, ctx.ring_axis, ctx.b, ctx.w)
        return grad[rows, :, cols].contiguous(), None, None, None


def shard_w(x: torch.Tensor, mesh, ring_axis: str = RING_AXIS) -> torch.Tensor:
    """This rank's W sector of a replicated (B, H, W, ...) array (and its
    rows where the mesh's data dimension splits B).  Its backward
    all-gathers the sectors' gradients: every rank gets the whole input's."""
    return _ShardW.apply(x, mesh, ring_axis)


def gather_w(x: torch.Tensor, mesh, ring_axis: str = RING_AXIS, batch: Optional[int] = None
             ) -> torch.Tensor:
    """The inverse of ``shard_w`` for a ring function's output
    (B_loc, n_h, n_w/R, ...): every rank's sectors concatenated along W in
    raster order, and, where the data dimension split the ``batch`` global
    rows (default: B_loc times the data size), the rows too.  Its backward
    keeps this rank's sector (and rows) of the incoming gradient."""
    if batch is None:
        batch = x.shape[0] * batch_sharding(mesh)[1] if isinstance(mesh, DeviceMesh) else x.shape[0]
    return _GatherW.apply(x, mesh, ring_axis, batch)


def ring_select_and_group_replicated(xyz, feats, kernel_size, k, distance, *, mesh,
                                     ring_axis: str = RING_AXIS, center_stride=(1, 1),
                                     mode: str = FIRST_K, perm=None, fused: bool = False):
    """``ring_select_and_group`` on replicated arrays: every rank passes the
    whole (B, H, W, ...) grids and gets the whole (B, N, K, ...) groups,
    as the JAX package's ``shard_map`` returns them (``DownConv``'s
    ``select_fn`` in a ring forward).  Each rank selects for its sector
    (and rows), and the outputs are gathered.  With ``fused=False`` the
    groups are differentiable: every rank computing the same loss from them
    gets the whole gradient of ``xyz`` and ``feats``."""
    b, h, w, _ = xyz.shape
    ring_size = _rank_in(axis_group(mesh, ring_axis))[1]
    n_w = -(-w // center_stride[1])
    _validate(w, w, n_w, center_stride[1], 1, kernel_size[1], ring_size)
    out = ring_select_and_group(shard_w(xyz, mesh, ring_axis), shard_w(feats, mesh, ring_axis),
                                kernel_size, k, distance, mesh=mesh, ring_axis=ring_axis,
                                center_stride=center_stride, mode=mode, perm=perm, fused=fused)
    n = -(-h // center_stride[0]) * n_w
    return tuple(gather_w(o, mesh, ring_axis, batch=b).reshape(b, n, k, o.shape[-1])
                 for o in out)
