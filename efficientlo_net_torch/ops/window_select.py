"""CUDA windowed neighbour select: wrappers, binding and launch counts.

The hand-written Hopper counterparts of the two Pallas TPU kernels in
``efficientlo_net_tpu/ops/pallas_select.py``; the sources are in
``csrc/window_select.cu``:

* ``window_select``    replaces ``_kernel`` (via ``pallas_window_select``);
* ``select_and_group`` replaces ``_kernel`` + ``_emit_kernel`` (via
  ``pallas_select_and_group``): one pass selects and copies the values.

Both take CUDA tensors only and launch on the current stream; the plain
PyTorch versions of the same functions are ``neighbors.select_neighbors_plain``
and ``neighbors.select_and_group_plain``.  ``launches`` counts the launches
of each kernel.

Importing this module registers both as ``torch.library`` custom operators,
``efficientlo::window_select`` and ``efficientlo::select_and_group``, which
every call site of the port reaches through ``neighbors``: the CUDA
implementation is the wrapper here (it looks the wrapper up at each call), the
CPU implementation the plain version, and a fake implementation gives the
output shapes and dtypes, so that ``torch.export`` can trace a network that
calls them.  The operators register no autograd: their inputs come detached,
as the JAX package cuts gradients before both Pallas calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build
from . import neighbors
from .neighbors import FIRST_K, KNN

SOURCE = "window_select.cu"

#: kernel launches since the last ``reset_launches()``
launches = {"window_select": 0, "select_and_group": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_bound = None  # (library, the largest K its kernels take), bound once


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> Tuple[ctypes.CDLL, int]:
    global _bound
    if _bound is None:
        lib = cuda_build.load(SOURCE)
        lib.elo_max_k.argtypes = []
        lib.elo_max_k.restype = _I
        lib.elo_window_select.argtypes = ([_P, _P, _P] + [_I] * 12 + [_F] + [_I] * 4
                                          + [_P, _P, _P])
        lib.elo_window_select.restype = _I
        lib.elo_select_and_group.argtypes = ([_P, _P, _P] + [_I] * 9 + [_F] + [_I] * 4
                                             + [_P, _P, _P, _P])
        lib.elo_select_and_group.restype = _I
        _bound = lib, lib.elo_max_k()
    return _bound


def _check_grid(x: torch.Tensor, name: str, channels: Optional[int] = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 4 or (channels is not None and x.shape[-1] != channels):
        raise ValueError(f"{name} must be (B, H, W, {channels or 'C'}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _scan_order(perm, mode: str, t: int, device) -> Optional[torch.Tensor]:
    """int32 scan order for FIRST_K with a permutation; KNN ignores it."""
    if perm is None or mode == KNN:
        return None
    perm = torch.as_tensor(perm, dtype=torch.int32, device=device).contiguous()
    if perm.shape != (t,):
        raise ValueError(f"perm must have shape ({t},), got {tuple(perm.shape)}")
    return perm


def _common(kernel_size, k, mode, perm, device):
    kh, kw = (int(v) for v in kernel_size)
    if mode not in (FIRST_K, KNN):
        raise ValueError(f"unknown mode {mode!r}")
    lib, max_k = _lib()
    if not 1 <= k <= max_k:
        raise ValueError(f"k must be in [1, {max_k}], got {k}")
    order = _scan_order(perm, mode, kh * kw, device)
    return lib, kh, kw, order


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _centre_columns(w1: int, csw: int, n_w, centre_col_offset: int, source_col_offset: int):
    """The centre count across W (default ceil(W1/csw)), checked so that
    every centre column ``j*csw + centre_col_offset`` lies inside grid 1."""
    n_w = -(-w1 // csw) if n_w is None else int(n_w)
    if n_w < 1 or centre_col_offset < 0 or source_col_offset < 0 \
            or (n_w - 1) * csw + centre_col_offset >= w1:
        raise ValueError(f"{n_w} centres at stride {csw} from column {centre_col_offset} "
                         f"do not fit a grid of width {w1}")
    return n_w


def window_select(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    center_stride: Tuple[int, int] = (1, 1),
    source_stride: Tuple[int, int] = (1, 1),
    mode: str = KNN,
    perm=None,
    centre_col_offset: int = 0,
    source_col_offset: int = 0,
    n_w: Optional[int] = None,
):
    """Same contract as ``neighbors.select_neighbors_plain``: returns
    (idx (B, N, K) int32 flat into H2*W2, 0 where masked; mask (B, N, K, 1)).

    The last three describe a block of a ring sector (``parallel/ring.py``):
    centre j of a row reads xyz1 at column ``j*csw + centre_col_offset``, its
    window is based at column ``(j*csw)//sw + source_col_offset`` of xyz2,
    and there are ``n_w`` centres a row (default ``ceil(W1/csw)``).  With
    the defaults 0, 0, None the call is the whole-image select."""
    _check_grid(xyz1, "xyz1", 3)
    _check_grid(xyz2, "xyz2", 3)
    if xyz2.shape[0] != xyz1.shape[0] or xyz2.device != xyz1.device:
        raise ValueError("xyz1 and xyz2 must share batch size and device")
    lib, kh, kw, order = _common(kernel_size, k, mode, perm, xyz1.device)
    b, h1, w1, _ = xyz1.shape
    _, h2, w2, _ = xyz2.shape
    csh, csw = (int(v) for v in center_stride)
    sh, sw = (int(v) for v in source_stride)
    n_w = _centre_columns(w1, csw, n_w, centre_col_offset, source_col_offset)
    n = -(-h1 // csh) * n_w
    idx = torch.empty((b, n, k), dtype=torch.int32, device=xyz1.device)
    mask = torch.empty((b, n, k, 1), dtype=torch.float32, device=xyz1.device)
    err = lib.elo_window_select(
        xyz1.data_ptr(), xyz2.data_ptr(), None if order is None else order.data_ptr(),
        b, h1, w1, h2, w2, kh, kw, csh, csw, sh, sw, k,
        float(distance) * float(distance), int(mode == KNN),
        n_w, int(centre_col_offset), int(source_col_offset),
        idx.data_ptr(), mask.data_ptr(), torch.cuda.current_stream(xyz1.device).cuda_stream,
    )
    _raise_on(err, "window_select")
    launches["window_select"] += 1
    return idx, mask


def select_and_group(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    kernel_size: Tuple[int, int],
    k: int,
    distance: float,
    center_stride: Tuple[int, int] = (1, 1),
    mode: str = FIRST_K,
    perm=None,
    centre_col_offset: int = 0,
    source_col_offset: int = 0,
    n_w: Optional[int] = None,
):
    """Same contract as ``neighbors.select_and_group_plain``: returns
    (grouped_xyz (B,N,K,3), grouped_feat (B,N,K,C), mask (B,N,K,1)), zero in
    masked slots.  The values carry no gradient.  The block offsets and
    ``n_w`` are ``window_select``'s; the grouped values come from the same
    grid as the source."""
    _check_grid(xyz, "xyz", 3)
    _check_grid(feats, "feats")
    if feats.shape[:3] != xyz.shape[:3] or feats.device != xyz.device:
        raise ValueError("feats must share (B, H, W) and device with xyz")
    lib, kh, kw, order = _common(kernel_size, k, mode, perm, xyz.device)
    b, h, w, _ = xyz.shape
    c = feats.shape[-1]
    csh, csw = (int(v) for v in center_stride)
    n_w = _centre_columns(w, csw, n_w, centre_col_offset, source_col_offset)
    n = -(-h // csh) * n_w
    gxyz = torch.empty((b, n, k, 3), dtype=torch.float32, device=xyz.device)
    gfeat = torch.empty((b, n, k, c), dtype=torch.float32, device=xyz.device)
    mask = torch.empty((b, n, k, 1), dtype=torch.float32, device=xyz.device)
    err = lib.elo_select_and_group(
        xyz.data_ptr(), feats.data_ptr(), None if order is None else order.data_ptr(),
        b, h, w, c, kh, kw, csh, csw, k,
        float(distance) * float(distance), int(mode == KNN),
        n_w, int(centre_col_offset), int(source_col_offset),
        gxyz.data_ptr(), gfeat.data_ptr(), mask.data_ptr(),
        torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    _raise_on(err, "select_and_group")
    launches["select_and_group"] += 1
    return gxyz, gfeat, mask


# ---- torch.library operators -------------------------------------------------

def _n_centres(h: int, w: int, center_stride) -> int:
    return -(-h // center_stride[0]) * -(-w // center_stride[1])


@torch.library.custom_op(
    "efficientlo::window_select", mutates_args=(), device_types="cpu",
    schema="(Tensor xyz1, Tensor xyz2, int[] kernel_size, int k, float distance, "
           "int[] center_stride, int[] source_stride, str mode, Tensor? perm) -> (Tensor, Tensor)")
def window_select_op(*args):
    """On the CPU: the plain version."""
    return neighbors.select_neighbors_plain(*args)


@window_select_op.register_kernel("cuda")
def _(*args):
    return window_select(*args)


@window_select_op.register_fake
def _(xyz1, xyz2, kernel_size, k, distance, center_stride, source_stride, mode, perm):
    b, h1, w1, _ = xyz1.shape
    n = _n_centres(h1, w1, center_stride)
    return (xyz1.new_empty((b, n, k), dtype=torch.int32), xyz1.new_empty((b, n, k, 1)))


@torch.library.custom_op(
    "efficientlo::select_and_group", mutates_args=(), device_types="cpu",
    schema="(Tensor xyz, Tensor feats, int[] kernel_size, int k, float distance, "
           "int[] center_stride, str mode, Tensor? perm) -> (Tensor, Tensor, Tensor)")
def select_and_group_op(*args):
    """On the CPU: the plain version."""
    return neighbors.select_and_group_plain(*args)


@select_and_group_op.register_kernel("cuda")
def _(*args):
    return select_and_group(*args)


@select_and_group_op.register_fake
def _(xyz, feats, kernel_size, k, distance, center_stride, mode, perm):
    b, h, w, _ = xyz.shape
    n = _n_centres(h, w, center_stride)
    dtype = torch.promote_types(xyz.dtype, feats.dtype)
    return (xyz.new_empty((b, n, k, 3), dtype=dtype),
            xyz.new_empty((b, n, k, feats.shape[-1]), dtype=dtype),
            xyz.new_empty((b, n, k, 1)))
