"""Operations and bytes of the network, counted from a configuration's
shapes alone, whatever implements them.

* ``mlp_flops``: the dense products of every 1x1-convolution stack, two
  operations per multiply-add, rows (grouped neighbours or points) times
  the layer widths; batch norm, pooling, softmax and the selects are left
  out, so the count is a lower bound of the work.
* ``select_sites``: every windowed select of a train step or of an eval
  batch in the network's call order, with the bytes a select must move
  (the source grid read once, the centres where they are another grid, the
  scan order, the indices and masks written, and for the fused select the
  grouped rows) and the operations it must do (13 a window slot tested:
  every slot for the K nearest, at least K for the first K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

F32 = 4
OPS_PER_SLOT = 13  # |q|^2, q - c and |q - c|^2 of one window slot


def level_shapes(config: Dict) -> List[Tuple[int, int]]:
    """(H, W) of [pre1, pre2, l0, l1, l2, l3]."""
    h, w = config["sensor"]["height"], config["sensor"]["width"]
    out = []
    for sh, sw in zip(config["model"]["stride_h"], config["model"]["stride_w"]):
        h, w = -(-h // sh), -(-w // sw)
        out.append((h, w))
    return out


def _stack(rows: int, in_features: int, widths) -> int:
    flops = 0
    for f in widths:
        flops += 2 * rows * in_features * f
        in_features = f
    return flops


def _cost_volume(m: Dict, n: int, in1: int, in2: int, kq: int) -> int:
    c = m["cv_mlp1"][-1]
    k = m["cv_nsample"]
    return (_stack(n * kq, 10 + in1 + in2, m["cv_mlp1"]) + _stack(n * kq, 10, (c,))
            + _stack(n * kq, 2 * c, m["cv_mlp2"]) + _stack(n * k, 10, (c,))
            + _stack(n * k, c + in1 + c, m["cv_mlp2"]))


def _head(m: Dict, in_features: int) -> int:
    return _stack(1, in_features, (m["head_dim"],)) + 2 * m["head_dim"] * (4 + 3)


def mlp_flops(config: Dict) -> Dict[str, int]:
    """Dense-product operations of one frame's tower ("tower") and of one
    pair's correlation and refinement ("correlate")."""
    m = config["model"]
    shapes = level_shapes(config)
    feat_c = [mlp[-1] for mlp in m["down_mlps"]]
    in_c = [3] + feat_c[:3]
    tower = sum(_stack(shapes[i + 2][0] * shapes[i + 2][1] * m["down_K"][i], 3 + in_c[i],
                       m["down_mlps"][i]) for i in range(4))
    cv_c, pred_c, l3_c = m["cv_mlp1"][-1], m["predictor_mlp"][-1], m["cv_down_mlp"][-1]
    n2 = shapes[4][0] * shapes[4][1]
    n3 = shapes[5][0] * shapes[5][1]
    corr = _cost_volume(m, n2, feat_c[2], feat_c[2], m["cv_nsample_q"][3])
    corr += _stack(n3 * m["down_K"][3], 3 + cv_c, m["cv_down_mlp"])
    corr += _stack(n3, feat_c[3] + l3_c, m["predictor_mlp"]) + _head(m, l3_c)
    for li in (2, 1, 0):
        n = shapes[li + 2][0] * shapes[li + 2][1]
        fc = feat_c[li]
        corr += _cost_volume(m, n, fc, fc, m["cv_nsample_q"][li])
        for coarse in (pred_c, l3_c if li == 2 else pred_c):  # up_w, up_feat
            corr += _stack(n * m["up_nsample"], 3 + coarse, m["up_mlp1"])
            corr += _stack(n, m["up_mlp1"][-1] + fc, m["up_mlp2"])
        corr += 2 * _stack(n, fc + m["up_mlp2"][-1] + cv_c, m["predictor_mlp"])
        corr += _head(m, pred_c)
    return {"tower": tower, "correlate": corr}


def flops_per_sample(config: Dict, training: bool) -> int:
    """A training pair: both towers and the correlation, forward and
    backward (3x the forward's products).  An eval frame: its tower and its
    pair's correlation (each frame is encoded once)."""
    f = mlp_flops(config)
    if training:
        return 3 * (2 * f["tower"] + f["correlate"])
    return f["tower"] + f["correlate"]


@dataclasses.dataclass(frozen=True)
class Site:
    """One select call: ``kind`` "window_select" or "select_and_group"."""

    name: str
    kind: str
    mode: str
    b: int
    grid1: Tuple[int, int]
    grid2: Tuple[int, int]
    kernel: Tuple[int, int]
    k: int
    centre_stride: Tuple[int, int] = (1, 1)
    source_stride: Tuple[int, int] = (1, 1)
    permuted: bool = False
    same_grid: bool = False
    channels: int = 0

    @property
    def centres(self) -> int:
        (h, w), (sh, sw) = self.grid1, self.centre_stride
        return -(-h // sh) * -(-w // sw)

    @property
    def slots(self) -> int:
        return self.kernel[0] * self.kernel[1]

    @property
    def bytes(self) -> int:
        h2, w2 = self.grid2
        n = self.b * self.centres
        moved = self.b * h2 * w2 * 3 * F32 + n * self.k * F32  # source, mask
        if not self.same_grid:
            moved += n * 3 * F32
        if self.permuted:
            moved += self.slots * F32
        if self.kind == "select_and_group":
            return moved + self.b * h2 * w2 * self.channels * F32 + n * self.k * (3 + self.channels) * F32
        return moved + n * self.k * F32  # indices

    @property
    def ops(self) -> int:
        tested = self.slots if self.mode == "knn" else min(self.k, self.slots)
        return OPS_PER_SLOT * self.b * self.centres * tested

    def bound_s(self, bytes_per_s: float, flops_per_s: float) -> float:
        return max(self.bytes / bytes_per_s, self.ops / flops_per_s)


def select_sites(config: Dict, batch: int, training: bool) -> List[Site]:
    """The selects of one train step (``training``, ``batch`` pairs: every
    select through ``window_select``, 23 of them) or of one sequence-eval
    batch (``batch`` frames encoded, ``batch`` pairs correlated: 14
    ``window_select`` and 5 ``select_and_group``)."""
    m = config["model"]
    shapes = level_shapes(config)
    strides = list(zip(m["stride_h"], m["stride_w"]))
    feat_c = [mlp[-1] for mlp in m["down_mlps"]]
    in_c = [3] + feat_c[:3]
    grids = [shapes[0]] + [shapes[i + 2] for i in range(3)]  # each DownConv's input grid
    sites = []

    def down(name, i, grid, channels, kernel, k, b):
        kind = "window_select" if training else "select_and_group"
        sites.append(Site(name, kind, "first_k", b, grid, grid, tuple(kernel), k,
                          centre_stride=strides[i + 2], permuted=training, same_grid=True,
                          channels=0 if training else channels))

    for frame in ((1, 2) if training else (1,)):
        for i in range(4):
            down(f"down_l{i}.frame{frame}" if training else f"down_l{i}", i, grids[i], in_c[i],
                 m["down_kernels"][i], m["down_K"][i], batch)

    def knn(name, grid, kernel, k):
        sites.append(Site(name, "window_select", "knn", batch, grid, grid, tuple(kernel), k))

    def self_select(name, grid):
        sites.append(Site(name, "window_select", "first_k", batch, grid, grid,
                          tuple(m["cv_kernel1"]), m["cv_nsample"], permuted=training,
                          same_grid=True))

    knn("cv_origin.knn", shapes[4], m["cv_kernel2"][3], m["cv_nsample_q"][3])
    self_select("cv_origin.self", shapes[4])
    down("cv_down_l3", 3, shapes[4], m["cv_mlp1"][-1], m["down_kernels"][3], m["down_K"][3],
         batch)
    for li in (2, 1, 0):
        grid = shapes[li + 2]
        knn(f"cv.knn_l{li}", grid, m["cv_kernel2"][li], m["cv_nsample_q"][li])
        self_select(f"cv.self_l{li}", grid)
        for up in ("up_w", "up_feat"):
            sites.append(Site(f"{up}_l{li}", "window_select", "first_k", batch, grid,
                              shapes[li + 3], tuple(m["up_kernel"]), m["up_nsample"],
                              source_stride=strides[li + 3], permuted=training))
    return sites


def select_bound_s(sites: List[Site], bytes_per_s: float, flops_per_s: float) -> float:
    """The least time of all the sites' selects: each bound by the larger of
    its bytes and its operations."""
    return sum(s.bound_s(bytes_per_s, flops_per_s) for s in sites)
