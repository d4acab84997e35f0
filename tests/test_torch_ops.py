"""Parity of the port's operators with the JAX package, on the CPU.

Quaternions (atol 1e-6: float32 products in another order), the packed
projection (exact, but for points within 1e-4 of a pixel boundary, where
atan2/asin ulps differ between the two backends) and the plain neighbour
selects (exact K sets and masks) against the JAX fast path, the Pallas
kernels in interpret mode and the numpy oracle.
"""

import ast
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import SensorConfig as TSensor
from efficientlo_net_torch.ops import neighbors as TN
from efficientlo_net_torch.ops import projection as TP
from efficientlo_net_torch.ops import quaternion as TQ
from efficientlo_net_torch.ops import window_select
from efficientlo_net_tpu.config import SensorConfig as JSensor
from efficientlo_net_tpu.ops import neighbors as JN
from efficientlo_net_tpu.ops import quaternion as JQ
from efficientlo_net_tpu.ops.pallas_select import pallas_select_and_group, pallas_window_select
from efficientlo_net_tpu.ops.projection import project_to_range_image as j_project
from tests.oracles import oracle_window_select
from tests.test_model import synthetic_scan
from tests.torch_cases import (GROUP_CASES, MODES, SELECT_CASES, group_inputs, make_grids,
                               rows_equal_as_multisets, select_inputs, sets_equal)
from tests.torch_parity import t


def _quats(rng, n=64):
    return rng.standard_normal((n, 4)).astype(np.float32)


@pytest.mark.parametrize("name", ["qmul", "qinv", "qnormalize", "qrotate", "quat_to_mat",
                                  "compose_pose"])
def test_quaternion_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _quats(rng), _quats(rng)
    pts = rng.standard_normal((64, 10, 3)).astype(np.float32)
    tr1, tr2 = (rng.standard_normal((64, 3)).astype(np.float32) for _ in range(2))
    args = {
        "qmul": (a, b), "qinv": (a,), "qnormalize": (a,), "qrotate": (a, pts),
        "quat_to_mat": (a,), "compose_pose": (a, tr1, b, tr2),
    }[name]
    want = getattr(JQ, name)(*[jnp.asarray(x) for x in args])
    got = getattr(TQ, name)(*[t(x) for x in args])
    if name != "compose_pose":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def _boundary_points(points, height, width, sensor, tol=1e-4):
    """Per point: is its JAX column or row coordinate within ``tol`` of an
    integer (a pixel boundary, where backends may truncate differently)?"""
    p = points.astype(np.float64)
    az_res = 2.0 * math.pi / width
    up, down = (math.radians(sensor.vertical_fov_up_deg),
                math.radians(sensor.vertical_fov_down_deg))
    v_res = (up - down) / (height - 1)
    r = np.linalg.norm(p, axis=-1)
    col = (math.pi - np.arctan2(p[..., 1], p[..., 0])) / az_res
    row = np.arcsin(np.clip(p[..., 2] / np.maximum(r, 1e-12), -1, 1)) / v_res - down / v_res

    def near(x):
        return np.abs(x - np.round(x)) < tol

    return near(col) | near(row)


@pytest.mark.parametrize("height,width,n", [(16, 128, 2048), (64, 1800, 20000)])
def test_packed_projection_matches_jax(height, width, n):
    rng = np.random.default_rng(3)
    pts = np.stack([synthetic_scan(rng, n), synthetic_scan(rng, n)])
    pts[:, ::7] = 0.0  # padding points never scatter
    feats = rng.standard_normal(pts.shape[:2] + (5,)).astype(np.float32)
    js, ts = JSensor(height=height, width=width), TSensor(height=height, width=width)
    j_img, j_feat = j_project(jnp.asarray(pts), jnp.asarray(feats), height, width, js,
                              method="packed")
    t_img, t_feat = TP.project_to_range_image(t(pts), t(feats), height, width, ts,
                                              method="packed")
    j_img, j_feat = np.asarray(j_img), np.asarray(j_feat)
    t_img, t_feat = t_img.numpy(), t_feat.numpy()
    differs = np.any(j_img != t_img, axis=-1) | np.any(j_feat != t_feat, axis=-1)
    near = _boundary_points(pts, height, width, js)
    for bi, hi, wi in zip(*np.nonzero(differs)):
        # each differing pixel holds (in one backend) a boundary point
        holders = [v for v in (j_img[bi, hi, wi], t_img[bi, hi, wi]) if np.any(v != 0)]
        assert any(near[bi][np.all(pts[bi] == v, axis=-1)].any() for v in holders), (bi, hi, wi)
    assert differs.sum() <= max(2, near.sum())


def test_pixel_coords_truncate_toward_zero():
    pts = np.array([[[10.0, 0.0, 0.0], [-10.0, 1e-6, 0.0], [0.0, 0.0, 0.0]]], np.float32)
    s = TSensor()
    row, col, valid, _ = TP.pixel_coords(t(pts), s.height, s.width, s)
    assert valid.tolist() == [[True, True, False]]
    assert col.dtype == torch.int32 and col[0, 0].item() == 900


def test_projection_refuses_too_many_points():
    with pytest.raises(ValueError):
        TP.project_to_range_image(torch.zeros(1, 1 << 18, 3), None, 4, 8, TSensor(),
                                  method="packed")


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_plain_matches_jax_fast_and_oracle(case, mode, with_perm):
    g1, g2, ks, k, dist, cs, ss, perm = select_inputs(case, with_perm)
    idx, mask = TN.select_neighbors_plain(
        t(g1), t(g2), ks, k, dist, center_stride=cs, source_stride=ss, mode=mode,
        perm=None if perm is None else t(perm),
    )
    # the public select runs the plain version for CPU tensors
    idx2, mask2 = TN.select_neighbors(t(g1), t(g2), ks, k, dist, cs, ss, mode,
                                      None if perm is None else t(perm))
    assert torch.equal(idx, idx2) and torch.equal(mask, mask2)
    j_idx, j_mask = JN.select_neighbors(
        jnp.asarray(g1), jnp.asarray(g2), ks, k, dist, center_stride=cs,
        source_stride=ss, mode=mode, perm=None if perm is None else jnp.asarray(perm),
        impl="fast",
    )
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    sets_equal(idx.numpy(), mask.numpy(), j_idx, j_mask)
    centers = JN.grid_centers(g1.shape[1], g1.shape[2], *cs)
    o_idx, o_mask = oracle_window_select(g1, g2, centers, ks, k, dist, stride=ss,
                                         mode=mode, perm=perm)
    np.testing.assert_array_equal(mask.numpy()[..., 0], o_mask)
    sets_equal(idx.numpy(), mask.numpy(), o_idx, o_mask[..., None])


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("case", ["plain", "centre_stride", "source_stride",
                                  "window_wider_than_w"])
def test_select_plain_matches_pallas_interpret(case, mode, with_perm):
    g1, g2, ks, k, dist, cs, ss, perm = select_inputs(case, with_perm, seed=1)
    idx, mask = TN.select_neighbors_plain(t(g1), t(g2), ks, k, dist, cs, ss, mode,
                                          None if perm is None else t(perm))
    p_idx, p_mask = pallas_window_select(
        jnp.asarray(g1), jnp.asarray(g2), ks, k, dist, center_stride=cs, source_stride=ss,
        mode=mode, perm=None if perm is None else jnp.asarray(perm), interpret=True,
    )
    sets_equal(idx.numpy(), mask.numpy(), p_idx, p_mask)


@pytest.mark.parametrize("mode,with_perm", MODES)
def test_select_and_group_plain_matches_jax(mode, with_perm):
    rng = np.random.default_rng(11)
    g1, _ = make_grids(rng, b=2, h1=8, w1=16)
    feats = rng.standard_normal((2, 8, 16, 5)).astype(np.float32)
    perm = rng.permutation(15) if with_perm else None
    args = ((3, 5), 4, 2.0)
    gx, gf, gm = TN.select_and_group_plain(t(g1), t(feats), *args, center_stride=(2, 4),
                                           mode=mode, perm=None if perm is None else t(perm))
    jperm = None if perm is None else jnp.asarray(perm)
    fast = JN.select_and_group(jnp.asarray(g1), jnp.asarray(feats), *args,
                               center_stride=(2, 4), mode=mode, perm=jperm)
    pallas = pallas_select_and_group(jnp.asarray(g1), jnp.asarray(feats), *args,
                                     center_stride=(2, 4), mode=mode, perm=jperm,
                                     interpret=True)
    got = np.concatenate([gx.numpy(), gf.numpy()], -1)
    for jx, jf, jm in (fast, pallas):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
        rows_equal_as_multisets(got, np.concatenate([np.asarray(jx), np.asarray(jf)], -1))


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_select_and_group_cases_plain_match_jax(case):
    xyz, feats, ks, k, dist, cs, mode = group_inputs(case)
    gx, gf, gm = TN.select_and_group_plain(t(xyz), t(feats), ks, k, dist, cs, mode)
    got = np.concatenate([gx.numpy(), gf.numpy()], -1)
    jargs = (jnp.asarray(xyz), jnp.asarray(feats), ks, k, dist)
    fast = JN.select_and_group(*jargs, center_stride=cs, mode=mode)
    pallas = pallas_select_and_group(*jargs, center_stride=cs, mode=mode, interpret=True)
    for jx, jf, jm in (fast, pallas):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
        rows_equal_as_multisets(got, np.concatenate([np.asarray(jx), np.asarray(jf)], -1))


def test_gather_by_index_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    idx = rng.integers(0, 24, (2, 7, 3)).astype(np.int32)
    want = JN.gather_by_index(jnp.asarray(img), jnp.asarray(idx))
    np.testing.assert_array_equal(TN.gather_by_index(t(img), t(idx)).numpy(), np.asarray(want))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a plain fallback: a CPU tensor raises
    before anything is built or launched."""
    x = torch.zeros(1, 4, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        window_select.window_select(x, x, (3, 3), 4, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        window_select.select_and_group(x, x, (3, 3), 4, 1.0)
    assert window_select.launches == {"window_select": 0, "select_and_group": 0}


REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "efficientlo_net_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "efficientlo_net_tpu")


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            names += [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_modules_load_without_jax():
    """Importing every port module in a fresh interpreter pulls in neither
    JAX nor the JAX package."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
               for p in PORT_FILES if p.parent != REPO]
    code = (f"import sys\nfor m in {modules!r}: __import__(m)\n"
            f"print([m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]", out
