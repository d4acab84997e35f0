"""The port's SE(3) maps, pose-graph solver, scan factors and map assembly
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; both
compute in float32.  Tolerances, each from the size of the values compared:

* SE(3) maps: 1e-6 on unit-scale entries (a few float32 ulps; the two
  libraries' sin / cos / atan2 round differently), 1e-4 for Log near
  theta = pi, where atan2 and the 1/sin(theta) scale amplify an ulp;
* normal-equation blocks: relative 1e-5 (sums of many float32 products in
  another order); solved poses 1e-5;
* normals and association: equal but for rounding of the normals (1e-6);
  every association weight equal;
* map assembly: numpy on both sides, exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.backend import mapping as TM
from efficientlo_net_torch.backend import pose_graph as TP
from efficientlo_net_torch.backend import scan_factors as TS
from efficientlo_net_torch.config import SensorConfig as TSensor
from efficientlo_net_torch.ops import se3 as TSE3
from efficientlo_net_tpu.backend import mapping as JM
from efficientlo_net_tpu.backend import pose_graph as JP
from efficientlo_net_tpu.backend import scan_factors as JS
from efficientlo_net_tpu.config import SensorConfig as JSensor
from efficientlo_net_tpu.ops import se3 as JSE3
from tests.test_scan_factors import boxy_scene, project

SE3_ATOL = 1e-6
SE3_PI_ATOL = 1e-4
BLOCK_RTOL = 1e-5
POSE_ATOL = 1e-5
J_SENSOR = JSensor(height=16, width=256, num_points=8192)
T_SENSOR = TSensor(height=16, width=256, num_points=8192)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.as_tensor(np.array(x))


# the JAX side compiled once per shape and option: its eager op-by-op
# dispatch of vmap(jacfwd) costs more than the compile
j_accumulate = jax.jit(JP._accumulate, static_argnames="robust")
j_scan_accumulate = jax.jit(JS.accumulate_scan_factors)


def close(got, want, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ---- se3 ------------------------------------------------------------------------------

def twists(kind):
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((16, 6))
    if kind == "random":
        xi *= 0.8
    elif kind == "near_zero":
        xi *= 1e-6
    else:  # near pi: |w| = pi - 1e-3
        xi[:, 3:] *= (np.pi - 1e-3) / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    return xi.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_zero", "near_pi"])
def test_se3_maps_match_jax(kind):
    xi = twists(kind)
    m_t, m_j = TSE3.se3_exp(t(xi)), JSE3.se3_exp(jnp.asarray(xi))
    close(m_t, m_j, atol=SE3_ATOL)
    m = np.asarray(m_j)
    close(TSE3.se3_inv(t(m)), JSE3.se3_inv(jnp.asarray(m)), atol=SE3_ATOL)
    close(TSE3.so3_exp(t(xi[:, 3:])), JSE3.so3_exp(jnp.asarray(xi[:, 3:])), atol=SE3_ATOL)
    log_atol = SE3_PI_ATOL if kind == "near_pi" else SE3_ATOL
    close(TSE3.se3_log(t(m)), JSE3.se3_log(jnp.asarray(m)), atol=log_atol)
    close(TSE3.so3_log(t(m[:, :3, :3])), JSE3.so3_log(jnp.asarray(m[:, :3, :3])), atol=log_atol)
    close(TSE3.hat(t(xi[:, 3:])), JSE3.hat(jnp.asarray(xi[:, 3:])), atol=0.0)


def test_jacobians_at_the_zero_twist_match_jax():
    """The factor Jacobians' building block, d Log(Z^-1 Exp(d) T) / dd at d
    = 0, through torch.func.jacfwd and jax.jacfwd."""
    z = np.asarray(JSE3.se3_exp(jnp.asarray(twists("random")[:2])))

    def f_t(d):
        return TSE3.se3_log(TSE3.se3_inv(t(z[0])) @ TSE3.se3_exp(d) @ t(z[1]))

    def f_j(d):
        return JSE3.se3_log(JSE3.se3_inv(jnp.asarray(z[0])) @ JSE3.se3_exp(d) @ jnp.asarray(z[1]))

    zero = np.zeros(6, np.float32)
    close(torch.func.jacfwd(f_t)(t(zero)), jax.jit(jax.jacfwd(f_j))(jnp.asarray(zero)),
          atol=SE3_ATOL)
    close(torch.func.jacfwd(TSE3.se3_exp)(t(zero)),
          jax.jit(jax.jacfwd(JSE3.se3_exp))(jnp.asarray(zero)), atol=0.0)


# ---- pose graph -----------------------------------------------------------------------

def chain(n=10, seed=0, closure=True):
    """A noisy odometry chain along a curve, optionally closed from node 0 to
    n-1: (initial poses, src, dst, measurements, weights)."""
    rng = np.random.default_rng(seed)
    xi = np.tile([1.0, 0, 0, 0, 0, 0.15], (n - 1, 1)) + rng.standard_normal((n - 1, 6)) * 0.02
    steps = np.asarray(JSE3.se3_exp(jnp.asarray(xi.astype(np.float32))), np.float64)
    gt = [np.eye(4)]
    for s in steps:
        gt.append(gt[-1] @ s)
    noise = np.asarray(JSE3.se3_exp(jnp.asarray((rng.standard_normal((n - 1, 6)) * 0.05)
                                                .astype(np.float32))))
    meas = [s @ e for s, e in zip(steps, noise)]
    src, dst = list(range(n - 1)), list(range(1, n))
    if closure:
        src.append(0)
        dst.append(n - 1)
        meas.append(np.linalg.inv(gt[0]) @ gt[-1])
    init = [np.eye(4)]
    for z in meas[: n - 1]:
        init.append(init[-1] @ z)
    weight = np.ones(len(src), np.float32)
    weight[n - 1:] = 50.0
    return (np.stack(init).astype(np.float32), np.array(src), np.array(dst),
            np.stack(meas).astype(np.float32), weight)


def both_factors(src, dst, meas, weight=None, **kw):
    return (JP.make_factors(src, dst, meas, weight, **kw),
            TP.make_factors(src, dst, meas, weight, device="cpu", **kw))


def info_6x6(f, seed=1):
    """(F, 6, 6) symmetric positive-definite information matrices."""
    a = np.random.default_rng(seed).standard_normal((f, 6, 6)) * 0.3
    return (np.eye(6) + a @ a.transpose(0, 2, 1)).astype(np.float32)


ACCUMULATE_CASES = {
    "quadratic": (None, {}),
    "huber": (("huber", 0.3), {}),
    "gm": (("gm", 1.0), {}),
    "gm_robust_mask": (("gm", 1.0), {"robust_mask": "closures"}),
    "info_6x6": (None, {"weight": "6x6"}),
    "huber_info_6x6": (("huber", 0.5), {"weight": "6x6"}),
    "padded_capacity": (("gm", 1.0), {"capacity": 16}),
}


@pytest.mark.parametrize("case", sorted(ACCUMULATE_CASES))
def test_accumulate_matches_jax(case):
    robust, extra = ACCUMULATE_CASES[case]
    init, src, dst, meas, weight = chain()
    kw = {"num_nodes": len(init)}
    if extra.get("weight") == "6x6":
        weight = info_6x6(len(src)) * weight[:, None, None]
    if extra.get("robust_mask") == "closures":
        kw["robust_mask"] = (np.arange(len(src)) >= len(init) - 1).astype(np.float32)
    if "capacity" in extra:
        kw["capacity"] = extra["capacity"]
    fj, ft = both_factors(src, dst, meas, weight, **kw)
    hj, bj, cj = j_accumulate(jnp.asarray(init), fj, robust=robust)
    ht, bt, ct = TP._accumulate(t(init), ft, robust=robust)
    scale = float(np.abs(np.asarray(hj)).max())
    close(ht, hj, atol=BLOCK_RTOL * scale)
    close(bt, bj, atol=BLOCK_RTOL * float(np.abs(np.asarray(bj)).max()))
    close(float(ct), float(cj), rtol=BLOCK_RTOL)


def prior_for(init, ids=(2, 3, 4), seed=2):
    """A dense PriorFactor over ``ids`` linearized slightly off ``init``."""
    rng = np.random.default_rng(seed)
    m = 6 * len(ids)
    a = rng.standard_normal((m, m)) * 0.5
    h = (a @ a.T + np.eye(m)).astype(np.float32)
    b = (rng.standard_normal(m) * 0.1).astype(np.float32)
    off = np.asarray(JSE3.se3_exp(jnp.asarray((rng.standard_normal((len(ids), 6)) * 0.02)
                                              .astype(np.float32))))
    lin = (init[list(ids)] @ off).astype(np.float32)
    ids = np.asarray(ids)
    return (JP.PriorFactor(node_ids=ids, h=jnp.asarray(h), b=jnp.asarray(b),
                           lin_poses=jnp.asarray(lin)),
            TP.PriorFactor(node_ids=ids, h=t(h), b=t(b), lin_poses=t(lin)))


def test_prior_contribution_and_shift_match_jax():
    init, *_ = chain()
    pj, pt = prior_for(init)
    for a, b in zip(TP._prior_contribution(t(init), pt),
                    JP._prior_contribution(jnp.asarray(init), pj)):
        close(a, b, atol=BLOCK_RTOL * max(1.0, float(np.abs(np.asarray(b)).max())))
    new_ids = np.array([5, 6, 7])
    shifted = pt.shifted(new_ids)
    assert np.array_equal(shifted.node_ids, new_ids) and shifted.h is pt.h
    close(TP._prior_contribution(t(init), shifted)[0],
          JP._prior_contribution(jnp.asarray(init), pj.shifted(new_ids))[0],
          atol=BLOCK_RTOL * float(np.abs(np.asarray(pj.h)).max()))


def test_assemble_system_and_marginalize_match_jax():
    init, src, dst, meas, weight = chain(n=8)
    fj, ft = both_factors(src, dst, meas, weight, num_nodes=8)
    hj, bj, cj = jax.jit(JP.assemble_system)(jnp.asarray(init), fj)
    ht, bt, ct = TP.assemble_system(t(init), ft)
    close(ht, hj, atol=BLOCK_RTOL * float(np.abs(np.asarray(hj)).max()))
    close(float(ct), float(cj), rtol=BLOCK_RTOL)
    # a gauge so that the kept block is well posed, then drop two nodes
    h = np.asarray(hj) + np.diag(np.r_[np.full(6, 1e3), np.zeros(42)]).astype(np.float32)
    keep, drop = np.array([0, 3, 4, 5, 6, 7]), np.array([1, 2])
    h_j, b_j = JP.marginalize(jnp.asarray(h), bj, keep, drop)
    h_t, b_t = TP.marginalize(t(h), t(np.asarray(bj)), keep, drop)
    close(h_t, h_j, atol=BLOCK_RTOL * float(np.abs(np.asarray(h_j)).max()))
    close(b_t, b_j, atol=BLOCK_RTOL * float(np.abs(np.asarray(b_j)).max()))


@pytest.mark.parametrize("with_prior", [False, True])
def test_optimize_matches_jax(with_prior):
    init, src, dst, meas, weight = chain(n=12, seed=3)
    fj, ft = both_factors(src, dst, meas, weight, num_nodes=12, capacity=16)
    pj, pt = prior_for(init) if with_prior else (None, None)
    cfg_j = JP.GaussNewtonConfig(iterations=6, robust_delta=1.0, robust_kernel="gm")
    cfg_t = TP.GaussNewtonConfig(iterations=6, robust_delta=1.0, robust_kernel="gm")
    oj, hj = JP.optimize(jnp.asarray(init), fj, cfg_j, prior=pj)
    ot, ht = TP.optimize(t(init), ft, cfg_t, prior=pt)
    assert ht.shape == (6,)
    close(ot, oj, atol=POSE_ATOL)
    close(ht, hj, rtol=1e-4)


# ---- scan factors ------------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_pair():
    """Dense boxy scans from two poses (numpy range images), and i_T_j."""
    world = boxy_scene(np.random.default_rng(3), n=16 * 8192)
    t_true = np.eye(4)
    c, s = np.cos(0.03), np.sin(0.03)
    t_true[:2, :2] = [[c, -s], [s, c]]
    t_true[:3, 3] = [0.4, 0.15, 0.02]

    def scan_from(pose):
        local = (world - pose[:3, 3]) @ pose[:3, :3]
        return np.asarray(project(local[np.linalg.norm(local[:, :2], axis=1) < 12.0]))

    return scan_from(np.eye(4)), scan_from(t_true), t_true.astype(np.float32)


def test_compute_normals_matches_jax(scan_pair):
    for img in scan_pair[:2]:
        nj, okj = JS.compute_normals(jnp.asarray(img))
        nt, okt = TS.compute_normals(t(img))
        assert np.array_equal(okt.numpy(), np.asarray(okj)) and int(okt.sum()) > 500
        close(nt, nj, atol=1e-6)


def test_projective_association_matches_jax(scan_pair):
    """Every weight equal: the warped points fall into the same pixels and
    pass the same gates in both packages."""
    img_i, img_j, t_ij = scan_pair
    nj_i, _ = JS.compute_normals(jnp.asarray(img_i))
    nj_j, _ = JS.compute_normals(jnp.asarray(img_j))
    nt_i, _ = TS.compute_normals(t(img_i))
    nt_j, _ = TS.compute_normals(t(img_j))
    cj = JS.projective_association(jnp.asarray(img_j), jnp.asarray(img_i), nj_i,
                                   jnp.asarray(t_ij), J_SENSOR, max_dist=1.0, normals_j=nj_j)
    ct = TS.projective_association(t(img_j), t(img_i), nt_i, t(t_ij), T_SENSOR, max_dist=1.0,
                                   normals_j=nt_j)
    assert np.array_equal(ct.w.numpy(), np.asarray(cj.w)) and float(ct.w.sum()) > 500
    close(ct.p_j, cj.p_j)
    close(ct.q_i, cj.q_i)
    close(ct.n_i, cj.n_i, atol=1e-6)


def test_scan_factor_assembly_matches_jax(scan_pair):
    img_i, img_j, t_ij = scan_pair
    pert = np.asarray(JSE3.se3_exp(jnp.asarray([0.05, -0.03, 0.01, 0.004, -0.002, 0.01])))
    poses = np.stack([np.eye(4), t_ij @ pert]).astype(np.float32)
    pairs = [(0, 1), (1, 0)]
    cj = [JS.correspondences_for_pair(jnp.asarray(a), jnp.asarray(b), jnp.asarray(poses[i]),
                                      jnp.asarray(poses[j]), J_SENSOR, subsample=2)
          for (i, j), (a, b) in zip(pairs, [(img_i, img_j), (img_j, img_i)])]
    ct = [TS.correspondences_for_pair(t(a), t(b), t(poses[i]), t(poses[j]), T_SENSOR,
                                      subsample=2)
          for (i, j), (a, b) in zip(pairs, [(img_i, img_j), (img_j, img_i)])]
    for a, b in zip(ct, cj):
        assert np.array_equal(a.w.numpy(), np.asarray(b.w))
    sj, st = JS.make_scan_factors(pairs, cj), TS.make_scan_factors(pairs, ct)
    hj, bj, chj = j_scan_accumulate(jnp.asarray(poses), sj)
    ht, bt, cht = TS.accumulate_scan_factors(t(poses), st)
    close(ht, hj, atol=BLOCK_RTOL * float(np.abs(np.asarray(hj)).max()))
    close(bt, bj, atol=BLOCK_RTOL * float(np.abs(np.asarray(bj)).max()))
    close(float(cht), float(chj), rtol=BLOCK_RTOL)
    # one GN solve with the scan factors
    fj, ft = both_factors([0], [1], np.eye(4, dtype=np.float32)[None], [1e-6], num_nodes=2)
    oj, _ = JP.optimize(jnp.asarray(poses), fj, JP.GaussNewtonConfig(iterations=3),
                        scan_factors=sj)
    ot, _ = TP.optimize(t(poses), ft, TP.GaussNewtonConfig(iterations=3), scan_factors=st)
    close(ot, oj, atol=POSE_ATOL)


def test_icp_refine_matches_jax(scan_pair):
    img_i, img_j, t_ij = scan_pair
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [0.08, -0.05, 0.02]
    t0 = t_ij @ pert
    out_j = JS.icp_refine(jnp.asarray(img_i), jnp.asarray(img_j), jnp.asarray(t0), J_SENSOR,
                          iters=12, max_dist=1.0, subsample=2)
    out_t = TS.icp_refine(t(img_i), t(img_j), t(t0), T_SENSOR, iters=12, max_dist=1.0,
                          subsample=2)
    close(out_t[0], out_j[0], atol=POSE_ATOL)
    close(float(out_t[1]), float(out_j[1]), atol=1e-6)
    close(float(out_t[2]), float(out_j[2]), rtol=1e-4)


# ---- mapping --------------------------------------------------------------------

def test_mapping_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    poses = [np.asarray(JSE3.se3_exp(jnp.asarray(rng.standard_normal(6).astype(np.float32))),
                        np.float64) for _ in range(3)]
    payloads = []
    for k in range(3):
        img = rng.uniform(-20, 20, (8, 16, 3)).astype(np.float32)
        img[rng.random((8, 16)) < 0.3] = 0.0
        payloads.append(img)
    payloads[1] = None
    assert np.array_equal(TM.range_image_points(payloads[0]), JM.range_image_points(payloads[0]))
    pts = rng.uniform(-5, 5, (500, 3))
    assert np.array_equal(TM.voxel_downsample(pts, 0.7), JM.voxel_downsample(pts, 0.7))
    for voxel, max_range in ((0.5, None), (0.3, 15.0), (0.0, 25.0)):
        assert np.array_equal(TM.assemble_map(poses, payloads, voxel, max_range),
                              JM.assemble_map(poses, payloads, voxel, max_range))
    TM.save_map_ply(str(tmp_path / "t.ply"), pts)
    JM.save_map_ply(str(tmp_path / "j.ply"), pts)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_factor_containers_hold_the_jax_fields():
    """The port's containers carry the same fields as the JAX package's."""
    for a, b in ((TP.FactorGraph, JP.FactorGraph), (TP.PriorFactor, JP.PriorFactor),
                 (TS.ScanFactorSet, JS.ScanFactorSet), (TS.Correspondences, JS.Correspondences),
                 (TP.GaussNewtonConfig, JP.GaussNewtonConfig)):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
