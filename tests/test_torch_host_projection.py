"""Parity of the port's host-projection slice with the JAX package, on the CPU.

The exact projection methods, the native library's bindings, the host
crop / augment / project path, the loader's host-projected batches, the
host-projected train step and the host-projected stream.  Tiny config
unless stated; inputs made with numpy from a seed and handed to both
packages.  Tolerances:

* numpy code and the native library (reads, crops, mirroring, loader
  arrays, host images): equal.  Both packages' bindings load the library
  the port builds from ``native/lidar_io.cpp`` (the JAX package's library
  list is pointed at it), so the images are bit-equal, and the two
  packages' numpy twins give the same arrays.  The fused pass is held to
  the two-pass path bit for bit (same compiler, same float order);
* images of two implementations of atan2 / asin: equal but for pixels
  that hold a point near a pixel border, where they may truncate
  differently (the rule of
  ``test_torch_ops.py::test_packed_projection_matches_jax``): within 1e-4
  for the port's exact projections against the JAX package's, 3e-4 (a few
  float32 ulps of a column coordinate) for the native projector against
  its numpy twin, whose float32 arctan2 differs from libm's; within the
  port, ``sort`` equals ``scatter`` bit for bit;
* the port's crop twin against its device ``preprocess``: atol 1e-5;
* the train step against the JAX package's (scan order, dropout 0,
  near-identity pose heads as in ``test_torch_train.py``): loss rtol 1e-6,
  gradients, parameters and statistics as ``test_torch_train.py`` holds
  them; against the port's own device step fed the same images: equal;
  int16 images against float: the JAX package's rtol 0.02 / atol 0.05;
* the stream: poses atol 1e-4, ``last_projection`` equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficientlo_net_torch.config import SensorConfig as TSensor
from efficientlo_net_torch.config import TrainConfig as TTrainConfig
from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data import augmentation as TA
from efficientlo_net_torch.data import host_preprocess as THP
from efficientlo_net_torch.data import kitti as TK
from efficientlo_net_torch.data import loader as TLoader
from efficientlo_net_torch.data import native_io as TN
from efficientlo_net_torch.data.synthetic import random_scene
from efficientlo_net_torch.evaluation.streaming import OdometryStream as TStream
from efficientlo_net_torch.models import preprocess as TPre
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_torch.ops import projection as TP
from efficientlo_net_torch.pretrained import train_state_to_torch
from efficientlo_net_torch.training import state as TState
from efficientlo_net_torch.training import step as TStep
from efficientlo_net_torch.training.trainer import train_indices_for
from efficientlo_net_tpu.config import SensorConfig as JSensor
from efficientlo_net_tpu.config import TrainConfig as JTrainConfig
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import augmentation as JA
from efficientlo_net_tpu.data import host_preprocess as JHP
from efficientlo_net_tpu.data import kitti as JK
from efficientlo_net_tpu.data import loader as JLoader
from efficientlo_net_tpu.data import native_io as JN
from efficientlo_net_tpu.data.synthetic import synthetic_batch
from efficientlo_net_tpu.evaluation.streaming import OdometryStream as JStream
from efficientlo_net_tpu.models.losses import total_loss as j_total_loss
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops.projection import project_to_range_image as j_project
from efficientlo_net_tpu.training import state as JState
from efficientlo_net_tpu.training.step import _forward_inputs_projected as j_inputs_projected
from tests.test_model import synthetic_scan
from tests.test_torch_ops import _boundary_points
from tests.test_torch_train import (ADAM_FLIP_ATOL, FEAT_TOL, PARAM_ATOL, ROUNDING_GRAD,
                                    assert_grads_close, flat_grads, flat_stats, torch_stats)
from tests.torch_cases import KITTI_SEQ, build_fake_kitti
from tests.torch_parity import near_identity_heads, randomize_batch_stats, t, to_torch_module

CFG = t_tiny()
FULL = TSensor()
POSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes gain nothing from torch's intra-op threads, and the suite
    runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def same_library(monkeypatch):
    """Point the JAX package's bindings at the port's build of
    ``native/lidar_io.cpp`` (it never reads ``native/`` here, which another
    test may be building into); restored after the test."""
    assert TN.available(), "the host C++ compiler builds the native library"
    monkeypatch.setattr(JN, "_LIB_PATHS", [str(TN.library_path())])
    monkeypatch.setattr(JN, "_lib", None)
    assert JN.available()


def assert_equal_but_at_borders(img_a, img_b, pts, sensor, also=False, tol=1e-4):
    """(B, H, W, 3) images of the clouds ``pts`` (B, N, 3) are equal but
    for pixels (where ``also`` is set, too) that hold, in one of them, a
    point within ``tol`` of a pixel border: there atan2 / asin of two
    implementations may truncate differently."""
    b, height, width, _ = img_a.shape
    differs = np.any(img_a != img_b, axis=-1) | also
    near = _boundary_points(pts, height, width, sensor, tol)
    for bi, hi, wi in zip(*np.nonzero(differs)):
        holders = [v for v in (img_a[bi, hi, wi], img_b[bi, hi, wi]) if np.any(v != 0)]
        assert any(near[bi][np.all(pts[bi] == v, axis=-1)].any() for v in holders), (bi, hi, wi)
    assert differs.sum() <= max(2, near.sum())


def _cloud(rng, b, n):
    """(B, N, 3) scans with a padding block and exact duplicates (range
    ties, which the lowest index must win)."""
    pts = np.stack([synthetic_scan(rng, n) for _ in range(b)])
    pts[:, ::7] = 0.0
    pts[:, n // 2:n // 2 + n // 20] = pts[:, 1:1 + n // 20]
    return pts


# ---------------------------------------------------------------------------
# The exact projections


@pytest.mark.parametrize("method", ["sort", "scatter"])
@pytest.mark.parametrize("height,width,n", [(16, 128, 2048), (64, 1800, 20000)])
def test_exact_projection_matches_jax(height, width, n, method):
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 2, n)
    feats = rng.standard_normal(pts.shape[:2] + (5,)).astype(np.float32)
    js, ts = JSensor(height=height, width=width), TSensor(height=height, width=width)
    j_img, j_feat = (np.asarray(a) for a in j_project(jnp.asarray(pts), jnp.asarray(feats),
                                                      height, width, js, method=method))
    t_img, t_feat = (a.numpy() for a in TP.project_to_range_image(t(pts), t(feats), height,
                                                                  width, ts, method=method))
    assert_equal_but_at_borders(t_img, j_img, pts, js, np.any(j_feat != t_feat, axis=-1))
    # within the port the two exact methods give one image, bit for bit
    other = "scatter" if method == "sort" else "sort"
    o_img, o_feat = TP.project_to_range_image(t(pts), t(feats), height, width, ts, method=other)
    np.testing.assert_array_equal(o_img.numpy(), t_img)
    np.testing.assert_array_equal(o_feat.numpy(), t_feat)


def test_default_method_keeps_the_nearest_point_beyond_60m():
    """The repair: two points in one direction, 70 m (lower index) and 65 m.
    The default keeps the nearer one in both packages; packed clips both
    ranges to its 60 m top step and keeps the lower index, the 70 m point."""
    d = np.array([1.0, 0.3, -0.05])
    d /= np.linalg.norm(d)
    pts = np.stack([70.0 * d, 65.0 * d]).astype(np.float32)[None]
    s = FULL
    for method, keep in ((None, 1), ("packed", 0)):
        kw = {} if method is None else {"method": method}
        j_img = np.asarray(j_project(jnp.asarray(pts), None, s.height, s.width, JSensor(), **kw)[0])
        t_img = TP.project_to_range_image(t(pts), None, s.height, s.width, s, **kw)[0].numpy()
        for img in (j_img, t_img):
            occupied = img[np.any(img != 0, axis=-1)]
            np.testing.assert_array_equal(occupied, pts[0, keep:keep + 1])


# ---------------------------------------------------------------------------
# The native library's bindings


def test_native_reads_match_jax_and_numpy(tmp_path, same_library):
    paths, clouds = [], []
    for i in range(5):
        pts = np.random.default_rng(i).standard_normal((300 + 50 * i, 4)).astype(np.float32)
        paths.append(str(tmp_path / f"{i:06d}.bin"))
        pts.tofile(paths[-1])
        clouds.append(pts)
    for num_points in (100, 400):  # truncated and zero-padded
        for p in paths:
            got = TN.read_scan(p, num_points)
            np.testing.assert_array_equal(got, JN.read_scan(p, num_points))
            np.testing.assert_array_equal(got, TN._read_scan_numpy(p, num_points))
            np.testing.assert_array_equal(got, JN._read_scan_numpy(p, num_points))
        got = TN.read_batch(paths, num_points, num_threads=3)
        np.testing.assert_array_equal(got, JN.read_batch(paths, num_points, num_threads=3))
        np.testing.assert_array_equal(got, np.stack([TN._read_scan_numpy(p, num_points)
                                                     for p in paths]))
    np.testing.assert_array_equal(TN.read_scan(paths[4], 600)[:500], clouds[4][:, :3])
    for read in (TN.read_scan, TN._read_scan_numpy):
        with pytest.raises(FileNotFoundError):
            read(str(tmp_path / "missing.bin"), 10)
    with pytest.raises(FileNotFoundError):
        TN.read_batch(paths + [str(tmp_path / "missing.bin")], 10)


def _full_cloud(seed, b=2, n=30000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, size=(b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 8, size=(b, n)).astype(np.float32)
    pts[:, : n // 50] = 0.0
    return pts


@pytest.mark.parametrize("crop", [0.0, 35.0])
def test_native_projection_matches_jax_and_numpy(crop, same_library):
    s = FULL
    up, down = math.radians(s.vertical_fov_up_deg), math.radians(s.vertical_fov_down_deg)
    pts = _full_cloud(seed=3)
    got = TN.project_batch(pts, s.height, s.width, s, crop_radius=crop)
    np.testing.assert_array_equal(got, JN.project_batch(pts, s.height, s.width, JSensor(),
                                                        crop_radius=crop))
    for i in range(len(pts)):
        scan = TN.project_scan(pts[i], s.height, s.width, s, crop_radius=crop)
        np.testing.assert_array_equal(scan, got[i])
        np.testing.assert_array_equal(scan, JN.project_scan(pts[i], s.height, s.width,
                                                            JSensor(), crop_radius=crop))
        twin = TN._project_scan_numpy(pts[i], s.height, s.width, up, down, crop)
        # numpy's float32 arctan2 / arcsin against libm's: a few ulps of a
        # column coordinate, one of which is 1.2e-4 below 2048
        assert_equal_but_at_borders(scan[None], twin[None], pts[i:i + 1], JSensor(), tol=3e-4)
        np.testing.assert_array_equal(
            twin, JN._project_scan_numpy(pts[i], s.height, s.width, up, down, crop))


def test_native_chunk_parallel_equals_sequential():
    """The multi-threaded single-scan path merges private planes in index
    order: the sequential image, bit for bit, exact range ties included."""
    s = FULL
    pts = _full_cloud(seed=7, b=1, n=150000)[0]
    pts[100000:101000] = pts[:1000]
    seq = TN.project_scan(pts, s.height, s.width, s, num_threads=1)
    for nt in (2, 4, 8):
        np.testing.assert_array_equal(TN.project_scan(pts, s.height, s.width, s, num_threads=nt),
                                      seq)


def _raw_batch(seed=0, b=2, sensor=CFG.sensor):
    batch = synthetic_batch(np.random.default_rng(seed), b, sensor, training=True)
    # exercise the crop and the padding
    batch["pc1"][:, :7, :2] *= 50.0
    batch["pc1"][:, 7:12] = 0.0
    batch["pc2"][:, 3:9] = 0.0
    return batch


def test_fused_native_equals_two_pass():
    batch = _raw_batch(seed=3, b=4)
    batch["aug_frame"] = np.array([1, 2, 1, 2], dtype=batch["aug_frame"].dtype)
    s = CFG.sensor
    sign = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
    mirrored = {k: batch[k].copy() for k in ("pc1", "pc2")}
    for v in mirrored.values():
        v[..., 1] *= sign[:, None]
    pc1, pc2 = THP.crop_and_augment(mirrored["pc1"], mirrored["pc2"], batch["T_trans"],
                                    batch["aug_frame"], s.max_planar_radius)
    aug = batch["aug_frame"]
    for key, two_pass, apply in (("pc1", pc1, aug == 1), ("pc2", pc2, aug != 1)):
        fused = TN.augment_project_batch_native(batch[key], batch["T_trans"], apply, s.height,
                                                s.width, s, ysign=sign)
        np.testing.assert_array_equal(fused, TN.project_batch(two_pass, s.height, s.width, s))


# ---------------------------------------------------------------------------
# Host preprocessing, mirroring and the loader


def test_crop_and_augment_matches_jax_and_device_preprocess():
    batch = _raw_batch()
    args = (batch["pc1"], batch["pc2"], batch["T_trans"], batch["aug_frame"])
    got = THP.crop_and_augment(*args, max_planar_radius=CFG.sensor.max_planar_radius)
    want = JHP.crop_and_augment(*args, max_planar_radius=CFG.sensor.max_planar_radius)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    dev = TPre.preprocess(*(t(batch[k]) for k in ("pc1", "pc2", "T_gt", "T_trans",
                                                  "T_trans_inv", "aug_frame")),
                          max_planar_radius=CFG.sensor.max_planar_radius)
    np.testing.assert_allclose(got[0], dev[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1], dev[1].numpy(), atol=1e-5)
    assert not np.any(got[0][:, 7:12]) and not np.any(got[1][:, 3:9])


@pytest.mark.parametrize("fused", [True, False])
def test_augment_project_batch_matches_jax(fused, same_library, monkeypatch):
    """Both paths: the fused ABI-3 pass and the two-pass fallback (patched
    on both sides), with and without a deferred mirror."""
    if not fused:
        monkeypatch.setattr(TN, "fused_available", lambda: False)
        monkeypatch.setattr(JN, "fused_available", lambda: False)
    batch = _raw_batch(seed=4, b=4)
    batch["aug_frame"] = np.array([1, 2, 2, 1], dtype=batch["aug_frame"].dtype)
    deferred = TA.mirror_batch(dict(batch), np.random.default_rng(11), clouds=False)
    assert (deferred["mirror_sign"] < 0).any()
    for b in (batch, deferred):
        got = THP.augment_project_batch(b, CFG.sensor)
        want = JHP.augment_project_batch(b, j_tiny().sensor)
        assert list(got) == list(want) == ["p1", "p2", "T_gt", "T_trans", "T_trans_inv",
                                           "aug_frame"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the deferred mirror gives the images of mirroring the clouds first
    cloud = TA.mirror_batch(dict(batch), np.random.default_rng(11))
    ref = THP.augment_project_batch(cloud, CFG.sensor)
    out = THP.augment_project_batch(deferred, CFG.sensor)
    for k in ("p1", "p2", "T_gt"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_mirror_batch_without_clouds_matches_jax():
    batch = _raw_batch(seed=5, b=8)
    for seed in range(4):  # some seeds flip no sample, most flip some
        got = TA.mirror_batch(batch, np.random.default_rng(seed), clouds=False)
        want = JA.mirror_batch(batch, np.random.default_rng(seed), clouds=False)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["pc1"] is batch["pc1"]  # the clouds are not copied


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    scene = random_scene(np.random.default_rng(0), 4096, CFG.sensor)
    return build_fake_kitti(tmp_path_factory.mktemp("kitti"), scene,
                            CFG.sensor.num_points)[:2]


def test_host_projected_loader_matches_jax(tree, same_library):
    """Every batch of a host-projected epoch, key by key: the arrays and the
    images (both sides project with the same library) equal."""
    root, gt_dir = tree
    n = CFG.sensor.num_points
    t_ds = TK.OdometryDataset(root, n, gt_dir, cache_scans=True)
    j_ds = JK.OdometryDataset(root, n, gt_dir, cache_scans=True)
    idxs = train_indices_for([KITTI_SEQ])[:40]
    kw = dict(training=True, seed=3)
    got = list(TLoader.PrefetchLoader(t_ds, idxs, 8, host_projection_sensor=CFG.sensor,
                                      **kw).epoch(1))
    want = list(JLoader.PrefetchLoader(j_ds, idxs, 8, host_projection_sensor=j_tiny().sensor,
                                       **kw).epoch(1))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["p1", "p2", "T_gt", "T_trans", "T_trans_inv",
                                      "aug_frame"]
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # make_batch before projection: the clouds unmirrored, the sign carried
    raw = TLoader.make_batch(t_ds, idxs[:8], np.random.default_rng(2), True, mirror_clouds=False)
    ref = JLoader.make_batch(j_ds, idxs[:8], np.random.default_rng(2), True, mirror_clouds=False)
    assert raw.keys() == ref.keys() and "mirror_sign" in raw
    for k in ref:
        np.testing.assert_array_equal(raw[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# The host-projected train step


@pytest.fixture(scope="module")
def projected():
    """The tiny network with dropout 0 and near-identity pose heads, one
    host-projected batch (B=2), the JAX package's inputs for it
    (``_forward_inputs_projected``) and one compiled JAX loss-and-gradient
    function (scan order).  Near-identity heads keep the warped points
    near their pixels, but a batch may still put one within float rounding
    of a pixel border, where the two packages' poses send it to different
    pixels: seed 2's batch has one (gradients 2.7e-3 of their scale apart
    through it).  This seed's has none."""
    j_cfg = dataclasses.replace(j_tiny(), dropout_rate=0.0)
    t_cfg = dataclasses.replace(CFG, dropout_rate=0.0)
    raw = _raw_batch(seed=5)
    batch = THP.augment_project_batch(raw, t_cfg.sensor)
    model = JNet(j_cfg)
    p0 = jnp.asarray(batch["p1"])
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p0, p0, training=False)
    variables = randomize_batch_stats(variables)

    def loss_fn(params, batch_stats, inputs, bn_momentum):
        p1, p2, q_gt, t_gt = inputs
        out, mutated = model.apply({"params": params["model"], "batch_stats": batch_stats},
                                   p1, p2, training=True, bn_momentum=bn_momentum,
                                   stochastic=False, mutable=["batch_stats"])
        loss, metrics = j_total_loss(out, q_gt, t_gt, params["w_x"], params["w_q"])
        return loss, (mutated["batch_stats"], metrics)

    params = {"model": near_identity_heads(variables["params"]), "w_x": jnp.float32(0.1),
              "w_q": jnp.float32(-2.4)}
    inputs = jax.jit(j_inputs_projected)({k: jnp.asarray(v) for k, v in batch.items()})
    return dict(t_cfg=t_cfg, raw=raw, batch=batch, params=params, inputs=inputs,
                batch_stats=variables["batch_stats"],
                grad_fn=jax.jit(jax.grad(loss_fn, has_aux=True)))


def _state(projected):
    host = jax.tree_util.tree_map(np.asarray, (projected["params"], projected["batch_stats"]))
    state_dict, w_x, w_q = train_state_to_torch(*host)
    model = TNet(projected["t_cfg"])
    model.load_state_dict(state_dict, strict=True)
    return TState.create_train_state(model, TTrainConfig(batch_size=2), device="cpu",
                                     w_x=w_x, w_q=w_q)


def _step(projected, batch, host_projected, monkeypatch):
    """One step of the port's train step in scan order; returns (metrics,
    gradients by name, state)."""
    monkeypatch.setattr(TNet, "_perm", staticmethod(lambda kernel_size, stochastic, gen: None))
    state = _state(projected)
    step = TStep.make_train_step(projected["t_cfg"], TTrainConfig(batch_size=2),
                                 host_projected=host_projected)
    state, metrics = step(state, batch, torch.Generator())
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    grads.update(w_x=state.w_x.grad, w_q=state.w_q.grad)
    return metrics, grads, state


def test_projected_step_matches_jax(projected, monkeypatch):
    """The port's host-projected step against the JAX package's projected
    inputs, loss, gradients and one Adam update, on the same images."""
    j_tcfg = JTrainConfig(batch_size=2)
    bn_m = JState.bn_momentum_schedule(j_tcfg)(jnp.int32(0))
    grads, (stats, metrics) = projected["grad_fn"](projected["params"], projected["batch_stats"],
                                                   projected["inputs"], bn_m)
    tx = JState.make_optimizer(j_tcfg)
    params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, projected["params"])

    got_metrics, got_grads, state = _step(projected, projected["batch"], True, monkeypatch)
    np.testing.assert_allclose(got_metrics["loss"].item(), float(metrics["loss"]), rtol=1e-6)
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k].item(), float(metrics[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    want_grads = {**flat_grads(grads["model"]), "w_x": grads["w_x"], "w_q": grads["w_q"]}
    assert_grads_close({k: g.numpy() for k, g in got_grads.items()}, want_grads)
    top = max(np.abs(g).max() for g in want_grads.values())
    want = flat_grads(params["model"])
    got = {k: p.detach().numpy() for k, p in state.model.named_parameters()}
    for k in want:  # an Adam step on a rounding-level gradient may flip its sign
        atol = np.where(np.abs(want_grads[k]) < ROUNDING_GRAD * top, ADAM_FLIP_ATOL, PARAM_ATOL)
        assert np.all(np.abs(got[k] - want[k]) <= atol), k
    for name in ("w_x", "w_q"):
        np.testing.assert_allclose(getattr(state, name).item(), float(params[name]),
                                   atol=PARAM_ATOL)
    got_stats, want_stats = torch_stats(state.model), flat_stats(stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], err_msg=k, **FEAT_TOL)


def test_projected_step_equals_device_step_on_its_images(projected, monkeypatch):
    """Fed the images the device step projects itself, the projected step is
    the same optimization, bit for bit."""
    raw = projected["raw"]
    p1, p2, _, _ = TStep._forward_inputs(raw, projected["t_cfg"].sensor, "cpu")
    batch = dict({k: raw[k] for k in ("T_gt", "T_trans", "T_trans_inv", "aug_frame")},
                 p1=p1, p2=p2)
    m_dev, g_dev, s_dev = _step(projected, raw, False, monkeypatch)
    m_proj, g_proj, s_proj = _step(projected, batch, True, monkeypatch)
    for k in m_dev:
        assert torch.equal(m_dev[k], m_proj[k]), k
    for k in g_dev:
        assert torch.equal(g_dev[k], g_proj[k]), k
    for (k, a), b in zip(s_dev.model.state_dict().items(), s_proj.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_quantized_projected_transfer_matches_float(projected, monkeypatch):
    """int16 images (1.25 mm steps) track the float loss within the JAX
    package's quantization allowance."""
    batch = projected["batch"]
    i16 = dict(batch, p1=TLoader.quantize_points(batch["p1"]),
               p2=TLoader.quantize_points(batch["p2"]))
    assert i16["p1"].dtype == np.int16
    m_f, _, _ = _step(projected, batch, True, monkeypatch)
    m_q, _, _ = _step(projected, i16, True, monkeypatch)
    np.testing.assert_allclose(m_q["loss"].item(), m_f["loss"].item(), rtol=0.02, atol=0.05)


# ---------------------------------------------------------------------------
# The host-projected stream


def test_host_projected_stream_matches_jax(same_library):
    cfg = j_tiny()
    rng = np.random.default_rng(0)
    scans = [synthetic_scan(rng, cfg.sensor.num_points) for _ in range(3)]
    scans[1][::5] = 0.0
    scans[2][:40, :2] *= 1.3  # beyond the 35 m crop
    p0 = jnp.asarray(JN.project_scan(scans[0], cfg.sensor.height, cfg.sensor.width,
                                     cfg.sensor)[None])
    model = JNet(cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p0, p0, training=False)
    variables = randomize_batch_stats(variables)
    j_stream = JStream(model, variables, cfg, host_projection=True)
    t_stream = TStream(to_torch_module(TNet(CFG), variables), CFG, device="cpu",
                       host_projection=True)
    for s in scans:
        jq, jt = j_stream.push(s)
        tq, tt = t_stream.push(s)
        np.testing.assert_allclose(tq, jq, atol=POSE_ATOL)
        np.testing.assert_allclose(tt, jt, atol=POSE_ATOL)
        np.testing.assert_array_equal(t_stream.last_projection.numpy(),
                                      np.asarray(j_stream.last_projection))
