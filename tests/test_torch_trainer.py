"""Parity of the port's dataset, loader, metrics and sequence evaluation with
the JAX package, on the CPU.

A fake KITTI tree for sequence 04 (271 frames, tiny config,
``torch_cases.build_fake_kitti``) is read by both packages.  Tolerances:

* numpy code (dataset items, index maps, calibration, loader batches,
  augmentation and mirroring): equal;
* trajectory integration and the KITTI metrics, the same numpy arithmetic
  on the same arrays: atol 1e-12;
* the streaming eval functions with the same weights: pyramids and (q, t)
  atol 1e-5 (float32 sums in another order); within the port, streaming
  (q, t) equals the pairwise eval step to 1e-6;
* the runners over the 271 frames at B=8, with JAX-initialised weights
  whose pose heads predict near-identity motion (``near_identity_heads``):
  (q, t) atol 1e-4.  Integration adds each frame's error to the chain, so
  over 271 frames the KITTI rows may differ by 271 x 1e-4 = 2.7e-2 (the
  predicted motion is small, so a rotation error moves little), and t_rel
  (a 100 m segment's end-point error over its length, in %) by 100 x 2 x
  2.7e-2 / 100 = 0.054.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data import augmentation as TA
from efficientlo_net_torch.data import kitti as TK
from efficientlo_net_torch.data import loader as TLoader
from efficientlo_net_torch.data.synthetic import random_scene
from efficientlo_net_torch.evaluation import kitti_metrics as TM
from efficientlo_net_torch.evaluation import odometry as TO
from efficientlo_net_torch.evaluation import runner as TR
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_torch.training import step as TStep
from efficientlo_net_torch.training.trainer import train_indices_for
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import augmentation as JA
from efficientlo_net_tpu.data import kitti as JK
from efficientlo_net_tpu.data import loader as JLoader
from efficientlo_net_tpu.evaluation import kitti_metrics as JM
from efficientlo_net_tpu.evaluation import odometry as JO
from efficientlo_net_tpu.evaluation import runner as JR
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.training import step as JStep
from efficientlo_net_tpu.training.trainer import train_indices_for as j_train_indices_for
from tests.test_model import synthetic_scan
from tests.torch_cases import KITTI_SEQ, build_fake_kitti
from tests.torch_parity import near_identity_heads, randomize_batch_stats, to_torch_module

SEQ = KITTI_SEQ
NUM_POINTS = t_tiny().sensor.num_points
METRIC_ATOL = 1e-12
PYR_ATOL = 1e-5
POSE_ATOL = 1e-4
ROWS_ATOL = 2.7e-2
T_REL_ATOL = 0.054


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes gain nothing from torch's intra-op threads, and the suite
    runs several worker processes at once: one thread each keeps them from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    scene = random_scene(np.random.default_rng(0), 4096, t_tiny().sensor)
    root, gt_dir, _ = build_fake_kitti(tmp_path_factory.mktemp("kitti"), scene, NUM_POINTS)
    return root, gt_dir


def _datasets(tree, gt_dir=None, **kw):
    root, default_gt = tree
    gt = gt_dir or default_gt
    return (TK.OdometryDataset(root, NUM_POINTS, gt, **kw),
            JK.OdometryDataset(root, NUM_POINTS, gt, **kw))


def _assert_equal_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Dataset, indices, calibration


def test_dataset_items_locate_and_calibration_match_jax(tree, tmp_path):
    root, gt_dir = tree
    assert TK.SEQ_LENGTH_TABLE == JK.SEQ_LENGTH_TABLE and TK.SEQ_NAMES == JK.SEQ_NAMES
    calib = os.path.join(root, "04", "calib.txt")
    got, want = TK.read_calib_file(calib), JK.read_calib_file(calib)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(TK.load_tr(calib), JK.load_tr(calib)):
        np.testing.assert_array_equal(g, w)
    for index in (0, 1, 4540, 4541, 11104, 11105, 11374, 11375, 43551):
        assert TK.OdometryDataset(root).locate(index) == JK.OdometryDataset(root).locate(index)
    pose_path = os.path.join(gt_dir, "04.txt")
    np.testing.assert_array_equal(TK.t_diff_from_poses(pose_path), JK.t_diff_from_poses(pose_path))

    # with kitti_T_diff/, and with only the devkit's absolute poses
    bare_gt = tmp_path / "ground_truth_pose"
    bare_gt.mkdir()
    shutil.copy(pose_path, bare_gt / "04.txt")
    first = TK.SEQ_LENGTH_TABLE[SEQ]
    for gt in (gt_dir, str(bare_gt)):
        for cache in (False, True):
            t_ds, j_ds = _datasets(tree, gt, cache_scans=cache)
            for index in (first, first + 1, first + 7, first + 135, first + 270):
                _assert_equal_items(t_ds[index], j_ds[index])
                _assert_equal_items(t_ds[index], j_ds[index])  # a cached read


def test_train_and_sequence_indices_match_jax():
    for seqs in ([4], [0, 4], list(range(7)), list(range(7, 11))):
        np.testing.assert_array_equal(train_indices_for(seqs), j_train_indices_for(seqs))
    for seq in (0, 4, 10, 21):
        np.testing.assert_array_equal(TR.sequence_indices(seq), JR.sequence_indices(seq))


# ---------------------------------------------------------------------------
# Batches and the loader


def test_make_batch_and_mirror_match_jax(tree):
    t_ds, j_ds = _datasets(tree)
    idxs = TK.SEQ_LENGTH_TABLE[SEQ] + np.array([3, 0, 150, 77, 270, 12, 44, 1])
    for training in (True, False):
        got = TLoader.make_batch(t_ds, idxs, np.random.default_rng(5), training)
        want = JLoader.make_batch(j_ds, idxs, np.random.default_rng(5), training)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    batch = TLoader.make_batch(t_ds, idxs, np.random.default_rng(6), False)
    for seed in range(4):  # some seeds flip no sample, most flip some
        got = TA.mirror_batch(batch, np.random.default_rng(seed))
        want = JA.mirror_batch(batch, np.random.default_rng(seed))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_loader_epochs_match_jax(tree, training, drop_last):
    """Every batch of an epoch, key by key, mirrored samples included."""
    t_ds, j_ds = _datasets(tree, cache_scans=True)
    idxs = train_indices_for([SEQ])
    kw = dict(training=training, seed=3, drop_last=drop_last)
    t_loader = TLoader.PrefetchLoader(t_ds, idxs, 8, **kw)
    j_loader = JLoader.PrefetchLoader(j_ds, idxs, 8, **kw)
    assert len(t_loader) == len(j_loader) == (33 if drop_last else 34)
    for epoch in (0, 1):
        got, want = list(t_loader.epoch(epoch)), list(j_loader.epoch(epoch))
        assert len(got) == len(want) == len(j_loader)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_transform_maps_each_batch_in_order(tree):
    """``transform`` (the trainer's quantize-and-pin stage) runs on each
    batch in the workers; the epoch is otherwise unchanged, and
    ``to_device`` takes its tensors as it takes arrays."""
    t_ds, _ = _datasets(tree, cache_scans=True)
    idxs = train_indices_for([SEQ])[:40]
    kw = dict(training=True, seed=3)
    plain = list(TLoader.PrefetchLoader(t_ds, idxs, 8, **kw).epoch(1))

    def stage(batch):
        return {k: torch.from_numpy(TLoader.quantize_points(v) if k in ("pc1", "pc2") else v)
                for k, v in batch.items()}

    staged = list(TLoader.PrefetchLoader(t_ds, idxs, 8, transform=stage, **kw).epoch(1))
    assert len(staged) == len(plain) == 5
    for s, p in zip(staged, plain):
        moved = TLoader.to_device(s, "cpu")
        for k in p:
            want = TLoader.quantize_points(p[k]) if k in ("pc1", "pc2") else p[k]
            np.testing.assert_array_equal(moved[k].numpy(), want, err_msg=k)


def test_abandoned_epoch_and_worker_errors(tree):
    """A consumer that stops early leaves no worker running; a worker's
    error reaches the consumer."""
    t_ds, _ = _datasets(tree)
    loader = TLoader.PrefetchLoader(t_ds, train_indices_for([SEQ]), 8, training=True,
                                    prefetch=2)
    epoch = loader.epoch(0)
    next(epoch)
    epoch.close()
    bad = TLoader.PrefetchLoader(t_ds, [TK.SEQ_LENGTH_TABLE[3]], 1, training=False)  # no seq 03
    with pytest.raises(FileNotFoundError):
        list(bad.epoch(0))


# ---------------------------------------------------------------------------
# Trajectories and the KITTI metrics


def test_integration_and_kitti_metrics_match_jax(tree, tmp_path):
    root, gt_dir = tree
    rng = np.random.default_rng(8)
    n = 271
    q = np.concatenate([np.ones((n, 1)), 0.01 * rng.standard_normal((n, 3))], axis=1)
    q[5] = 0.0  # a degenerate quaternion: the identity
    t = np.stack([0.5 + 0.02 * rng.standard_normal(n), 0.02 * rng.standard_normal(n),
                  0.01 * rng.standard_normal(n)], axis=1)
    q, t = q.astype(np.float32), t.astype(np.float32)
    tr, _ = TK.load_tr(os.path.join(root, "04", "calib.txt"))
    np.testing.assert_allclose(TO.quat_to_mat_np(q[3].astype(np.float64)),
                               JO.quat_to_mat_np(q[3].astype(np.float64)), atol=METRIC_ATOL)
    rows = TO.integrate_sequence(q, t, tr)
    np.testing.assert_allclose(rows, JO.integrate_sequence(q, t, tr), atol=METRIC_ATOL, rtol=0)
    np.testing.assert_allclose(TO.integrate_sequence(q, t), JO.integrate_sequence(q, t),
                               atol=METRIC_ATOL, rtol=0)
    TO.save_kitti_trajectory(str(tmp_path / "pred.txt"), rows)
    np.testing.assert_array_equal(TO.load_kitti_trajectory(str(tmp_path / "pred.txt")),
                                  JO.load_kitti_trajectory(str(tmp_path / "pred.txt")))

    gt_path = os.path.join(gt_dir, "04.txt")
    t_gt, j_gt = TM.load_poses(gt_path), JM.load_poses(gt_path)
    np.testing.assert_array_equal(np.stack(t_gt), np.stack(j_gt))
    got = TM.evaluate_sequence(t_gt, TM.poses_from_rows(rows), seq="04")
    want = JM.evaluate_sequence(j_gt, JM.poses_from_rows(rows), seq="04")
    assert got.errors and len(got.errors) == len(want.errors)
    for name in ("t_rel", "r_rel", "ate_m"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=METRIC_ATOL)
    assert got.summary() == want.summary()
    for fn in ("segment_error_table", "speed_error_table"):
        g, w = getattr(TM, fn)(got.errors), getattr(JM, fn)(want.errors)
        assert g.keys() == w.keys()
        for k in w:
            assert (g[k] is None) == (w[k] is None), (fn, k)
            if w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], atol=METRIC_ATOL)
    for align in (True, False):
        np.testing.assert_allclose(
            TM.absolute_trajectory_error(t_gt, TM.poses_from_rows(rows), align=align),
            JM.absolute_trajectory_error(j_gt, JM.poses_from_rows(rows), align=align),
            atol=METRIC_ATOL)
    TM.save_sequence_errors(got.errors, str(tmp_path / "t.txt"))
    JM.save_sequence_errors(want.errors, str(tmp_path / "j.txt"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt"),
                               atol=METRIC_ATOL)
    assert np.isnan(TM.overall_error([])[0])
    np.testing.assert_array_equal(TM.to_camera_coord(np.eye(4) * 2), JM.to_camera_coord(np.eye(4) * 2))


# ---------------------------------------------------------------------------
# Streaming eval functions and the runners


@pytest.fixture(scope="module")
def nets():
    """JAX variables of the tiny network (randomised batch norm, pose heads
    near identity) and the port's network with the same weights."""
    cfg = j_tiny()
    p = jax.numpy.zeros((1, cfg.sensor.height, cfg.sensor.width, 3))
    model = JNet(cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p, p, training=False)
    variables = randomize_batch_stats(variables)
    variables = {"params": near_identity_heads(variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    params = {"model": variables["params"]}
    return dict(j_model=model, params=params, batch_stats=variables["batch_stats"],
                t_model=to_torch_module(TNet(t_tiny()), variables))


def _scans(seed=9, n=3):
    rng = np.random.default_rng(seed)
    scans = np.stack([synthetic_scan(rng, NUM_POINTS) for _ in range(n)])
    scans[1, ::5] = 0.0  # padding
    scans[2, :40, :2] *= 1.3  # beyond the 35 m crop
    return scans


@pytest.mark.parametrize("quantized", [False, True])
def test_streaming_eval_fns_match_jax(nets, quantized):
    scans = _scans()
    points = TLoader.quantize_points(scans) if quantized else scans
    j_encode, j_correlate = JStep.make_streaming_eval_fns(nets["j_model"], j_tiny())
    t_encode, t_correlate = TStep.make_streaming_eval_fns(t_tiny())
    j_pyr = j_encode(nets["params"], nets["batch_stats"], jax.numpy.asarray(points))
    t_pyr = t_encode(nets["t_model"], points)
    assert len(t_pyr) == len(j_pyr) == 4
    for t_lvl, j_lvl in zip(t_pyr, j_pyr):
        for a, b in zip(t_lvl, j_lvl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PYR_ATOL, rtol=0)
    # each frame against the one before it, the first against itself
    shift = [0, 0, 1]
    t_prev = [tuple(a[shift] for a in lvl) for lvl in t_pyr]
    j_prev = jax.tree_util.tree_map(lambda a: a[np.array(shift)], j_pyr)
    got = t_correlate(nets["t_model"], t_pyr, t_prev)
    want = j_correlate(nets["params"], nets["batch_stats"], j_pyr, j_prev)
    for k in ("q", "t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PYR_ATOL, rtol=0)

    # within the port: the pairwise eval step on the same pairs
    batch = {"pc1": points, "pc2": points[shift], "T_gt": np.tile(np.eye(4, dtype=np.float32),
                                                                  (3, 1, 1)),
             **TStep.identity_batch_fields(3)}
    pair = TStep.make_eval_step(t_tiny())(nets["t_model"], batch)
    for k in ("q", "t"):
        np.testing.assert_allclose(got[k].numpy(), pair[k].numpy(), atol=1e-6, rtol=0)


def test_runners_match_jax_on_sequence(tree, nets, tmp_path):
    """Both runners over the fake sequence 04 at B=8 (33 full batches and a
    padded one), then the trajectory rows and the metrics.  The JAX
    package's streaming runner runs inside its ``evaluate_sequences``; its
    tests hold it equal to its pairwise runner."""
    t_ds, j_ds = _datasets(tree)
    root, gt_dir = tree
    j_eval = JStep.make_eval_step(nets["j_model"], j_tiny())
    j_stream = JStep.make_streaming_eval_fns(nets["j_model"], j_tiny())
    jp = (nets["params"], nets["batch_stats"])
    want_pair = JR.predict_sequence(j_eval, *jp, j_ds, SEQ, batch_size=8)
    model = nets["t_model"]
    got_pair = TR.predict_sequence(TStep.make_eval_step(t_tiny()), model, t_ds, SEQ,
                                   batch_size=8)
    t_stream = TStep.make_streaming_eval_fns(t_tiny())
    got_stream = TR.predict_sequence_streaming(*t_stream, model, t_ds, SEQ, batch_size=8)
    for got, want in ((got_pair, want_pair), (got_stream, want_pair), (got_stream, got_pair)):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.shape[0] == 271
            np.testing.assert_allclose(g, np.asarray(w), atol=POSE_ATOL, rtol=0)

    log = []
    got = TR.evaluate_sequences(None, model, t_ds, [SEQ], gt_dir=gt_dir,
                                result_dir=str(tmp_path / "t"), batch_size=8, log=log.append,
                                stream_fns=t_stream)
    want = JR.evaluate_sequences(j_eval, *jp, j_ds, [SEQ], gt_dir=gt_dir,
                                 result_dir=str(tmp_path / "j"), batch_size=8, log=lambda m: None,
                                 stream_fns=j_stream)
    assert got.keys() == want.keys() == {SEQ}
    assert np.isfinite(got[SEQ].t_rel) and np.isfinite(got[SEQ].r_rel)
    assert log[-1] == got[SEQ].summary()
    np.testing.assert_allclose(got[SEQ].t_rel, want[SEQ].t_rel, atol=T_REL_ATOL)
    np.testing.assert_allclose(TR.mean_t_rel(got), JR.mean_t_rel(want), atol=T_REL_ATOL)
    for name in ("04_pred.txt", "04_errors.txt"):
        assert (tmp_path / "t" / name).exists()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "04_pred.txt"),
                               np.loadtxt(tmp_path / "j" / "04_pred.txt"), atol=ROWS_ATOL)
    assert np.isnan(TR.mean_t_rel({}))
