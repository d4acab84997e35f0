"""Parity of the port's parallelism with the JAX package, on the CPU.

The port runs in gloo groups of spawned rank processes (``torch_parallel_cases``:
one job of 6 ranks, one of 2, both started by the module fixture and run
while this process computes the JAX references); the JAX package on the
conftest's 8 virtual CPU devices.  Inputs come from numpy seeds, or are made
here once and handed to both.  Tolerances:

* window offsets, the block selects and the ring selects (idx and mask):
  exact, as ``tests/test_ring.py`` holds the JAX ring to the unsharded op;
  grouped values atol 1e-6 (``test_ring.py``'s);
* the ring eval forward against JAX's ``ring_mesh`` forward: q atol 1e-5,
  t atol 1e-4 at l0..l3 (``test_ring.py``'s), and equal to the port's
  unsharded forward;
* the data-parallel step against JAX's loss and gradient under the sharding
  of its ``make_sharded_train_step`` (batch split over a 2-device data mesh;
  in scan order with dropout 0, since JAX's step draws its permutations
  from its own key), on six batch seeds: ``test_torch_train.py``'s
  tolerances on losses, gradients and batch statistics; against the port's
  single-process step at B=4 with dropout and permutations from one seed,
  alone and inside ``Trainer(use_mesh=True)``: loss within 1e-6 relative,
  gradients within 1e-5 of their scale (sums of other shards in another
  order), statistics rtol 1e-5;
* the distributed solve: within 1e-4 of JAX's ``optimize(mesh=)`` and of
  the port's single solve (``tests/test_multiprocess.py``'s bound), and a
  SLAM drive with its solves over the group within 1e-4 of the drive
  without.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_cases as cases
from efficientlo_net_torch.ops import neighbors as TN
from efficientlo_net_torch.parallel import ring as TR
from efficientlo_net_torch.pretrained import train_state_to_torch, variables_to_state_dict
from efficientlo_net_tpu.backend import pose_graph as JPG
from efficientlo_net_tpu.backend import scan_factors as JSF
from efficientlo_net_tpu.config import TrainConfig as JTrainConfig
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import synthetic as JSyn
from efficientlo_net_tpu.data.synthetic import random_scene
from efficientlo_net_tpu.models import losses as JLoss
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops import neighbors as JN
from efficientlo_net_tpu.ops import se3 as JSE3
from efficientlo_net_tpu.ops.projection import project_to_range_image
from efficientlo_net_tpu.parallel import mesh as JMesh
from efficientlo_net_tpu.parallel import ring as JR
from efficientlo_net_tpu.training import state as JState
from efficientlo_net_tpu.training.step import _forward_inputs as j_forward_inputs
from tests.test_model import synthetic_scan
from tests.test_ring import ring_mesh
from tests.test_torch_train import (FEAT_TOL, LOSS_ATOL, assert_grads_close, flat_grads,
                                    flat_stats)
from tests.torch_cases import build_fake_kitti
from tests.torch_parity import near_identity_heads, randomize_batch_stats

GROUPED_ATOL = 1e-6
Q_ATOL, T_ATOL = 1e-5, 1e-4
DP_LOSS_RTOL = 1e-6
DP_GRAD_REL = 1e-5
DP_STATS = dict(rtol=1e-5, atol=1e-6)
SOLVE_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_tiny():
    """The tiny JAX network, its initialized variables with random running
    statistics, and two B=1 range images projected by the JAX package."""
    cfg = j_tiny()
    rng = np.random.default_rng(0)
    h, w = cfg.sensor.height, cfg.sensor.width
    p1, p2 = (project_to_range_image(jnp.asarray(synthetic_scan(rng, cfg.sensor.num_points)[None]),
                                     None, h, w, cfg.sensor)[0] for _ in range(2))
    model = JNet(cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p1, p2, training=False)
    return cfg, model, randomize_batch_stats(variables), np.asarray(p1), np.asarray(p2)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_tiny):
    """Writes what the rank jobs read, then starts them."""
    out = tmp_path_factory.mktemp("parallel")
    cfg, _, variables, p1, p2 = jax_tiny
    torch.save(variables_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)),
               out / "forward_weights.pt")
    np.save(out / "forward_p1.npy", p1)
    np.save(out / "forward_p2.npy", p2)
    write_train_weights(out, variables)
    gt, *_, noise, _, _ = cases.circle_graph()
    np.save(out / "circle_poses0.npy", np.asarray(
        jnp.asarray(gt.astype(np.float32)) @ JSE3.se3_exp(jnp.asarray(noise))))
    scene = random_scene(np.random.default_rng(0), 4096, cfg.sensor)
    build_fake_kitti(out / "kitti", scene, cfg.sensor.num_points)
    runs = cases.Spawned(out, {"ring": 6, "dp": 2})
    yield runs
    runs.close()


def write_train_weights(out, variables):
    """``out``/train_weights.pt, which the rank jobs' train steps read: the
    variables with near-identity pose heads (``_jax_grad_fns``'s), w_x 0.1
    and w_q -2.4, through the train-state bridge."""
    host = jax.tree_util.tree_map(np.asarray, variables)
    state_dict, w_x, w_q = train_state_to_torch(
        {"model": near_identity_heads(host["params"]), "w_x": np.float32(0.1),
         "w_q": np.float32(-2.4)}, host["batch_stats"])
    torch.save({"state_dict": state_dict, "w_x": w_x, "w_q": w_q}, out / "train_weights.pt")


def _j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------------------
# (a) window offsets, (b) the plain block select, (d) the guards


@pytest.mark.parametrize("kernel", [(3, 5), (9, 15), (11, 41), (1, 1), (4, 6)])
def test_window_offsets_match_jax(kernel):
    np.testing.assert_array_equal(TN.window_offsets(*kernel), JN.window_offsets(*kernel))


@pytest.mark.parametrize("name", list(cases.GEOMETRIES))
def test_select_on_block_matches_jax_at_every_ring_index(name):
    """The plain block select on the widened block each rank of the ring
    gets: global and block-local indices and masks exactly JAX's."""
    (h1, w1), (h2, w2), kernel, k, dist, cs, ss, mode, ring_size = cases.GEOMETRIES[name]
    g1, g2, perm = cases.ring_inputs(name)
    halo = kernel[1] // 2
    kw = dict(kernel_size=kernel, k=k, distance=dist, center_stride=cs, source_stride=ss,
              halo=halo, w1=w1, w2=w2, h2=h2, mode=mode)
    w1_loc = w1 // ring_size
    j_select = jax.jit(functools.partial(JR._select_on_block, **kw))
    for r in range(ring_size):
        blk = g1[:, :, r * w1_loc:(r + 1) * w1_loc]
        wide = cases.widened_block(g2, r, ring_size, halo)
        want = j_select(jnp.asarray(blk), jnp.asarray(wide), r, perm=_j(perm))
        got = TR._select_on_block(torch.from_numpy(blk), torch.from_numpy(wide), r,
                                  perm=None if perm is None else torch.from_numpy(perm), **kw)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("args", [
    (10, 10, 10, 1, 1, 3, 4),     # 4 does not divide W = 10
    (12, 12, 12, 1, 1, 11, 4),    # halo 5 > the 3-column sector
    (12, 8, 12, 1, 2, 3, 4),      # source stride 2 does not map 12 onto 8
    (12, 12, 6, 2, 1, 3, 4),      # 4 does not divide the 6 centres
    (12, 12, 4, 2, 1, 3, 4),      # stride 2 with 4 centres does not tile 12
])
def test_ring_guards_match_jax(args):
    """``_validate``'s ValueErrors, with JAX's messages (test_ring_guards)."""
    with pytest.raises(ValueError) as want:
        JR._validate(*args)
    with pytest.raises(ValueError) as got:
        TR._validate(*args)
    assert str(got.value) == str(want.value)


def test_ring_of_one_wraps_the_block_onto_itself():
    """Without a process group the ring has one rank: the halo is the
    block's own wrap and the ring select is the unsharded select."""
    g1, g2, perm = cases.ring_inputs("seam")
    x = torch.from_numpy(g2)
    wide = TR.halo_exchange_w(x, 3, None)
    np.testing.assert_array_equal(wide.numpy(), cases.widened_block(g2, 0, 1, 3))
    idx, mask = TR.ring_select_neighbors(torch.from_numpy(g1), x, (3, 7), 5, 1000.0, mesh=None,
                                         mode=TN.KNN)
    want_idx, want_mask = TN.select_neighbors_plain(torch.from_numpy(g1), x, (3, 7), 5, 1000.0,
                                                    mode=TN.KNN)
    assert torch.equal(idx.reshape(want_idx.shape), want_idx)
    assert torch.equal(mask.reshape(want_mask.shape), want_mask)


# ---------------------------------------------------------------------------
# (c) the ring selects across gloo ranks, (e) the ring forward


@pytest.mark.parametrize("name", list(cases.GEOMETRIES))
def test_ring_select_across_ranks_matches_jax(spawned, name):
    """Gathered from a (2, 3) mesh, a ring of 4 or of 5 gloo ranks: idx and
    mask bit-identical to JAX's ring select on ``ring_mesh(2, ring)``."""
    _, _, kernel, k, dist, cs, ss, mode, ring_size = cases.GEOMETRIES[name]
    g1, g2, perm = cases.ring_inputs(name)
    want_idx, want_mask = jax.jit(functools.partial(
        JR.ring_select_neighbors, kernel_size=kernel, k=k, distance=dist,
        mesh=ring_mesh(2, ring_size), center_stride=cs, source_stride=ss, mode=mode))(
        jnp.asarray(g1), jnp.asarray(g2), perm=_j(perm))
    got_idx, got_mask = spawned.result("ring")[name]
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    np.testing.assert_array_equal(got_idx, np.asarray(want_idx))
    if name == "seam":
        assert got_mask.sum() > 0


def test_ring_select_and_group_across_ranks_matches_jax(spawned):
    xyz, feats, perm = cases.group_inputs()
    c = cases.GROUP_CASE
    want = jax.jit(functools.partial(
        JR.ring_select_and_group, kernel_size=c["kernel"], k=c["k"], distance=c["distance"],
        mesh=ring_mesh(2, c["ring"]), center_stride=c["stride"], mode=JN.FIRST_K))(
        jnp.asarray(xyz), jnp.asarray(feats), perm=jnp.asarray(perm))
    got = spawned.result("ring")["select_and_group"]
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), atol=GROUPED_ATOL)


def test_ring_forward_matches_jax_ring_mesh(spawned, jax_tiny):
    """The tiny network's eval forward with its level-0 select on a ring of
    4 gloo ranks: JAX's forward with ``ring_mesh(2, 4)`` at every level, and
    the port's own unsharded forward exactly."""
    _, model, variables, p1, p2 = jax_tiny
    want = jax.jit(lambda v, a, b: model.apply(v, a, b, training=False,
                                               ring_mesh=ring_mesh(2, 4)))(variables, p1, p2)
    got = spawned.result("ring")["forward"]
    for lvl in range(4):
        ring_q, plain_q = got["q"][0][lvl], got["q"][1][lvl]
        ring_t, plain_t = got["t"][0][lvl], got["t"][1][lvl]
        np.testing.assert_allclose(ring_q, np.asarray(want["q"][lvl]), atol=Q_ATOL)
        np.testing.assert_allclose(ring_t, np.asarray(want["t"][lvl]), atol=T_ATOL)
        np.testing.assert_array_equal(ring_q, plain_q)
        np.testing.assert_array_equal(ring_t, plain_t)


# ---------------------------------------------------------------------------
# (f, g) the data-parallel step, (h) checkpoints, (j) the CLI


def _jax_grad_fns(jax_tiny, ring=None):
    """JAX's gradient, with its aux (new statistics, metrics), of the tiny
    network's loss in scan order with dropout 0: under the shardings of
    ``make_sharded_train_step`` (state replicated, the B=4 batch split over a
    2-device data mesh), and unsharded; with ``ring``, a ``ring_mesh``, both
    run the level-0 select on that ring.  And a function of a numpy seed
    that calls one on that seed's batch."""
    cfg, _, variables, _, _ = jax_tiny
    cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    model = JNet(cfg)
    params = {"model": near_identity_heads(variables["params"]), "w_x": jnp.float32(0.1),
              "w_q": jnp.float32(-2.4)}

    def loss_fn(params, batch_stats, inputs, bn_momentum):
        p1, p2, q_gt, t_gt = inputs
        out, mutated = model.apply({"params": params["model"], "batch_stats": batch_stats},
                                   p1, p2, training=True, bn_momentum=bn_momentum,
                                   stochastic=False, mutable=["batch_stats"], ring_mesh=ring)
        loss, metrics = JLoss.total_loss(out, q_gt, t_gt, params["w_x"], params["w_q"])
        return loss, (mutated["batch_stats"], metrics)

    mesh = JMesh.make_mesh(jax.devices()[:2])
    rep, bshard = JMesh.replicated(mesh), JMesh.batch_sharding(mesh)
    sharded = jax.jit(jax.grad(loss_fn, has_aux=True), in_shardings=(rep, rep, bshard, rep))
    unsharded = jax.jit(jax.grad(loss_fn, has_aux=True))
    momentum = JState.bn_momentum_schedule(JTrainConfig(batch_size=4))(jnp.int32(0))

    def on_seed(grad_fn, seed):
        batch = JSyn.synthetic_batch(np.random.default_rng(seed), 4, cfg.sensor, training=True)
        inputs = j_forward_inputs({k: jnp.asarray(v) for k, v in batch.items()}, cfg.sensor)
        return grad_fn(params, variables["batch_stats"], inputs, momentum)

    return sharded, unsharded, on_seed


def _flat(grads):
    return {**flat_grads(grads["model"]), "w_x": grads["w_x"], "w_q": grads["w_q"]}


def test_data_parallel_step_matches_jax_sharded_step(spawned, jax_tiny):
    """On each seed of ``DP_JAX_SEEDS``, both ranks' step against JAX's
    sharded step.  Asserted first, on each: JAX's own sharded and unsharded
    gradients, and the port's single-process step and JAX's unsharded
    one, agree to ``GRAD_REL`` (the seeds left out, and why, are named
    with ``DP_JAX_SEEDS``)."""
    sharded, unsharded, on_seed = _jax_grad_fns(jax_tiny)
    for seed in cases.DP_JAX_SEEDS:
        grads, (stats, metrics) = on_seed(sharded, seed)
        alone = _flat(on_seed(unsharded, seed)[0])
        assert_grads_close(_flat(grads), alone)
        assert_grads_close(spawned.result("dp")["dp_vs_jax"][seed]["single"]["grads"], alone)
        for rank in (0, 1):
            got = spawned.result("dp", rank)["dp_vs_jax"][seed]["dp"]
            for k in metrics:
                np.testing.assert_allclose(got["metrics"][k], float(metrics[k]), atol=LOSS_ATOL,
                                           rtol=1e-5, err_msg=f"seed {seed} {k}")
            assert_grads_close(got["grads"], _flat(grads))
            want_stats = flat_stats(stats)
            assert got["stats"].keys() == want_stats.keys()
            for k in want_stats:
                np.testing.assert_allclose(got["stats"][k], want_stats[k],
                                           err_msg=f"seed {seed} {k}", **FEAT_TOL)


def _assert_matches_single_step(got, single):
    """A data-parallel step's loss, gradients and statistics against the
    single-process step's: loss within DP_LOSS_RTOL, gradients within
    DP_GRAD_REL of their scale, statistics DP_STATS."""
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=DP_LOSS_RTOL, err_msg=k)
    top = max(float(np.abs(g).max()) for g in single["grads"].values())
    for k, g in single["grads"].items():
        scale = max(float(np.abs(g).max()), 1e-2 * top)
        np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=DP_GRAD_REL * scale,
                                   err_msg=k)
    for k, v in single["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, err_msg=k, **DP_STATS)


def test_data_parallel_step_matches_single_process_step(spawned):
    """Dropout and scan permutations from one seed on both ranks: the two
    ranks' step is the single-process step on the whole batch, and both
    ranks end with bit-equal parameters (rank 1 started perturbed:
    ``replicate_state`` restored rank 0's state)."""
    dp = [spawned.result("dp", r)["dp_vs_single"] for r in (0, 1)]
    np.testing.assert_array_equal(dp[0]["dp"]["params"], dp[1]["dp"]["params"])
    _assert_matches_single_step(dp[0]["dp"], dp[0]["single"])


def test_data_parallel_trainer_matches_single_trainer(spawned):
    """``Trainer(use_mesh=True)`` on two ranks, one step through its loader:
    each rank was given its rows of the batch the single-process trainer
    loaded, with the same generator seed, and its step is, bit for bit,
    ``make_sharded_train_step`` on those rows (held to the single step and
    to JAX above), as the single trainer's is ``make_train_step`` on the
    whole batch; parameters bit-equal across the ranks.  Then every rank's
    ``restore()`` of the data-parallel checkpoint (rank 1's state perturbed
    first) gives the saved state and resumes at epoch 1.  The two trainers'
    gradients are not compared at DP_GRAD_REL: on this KITTI-like batch the
    tiny network's warps are chaotic, and JAX's own sharded and unsharded
    gradients differ by 0.64 of scale there."""
    dp = [spawned.result("dp", r)["trainer"] for r in (0, 1)]
    np.testing.assert_array_equal(dp[0]["dp"]["params"], dp[1]["dp"]["params"])
    for got in dp:
        assert got["mesh"] and got["rows_equal"]
        assert got["seeds"][0] == got["seeds"][1]
        for mine, alone in ((got["dp"], got["dp_step"]), (got["single"], got["single_step"])):
            np.testing.assert_array_equal(mine["params"], alone["params"])
            for k, g in alone["grads"].items():
                np.testing.assert_array_equal(mine["grads"][k], g, err_msg=k)
            np.testing.assert_allclose(mine["metrics"]["loss"], alone["metrics"]["loss"],
                                       rtol=1e-6)
        assert got["saved_step"] == 1
        assert got["restored"]["step"] == 1 and got["restored"]["start_epoch"] == 1
        np.testing.assert_array_equal(got["restored"]["params"], dp[0]["dp"]["params"])


def test_sliding_window_slam_over_a_group_matches_the_single_drive(spawned):
    """``SlidingWindowSLAM(group=)`` on two ranks: its window solves and its
    global pass, whose odd factor count the group pads, give the drive
    without a group within SOLVE_ATOL, the same on both ranks."""
    got = [spawned.result("dp", r)["slam"] for r in (0, 1)]
    single = got[0]["single"]
    assert got[0]["group"]["global_factors"] % 2 == 1
    assert got[0]["group"]["closures"] == single["closures"] >= 1
    for which in ("window", "global"):
        np.testing.assert_array_equal(got[0]["group"][which], got[1]["group"][which])
        np.testing.assert_allclose(got[0]["group"][which], single[which], atol=SOLVE_ATOL,
                                   err_msg=which)


def test_checkpoints_across_processes(spawned):
    """tests/test_multiprocess.py's CHILD on the port: rank 0 alone writes,
    every rank restores the step, its metadata and the best marking."""
    for rank in (0, 1):
        got = spawned.result("dp", rank)["checkpoint"]
        assert got["step"] == 7 and got["w"] == 1.5 and got["w_q"] == -2.5
        assert got["meta"] == {"epoch": 4, "val_t_rel": 2.5}
        assert got["first_best"] and got["best"] == 2.0 and not got["second_best"]
    ckpt = os.path.join(spawned.out_dir, "ckpt")
    with open(os.path.join(ckpt, "best.json")) as f:
        assert f.read() == '{"val_t_rel": 2.0, "step": 7}'
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("meta_")) == ["meta_7.json"]
    assert sorted(os.listdir(os.path.join(ckpt, "best"))) == ["ckpt_7.pt"]


def test_sequences_and_metric_shard_by_host(spawned):
    assert [spawned.result("dp", r)["sequences"] for r in (0, 1)] == [[7, 9], [8, 10]]
    for rank in (0, 1):
        assert spawned.result("dp", rank)["mean_t_rel"] == pytest.approx(3.0, abs=1e-12)


def test_cli_coordinator_joins_the_group_in_test_mode(spawned):
    """``cli.main --coordinator`` in test mode on two gloo ranks: it joins
    the group, the trainer replicates its state, one log directory for
    both, and each rank scores the sequence."""
    for rank in (0, 1):
        assert spawned.result("dp", rank)["world"] == 2
        assert os.path.exists(os.path.join(spawned.out_dir, f"cli_result{rank}", "04_pred.txt"))
    logs = [d for d in os.listdir(spawned.out_dir) if d.startswith("cli_log")]
    assert len(logs) == 1
    assert {"log_train.txt", "log_train_rank1.txt", "config.json"} <= set(
        os.listdir(os.path.join(spawned.out_dir, logs[0])))


# ---------------------------------------------------------------------------
# (i) the distributed pose-graph solve


def test_distributed_optimize_matches_jax_mesh_solve(spawned):
    gt, src, dst, meas, _, pairs, (p, q, nrm) = cases.circle_graph()
    poses0 = jnp.asarray(np.load(os.path.join(spawned.out_dir, "circle_poses0.npy")))
    factors = JPG.make_factors(src, dst, meas, num_nodes=12, capacity=16)
    scan = JSF.make_scan_factors(pairs, [
        JSF.Correspondences(p_j=jnp.asarray(p[i]), q_i=jnp.asarray(q[i]), n_i=jnp.asarray(nrm[i]),
                            w=jnp.ones((64,), jnp.float32)) for i in range(len(pairs))])
    mesh = Mesh(np.array(jax.devices()[:4]), ("factors",))
    want, want_hist = JPG.optimize(poses0, factors, JPG.GaussNewtonConfig(iterations=12),
                                   mesh=mesh, scan_factors=scan)
    for rank in range(4):
        got = spawned.result("ring", rank)["optimize"]
        np.testing.assert_allclose(got["opt"], np.asarray(want), atol=SOLVE_ATOL)
        np.testing.assert_allclose(got["opt"], got["single"], atol=SOLVE_ATOL)
        np.testing.assert_allclose(got["hist"][-1], float(want_hist[-1]), rtol=1e-3, atol=1e-6)
    ranks = [spawned.result("ring", r)["optimize"]["opt"] for r in range(4)]
    assert all(np.array_equal(ranks[0], r) for r in ranks[1:])  # replicated result
    rel = np.linalg.inv(ranks[0][0].astype(np.float64)) @ ranks[0][5].astype(np.float64)
    gt_rel = np.linalg.inv(gt[0]) @ gt[5]
    assert np.linalg.norm(rel[:3, 3] - gt_rel[:3, 3]) < 0.05
