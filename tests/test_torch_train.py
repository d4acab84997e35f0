"""Parity of the port's train step with the JAX package, on the CPU.

Tiny config; inputs, permutations and cotangents made with numpy from a
seed and handed to both packages.  JAX runs on the CPU as its own tests run
it (its selects take the XLA path there).  Tolerances:

* numpy-only code (augmentation, synthetic batches, quantization): equal;
* conversions, preprocessing, losses: atol 1e-6 / 1e-5 (float32 products
  in another order, and libm against XLA's atan2/sin/cos);
* layer outputs, batch statistics and gradients: rtol 1e-4, atol 1e-5 on
  outputs and statistics; a gradient within 1e-4 of the larger of its
  tensor's largest entry and 1% of the largest gradient of the module
  (float32 sums in another order, through a backward pass; the floor is
  for tensors whose gradient is zero but for rounding, as the biases of a
  dense layer that feeds a batch norm in training);
* the whole network and two optimizer steps: atol 1e-5 on losses,
  statistics and gradients as above, parameters atol 1e-5.  An Adam step
  moves a parameter by about the learning rate, 1e-3, whatever the size of
  its gradient, so where the gradient is zero but for rounding (below 1e-6
  of the largest) its sign, and the step, may differ: such parameters are
  allowed 4e-3 after two steps.  These are the biases of dense layers that
  feed a batch norm, which the batch mean cancels; they shift that batch
  norm's running means by as much, so after Adam steps the running means of
  those channels are allowed 4e-3 too (every other statistic, and
  everything after momentum SGD steps, stays at the tolerances above).

Neighbour selection is exact on both sides, and both get the same range
images.  The whole network runs in scan order (``stochastic=False``, and
the port's train step with its permutations patched out) and dropout 0 on
both sides (the JAX package's train step always draws both), from one
compiled JAX loss-and-gradient function shared by the file.  Its pose heads
are scaled to predict near-identity motion, as a trained network does on
consecutive scans: random heads predict poses of metres, and the three
warps then re-project points onto crowded pixels whose winners a float32
rounding difference at l1 decides, so that l0 differs by 1e-2 between any
two float orders (two JAX compilations included).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficientlo_net_torch.config import ModelConfig as TModelConfig
from efficientlo_net_torch.config import TrainConfig as TTrainConfig
from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data import augmentation as TA
from efficientlo_net_torch.data import loader as TLoader
from efficientlo_net_torch.data import synthetic as TSyn
from efficientlo_net_torch.models import layers as TL
from efficientlo_net_torch.models import losses as TLoss
from efficientlo_net_torch.models import preprocess as TPre
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_torch.models.pwclo import dropout
from efficientlo_net_torch.ops import quaternion as TQ
from efficientlo_net_torch.pretrained import (load_model, train_state_to_torch,
                                              variables_to_state_dict)
from efficientlo_net_torch.training import state as TState
from efficientlo_net_torch.training import step as TStep
from efficientlo_net_tpu.config import TrainConfig as JTrainConfig
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import augmentation as JA
from efficientlo_net_tpu.data import loader as JLoader
from efficientlo_net_tpu.data import synthetic as JSyn
from efficientlo_net_tpu.models import layers as JL
from efficientlo_net_tpu.models import losses as JLoss
from efficientlo_net_tpu.models import preprocess as JPre
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops import quaternion as JQ
from efficientlo_net_tpu.training import state as JState
from efficientlo_net_tpu.training.step import _forward_inputs as j_forward_inputs
from tests.torch_cases import make_grids
from tests.torch_parity import near_identity_heads, randomize_batch_stats, t, to_torch_module

FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-2
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
ROUNDING_GRAD = 1e-6  # of the largest gradient
ADAM_FLIP_ATOL = 4e-3
ARTIFACT = str(Path(__file__).resolve().parents[1] / "pretrained" / "synthetic_drive_50ep.msgpack")


def assert_grads_close(got, want):
    """Dicts of gradients by name: each agrees to GRAD_REL of the larger of
    its own largest entry and GRAD_FLOOR of the largest of all."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * scale, err_msg=name)


def flat_grads(tree):
    """A Flax gradient (or parameter) tree under the port's state-dict names."""
    return {k: v.numpy() for k, v in
            variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, tree)}).items()}


def flat_stats(tree):
    return {k: v.numpy() for k, v in
            variables_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, tree)}).items()}


def torch_stats(module):
    return {k: v.numpy() for k, v in module.state_dict().items()
            if k.endswith((".mean", ".var"))}


# ---------------------------------------------------------------------------
# Quaternion conversions, data, preprocessing, losses


def _rotations(rng, n=32):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return np.asarray(JQ.quat_to_mat(jnp.asarray(q))), q


@pytest.mark.parametrize("name", ["mat_to_euler_zyx", "euler_zyx_to_quat", "mat_to_quat",
                                  "quat_trans_to_mat4", "transform_points"])
def test_quaternion_conversions_match_jax(name):
    rng = np.random.default_rng(0)
    mats, quats = _rotations(rng)
    trans = rng.standard_normal((32, 3)).astype(np.float32)
    angles = [rng.uniform(-3, 3, 32).astype(np.float32) for _ in range(3)]
    mat4 = np.asarray(JQ.quat_trans_to_mat4(jnp.asarray(quats), jnp.asarray(trans)))
    pts = rng.standard_normal((32, 50, 3)).astype(np.float32) * 20
    args = {"mat_to_euler_zyx": (mats,), "euler_zyx_to_quat": tuple(angles),
            "mat_to_quat": (mats,), "quat_trans_to_mat4": (quats, trans),
            "transform_points": (mat4, pts)}[name]
    want = getattr(JQ, name)(*[jnp.asarray(a) for a in args])
    got = getattr(TQ, name)(*[t(a) for a in args])
    if name != "mat_to_euler_zyx":
        want, got = (want,), (got,)
    atol = 1e-5 if name == "transform_points" else 1e-6  # |points| ~ 20-60
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_augmentation_and_synthetic_batch_match_jax(training):
    sensor = t_tiny().sensor
    np.testing.assert_array_equal(TA.random_se3(np.random.default_rng(1)),
                                  JA.random_se3(np.random.default_rng(1)))
    got = TA.augmentation_batch(np.random.default_rng(2), 5, training)
    want = JA.augmentation_batch(np.random.default_rng(2), 5, training)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = TSyn.synthetic_batch(np.random.default_rng(3), 3, sensor, training=training)
    want = JSyn.synthetic_batch(np.random.default_rng(3), 3, j_tiny().sensor, training=training)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_quantize_points_matches_jax():
    x = np.random.default_rng(4).uniform(-45, 45, (1000, 3)).astype(np.float32)
    assert TLoader.POINT_QUANT_SCALE == JLoader.POINT_QUANT_SCALE
    got, want = TLoader.quantize_points(x), JLoader.quantize_points(x)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_preprocess_and_gt_quat_match_jax():
    sensor = t_tiny().sensor
    batch = TSyn.synthetic_batch(np.random.default_rng(5), 4, sensor, training=True)
    batch["pc1"][:, ::9] *= 2.0  # some points beyond the 35 m crop
    batch["pc2"][:, ::11] = 0.0  # padding
    assert set(batch["aug_frame"].tolist()) == {1, 2}
    keys = ("pc1", "pc2", "T_gt", "T_trans", "T_trans_inv", "aug_frame")
    want = JPre.preprocess(*[jnp.asarray(batch[k]) for k in keys], max_planar_radius=35.0)
    got = TPre.preprocess(*[t(batch[k]) for k in keys], max_planar_radius=35.0)
    for g, w, atol in zip(got, want, (1e-5, 1e-5, 1e-6, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-6)
    # cropped and padding points are exactly zero on both sides
    np.testing.assert_array_equal(got[0].numpy() == 0, np.asarray(want[0]) == 0)
    np.testing.assert_array_equal(got[1].numpy() == 0, np.asarray(want[1]) == 0)
    gq = TPre.gt_quat(*[t(batch[k]) for k in keys[2:]])
    for g, w in zip(gq, got[2:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    q, t_, q_gt, t_gt = (rng.standard_normal((4, 3, n)).astype(np.float32) for n in (4, 3, 4, 3))
    wx, wq = np.float32(0.3), np.float32(-2.1)
    outs = {"q": list(q), "t": list(t_)}

    def j_fn(w_x, w_q):
        return JLoss.total_loss(jax.tree_util.tree_map(jnp.asarray, outs), jnp.asarray(q_gt[0]),
                                jnp.asarray(t_gt[0]), w_x, w_q)

    (j_total, j_metrics), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(wx), jnp.asarray(wq))
    w_x = torch.tensor(wx, requires_grad=True)
    w_q = torch.tensor(wq, requires_grad=True)
    total, metrics = TLoss.total_loss({"q": [t(a) for a in q], "t": [t(a) for a in t_]},
                                      t(q_gt[0]), t(t_gt[0]), w_x, w_q)
    total.backward()
    assert metrics.keys() == j_metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(w_x.grad.item(), float(j_grads[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(w_q.grad.item(), float(j_grads[1]), atol=1e-6, rtol=1e-6)
    assert TLoss.LEVEL_WEIGHTS == JLoss.LEVEL_WEIGHTS
    single = TLoss.level_loss(t(q[1]), t(t_[1]), t(q_gt[0]), t(t_gt[0]), w_x, w_q)
    np.testing.assert_allclose(single.item(), float(j_metrics["l1_loss"]), atol=1e-6)


# ---------------------------------------------------------------------------
# Layers in training mode


def test_batch_norm_training_matches_jax():
    """Output and input/scale/bias gradients of two calls, and the running
    statistics after each: the second EMA update reads the first."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((3, 5, 6)).astype(np.float32) * 2 + 1 for _ in range(2)]
    cot = rng.standard_normal((3, 5, 6)).astype(np.float32)
    bn_j = JL.ScheduledBatchNorm()
    variables = bn_j.init(jax.random.key(0), jnp.asarray(xs[0]), False, 0.99)
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 6), jnp.float32),
              "bias": jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)}
    stats = {"mean": jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 1.5, 6), jnp.float32)}
    bn_t = TL.ScheduledBatchNorm(6).train()
    bn_t.load_state_dict({k: t(v) for k, v in {**params, **stats}.items()})
    assert set(variables["params"]) == set(params) and set(variables["batch_stats"]) == set(stats)

    for x, m in zip(xs, (0.5, 0.9)):
        def f(p, x):
            y, mut = bn_j.apply({"params": p, "batch_stats": stats}, x, True, m,
                                mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (gp, gx), (y, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        xt = t(x).requires_grad_()
        yt = bn_t(xt, torch.tensor(m, dtype=torch.float32))
        (yt * t(cot)).sum().backward()
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **FEAT_TOL)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn_t, k).numpy(), np.asarray(stats[k]), **FEAT_TOL)
        assert_grads_close({"x": xt.grad.numpy(), "scale": bn_t.scale.grad.numpy(),
                            "bias": bn_t.bias.grad.numpy()},
                           {"x": gx, "scale": gp["scale"], "bias": gp["bias"]})
        bn_t.zero_grad()


def _train_layer_pair(j_module, t_module, arrays, static=(), perm=None, momentum=0.8, seed=0):
    """One training-mode call of the Flax layer and of the torch layer with
    the same weights, running statistics, inputs and ``perm``; the loss is
    the output's inner product with a random cotangent.  Compares the
    output, the updated statistics and the gradients of every parameter and
    every input."""
    arrays = [jnp.asarray(a) for a in arrays]
    variables = jax.jit(lambda a: j_module.init(jax.random.key(seed), *a, *static, False, 0.99))(
        arrays)
    variables = randomize_batch_stats(variables, seed=seed + 1)
    jperm = None if perm is None else jnp.asarray(perm)

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    shape = first(j_module.apply(variables, *arrays, *static, False, 0.99, perm=jperm)).shape
    cot = np.random.default_rng(seed + 2).standard_normal(shape).astype(np.float32)

    def f(params, arrays):
        out, mut = j_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  *arrays, *static, True, momentum, perm=jperm,
                                  mutable=["batch_stats"])
        return jnp.sum(first(out) * cot), (first(out), mut["batch_stats"])

    (g_params, g_arrays), (want, want_stats) = jax.jit(
        jax.grad(f, argnums=(0, 1), has_aux=True))(variables["params"], arrays)

    to_torch_module(t_module, variables).train()
    inputs = [t(a).requires_grad_() for a in arrays]
    got = first(t_module(*inputs, *static, perm=None if perm is None else t(perm),
                         bn_momentum=torch.tensor(momentum, dtype=torch.float32)))
    (got * t(cot)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FEAT_TOL)
    got_stats, want_stats = torch_stats(t_module), flat_stats(want_stats)
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], err_msg=k, **FEAT_TOL)
    want_grads = flat_grads(g_params)
    got_grads = {k: p.grad.numpy() for k, p in t_module.named_parameters()}
    for i, (g, w) in enumerate(zip(inputs, g_arrays)):
        want_grads[f"input {i}"], got_grads[f"input {i}"] = np.asarray(w), g.grad.numpy()
    assert_grads_close(got_grads, want_grads)


def test_down_conv_training_matches_jax():
    """Through select + gather (``fused=False``): gradients reach the
    source features and coordinates."""
    rng = np.random.default_rng(8)
    xyz, _ = make_grids(rng, b=2, h1=8, w1=16)
    feats = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), k=8, distance=3.0, mlp=(8, 8, 16), out_hw=(4, 4))
    _train_layer_pair(JL.DownConv(**kw), TL.DownConv(4, **kw), (xyz, feats), static=((2, 4),),
                      perm=rng.permutation(15))


def test_up_conv_training_matches_jax():
    rng = np.random.default_rng(9)
    xyz1, _ = make_grids(rng, b=2, h1=8, w1=16)
    _, xyz2 = make_grids(rng, b=2, h2=4, w2=8)
    feat1 = rng.standard_normal((2, 128, 6)).astype(np.float32)
    feat2 = rng.standard_normal((2, 4, 8, 5)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), nsample=4, distance=6.0, stride_hw=(2, 2),
              mlp=(16, 8), mlp2=(16, 8))
    _train_layer_pair(JL.UpConv(**kw), TL.UpConv(6, 5, **kw), (xyz1, xyz2, feat1, feat2),
                      perm=rng.permutation(15))


def test_cost_volume_training_matches_jax():
    rng = np.random.default_rng(10)
    xyz1, xyz2 = make_grids(rng, b=2, h1=8, w1=16, invalid_frac=0.2)
    f1 = rng.standard_normal((2, 8, 16, 6)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 16, 7)).astype(np.float32)
    kw = dict(kernel_size1=(3, 3), kernel_size2=(3, 5), nsample=4, nsample_q=6,
              distance=2.0, mlp1=(16, 8, 8), mlp2=(16, 8))
    _train_layer_pair(JL.CostVolume(**kw), TL.CostVolume(6, 7, **kw), (xyz1, xyz2, f1, f2),
                      perm=rng.permutation(9))


def test_dropout_keeps_and_scales_like_flax():
    x = torch.rand(4000) + 0.5
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.5, g)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * 2.0)  # kept values scaled by 1 / 0.5
    assert 0.45 < kept.float().mean().item() < 0.55
    y2 = dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y2[y2 != 0], x[y2 != 0] / 0.75)
    assert torch.equal(dropout(x, 0.0, None), x)
    assert torch.equal(dropout(x, 0.5, torch.Generator().manual_seed(0)), y)  # seeded
    with pytest.raises(ValueError):
        dropout(x, 0.5, None)
    head = TNet(t_tiny()).l3_head
    feat = torch.rand(2, 1, head.big.dense.in_features)
    with torch.no_grad():
        eval_out = head.eval()(feat)
        train_out = head.train()(feat, torch.Generator().manual_seed(1))
    assert not torch.equal(eval_out[1], train_out[1])  # dropout only in training
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(head.eval()(feat), eval_out))


def test_init_matches_flax_statistics():
    """Xavier-uniform weights (bound sqrt(6 / (in + out))), zero biases and
    identity batch norm, layer by layer as Flax initializes the network."""
    cfg = j_tiny()
    p = jnp.zeros((1, cfg.sensor.height, cfg.sensor.width, 3))
    variables = jax.jit(JNet(cfg).init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p, p, training=False)
    want = {**flat_grads(variables["params"]), **flat_stats(variables["batch_stats"])}
    torch.manual_seed(0)
    got = {k: v.numpy() for k, v in TNet(t_tiny()).state_dict().items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith(".weight"):
            bound = np.sqrt(6.0 / sum(g.shape))
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, k
            if g.size >= 256:
                np.testing.assert_allclose(g.std(), bound / np.sqrt(3), rtol=0.15, err_msg=k)
                np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.15, err_msg=k)
        else:  # biases, batch-norm scale/bias/mean/var
            np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# The whole network, the optimizer and the train step

TCFG_KW = dict(batch_size=2)


@pytest.fixture(scope="module")
def net():
    """The tiny network with dropout 0 in both packages, one training batch
    (B=2) through both packages' ``_forward_inputs``, and one compiled JAX
    loss-and-gradient function (training, stochastic=False)."""
    j_cfg = dataclasses.replace(j_tiny(), dropout_rate=0.0)
    t_cfg = dataclasses.replace(t_tiny(), dropout_rate=0.0)
    batch = JSyn.synthetic_batch(np.random.default_rng(11), 2, j_cfg.sensor, training=True)
    p1, p2, q_gt, t_gt = j_forward_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                          j_cfg.sensor)
    model = JNet(j_cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p1, p2, training=False)
    variables = randomize_batch_stats(variables)

    def loss_fn(params, batch_stats, bn_momentum):
        out, mutated = model.apply({"params": params["model"], "batch_stats": batch_stats},
                                   p1, p2, training=True, bn_momentum=bn_momentum,
                                   stochastic=False, mutable=["batch_stats"])
        loss, metrics = JLoss.total_loss(out, q_gt, t_gt, params["w_x"], params["w_q"])
        return loss, (mutated["batch_stats"], metrics)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    params = {"model": near_identity_heads(variables["params"]), "w_x": jnp.float32(0.1),
              "w_q": jnp.float32(-2.4)}
    return dict(j_cfg=j_cfg, t_cfg=t_cfg, batch=batch, inputs=(p1, p2, q_gt, t_gt),
                params=params, batch_stats=variables["batch_stats"], grad_fn=grad_fn)


def _torch_state(net, optimizer="adam"):
    """The port's train state with the fixture's weights, through the
    train-state bridge."""
    host = jax.tree_util.tree_map(np.asarray, (net["params"], net["batch_stats"]))
    state_dict, w_x, w_q = train_state_to_torch(*host)
    model = TNet(net["t_cfg"])
    model.load_state_dict(state_dict, strict=True)
    cfg = TTrainConfig(optimizer=optimizer, **TCFG_KW)
    return TState.create_train_state(model, cfg, device="cpu", w_x=w_x, w_q=w_q)


def test_forward_inputs_match_jax(net):
    for quantize in (False, True):
        batch = dict(net["batch"])
        if quantize:
            batch.update(pc1=TLoader.quantize_points(batch["pc1"]),
                         pc2=TLoader.quantize_points(batch["pc2"]))
        want = j_forward_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                net["j_cfg"].sensor)
        got = TStep._forward_inputs(batch, net["t_cfg"].sensor, "cpu")
        # the same range images (checked exactly; the parity tests below rely
        # on it), and the same ground truth
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-6)


def test_network_training_loss_grads_and_stats_match_jax(net):
    grads, (new_stats, metrics) = net["grad_fn"](net["params"], net["batch_stats"],
                                                 jnp.float32(0.5))
    state = _torch_state(net)
    p1, p2, q_gt, t_gt = (t(a) for a in net["inputs"])
    out = state.model(p1, p2, bn_momentum=torch.tensor(0.5), stochastic=False)
    loss, got_metrics = TLoss.total_loss(out, q_gt, t_gt, state.w_x, state.w_q)
    loss.backward()
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k].item(), float(metrics[k]), atol=LOSS_ATOL,
                                   rtol=1e-5, err_msg=k)
    want_grads = {**flat_grads(grads["model"]), "w_x": grads["w_x"], "w_q": grads["w_q"]}
    got_grads = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    got_grads.update(w_x=state.w_x.grad.numpy(), w_q=state.w_q.grad.numpy())
    assert_grads_close(got_grads, want_grads)
    got_stats, want_stats = torch_stats(state.model), flat_stats(new_stats)
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], err_msg=k, **FEAT_TOL)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_two_optimizer_steps_match_optax(net, optimizer, monkeypatch):
    """Two updates on the fixture's batch: optax (through the JAX package's
    ``make_optimizer``) on one side, the port's ``make_train_step`` on the
    other; then the parameters, loss weights and running statistics."""
    j_tcfg = JTrainConfig(optimizer=optimizer, **TCFG_KW)
    tx = JState.make_optimizer(j_tcfg)
    params, stats = net["params"], net["batch_stats"]
    opt_state = tx.init(params)
    j_losses, j_grads = [], []
    for step in range(2):
        bn_m = JState.bn_momentum_schedule(j_tcfg)(jnp.int32(step))
        grads, (stats, metrics) = net["grad_fn"](params, stats, bn_m)
        j_grads.append(flat_grads(grads["model"]))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(metrics["loss"]))

    state = _torch_state(net, optimizer)
    # the port's train step in scan order, as the fixture's JAX function
    monkeypatch.setattr(TNet, "_perm", staticmethod(lambda kernel_size, stochastic, gen: None))
    train_step = TStep.make_train_step(net["t_cfg"], TTrainConfig(optimizer=optimizer, **TCFG_KW))
    t_losses = []
    for _ in range(2):
        state, m = train_step(state, net["batch"], torch.Generator())
        t_losses.append(m["loss"].item())
    assert state.step == 2
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_ATOL, rtol=1e-5)

    want = flat_grads(params["model"])
    got = {k: p.detach().numpy() for k, p in state.model.named_parameters()}
    top = max(np.abs(g).max() for grads in j_grads for g in grads.values())
    rounding = {k: np.minimum(*(np.abs(g[k]) for g in j_grads)) < ROUNDING_GRAD * top
                for k in want}
    for k in want:
        atol = np.full(want[k].shape, PARAM_ATOL)
        if optimizer == "adam":  # see the module docstring
            atol[rounding[k]] = ADAM_FLIP_ATOL
        assert np.all(np.abs(got[k] - want[k]) <= atol), k
    for name in ("w_x", "w_q"):
        np.testing.assert_allclose(getattr(state, name).item(), float(params[name]),
                                   atol=PARAM_ATOL)
    got_stats, want_stats = torch_stats(state.model), flat_stats(stats)
    for k in want_stats:
        tol = np.abs(want_stats[k]) * FEAT_TOL["rtol"] + FEAT_TOL["atol"]
        if optimizer == "adam" and k.endswith(".mean"):
            # the channels whose preceding dense bias had a rounding-level
            # gradient (bn_i follows dense_i in every ConvMLP)
            layer, bn = k[:-len(".mean")].rsplit(".", 1)
            bias = f"{layer}.dense_{bn.removeprefix('bn_')}.bias"
            tol = np.where(rounding[bias], ADAM_FLIP_ATOL, tol)
        assert np.all(np.abs(got_stats[k] - want_stats[k]) <= tol), k


def test_lr_and_bn_schedules():
    """The values of the JAX package's schedule test."""
    cfg = TTrainConfig(**TCFG_KW)
    lr = TState.lr_schedule(cfg)
    np.testing.assert_allclose(lr(0), 1e-3, rtol=1e-6)
    np.testing.assert_allclose(lr(100000), 1e-3 * 0.7, rtol=1e-6)
    np.testing.assert_allclose(lr(10**9), 1e-5, rtol=1e-6)  # floor
    bn = TState.bn_momentum_schedule(cfg)
    np.testing.assert_allclose(bn(0), 0.5, rtol=1e-6)
    np.testing.assert_allclose(bn(10**9), 0.99, rtol=1e-6)
    j_lr = JState.lr_schedule(JTrainConfig(**TCFG_KW))
    j_bn = JState.bn_momentum_schedule(JTrainConfig(**TCFG_KW))
    for step in (0, 1, 99999, 100000, 250000, 10**6):
        np.testing.assert_allclose(lr(step), float(j_lr(jnp.int32(step))), rtol=1e-6)
        np.testing.assert_allclose(bn(step), float(j_bn(jnp.int32(step))), rtol=1e-6)


def _train_losses(batch, seed, steps=3, model_cfg=None):
    """The port's ``make_train_step`` (stochastic scan order, dropout as
    configured) from a default initialization."""
    model_cfg = model_cfg or t_tiny()
    torch.manual_seed(seed)
    cfg = TTrainConfig(**TCFG_KW)
    state = TState.create_train_state(TNet(model_cfg), cfg, device="cpu")
    step = TStep.make_train_step(model_cfg, cfg)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        losses.append(m["loss"].item())
    return losses, state


def test_train_step_reduces_loss_and_is_deterministic():
    """As the JAX package's test, three steps on one batch make progress,
    here with dropout 0 (at 0.5, a random network's pose heads swing the
    loss of one step by ±30%, more than three steps move it; the scan
    permutations stay random).  With dropout 0.5 the same seeds give the
    same run, bit for bit."""
    batch = TSyn.synthetic_batch(np.random.default_rng(0), 2, t_tiny().sensor, training=True)
    no_dropout = dataclasses.replace(t_tiny(), dropout_rate=0.0)
    losses, state = _train_losses(batch, seed=0, model_cfg=no_dropout)
    assert all(np.isfinite(losses)) and state.step == 3
    assert losses[-1] < losses[0]
    losses, state = _train_losses(batch, seed=0)
    assert all(np.isfinite(losses)) and state.step == 3
    again, state2 = _train_losses(batch, seed=0)
    assert again == losses
    for a, b in zip(state.parameters(), state2.parameters()):
        assert torch.equal(a, b)
    for (k, a), b in zip(state.model.state_dict().items(), state2.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_quantized_transfer_matches_float():
    """int16 clouds give the float loss to within 5%, as in the JAX
    package's test."""
    host = TSyn.synthetic_batch(np.random.default_rng(2), 2, t_tiny().sensor, training=True)
    batch_q = dict(host, pc1=TLoader.quantize_points(host["pc1"]),
                   pc2=TLoader.quantize_points(host["pc2"]))
    np.testing.assert_allclose(batch_q["pc1"].astype(np.float32) / 800.0, host["pc1"],
                               atol=6.5e-4)
    assert batch_q["pc1"].dtype == np.int16
    lf, _ = _train_losses(host, seed=5, steps=1)
    lq, _ = _train_losses(batch_q, seed=5, steps=1)
    assert np.isfinite(lq[0])
    assert abs(lf[0] - lq[0]) < 0.05 * max(1.0, abs(lf[0]))


def test_eval_step_and_identity_fields():
    cfg = t_tiny()
    rng = np.random.default_rng(3)
    batch = TSyn.synthetic_batch(rng, 2, cfg.sensor, training=False)
    fields = TStep.identity_batch_fields(2)
    for k, v in fields.items():
        np.testing.assert_array_equal(v, batch[k])
    torch.manual_seed(0)
    model = TNet(cfg)
    out = TStep.make_eval_step(cfg)(model, batch)
    assert not model.training
    p1, p2, q_gt, t_gt = TStep._forward_inputs(batch, cfg.sensor, "cpu")
    with torch.no_grad():
        ref = model(p1, p2)
    assert torch.equal(out["q"], ref["q"][0]) and torch.equal(out["t"], ref["t"][0])
    assert out["q"].shape == (2, 4) and out["t"].shape == (2, 3)
    j_q, j_t = JPre.gt_quat(*[jnp.asarray(batch[k]) for k in
                              ("T_gt", "T_trans", "T_trans_inv", "aug_frame")])
    np.testing.assert_allclose(out["q_gt"].numpy(), np.asarray(j_q), atol=1e-6)
    np.testing.assert_allclose(out["t_gt"].numpy(), np.asarray(j_t), atol=1e-6)


def test_artifact_warm_starts_training():
    """``load_model`` + ``create_train_state`` from the 50-epoch artifact,
    which carries no loss weights: they start at the config's values."""
    cfg = TTrainConfig()
    model, _ = load_model(ARTIFACT, TModelConfig(), device="cpu")
    state = TState.create_train_state(model, cfg, device="cpu")
    assert state.model.training and state.step == 0
    assert state.w_x.item() == cfg.w_x_init and state.w_q.item() == cfg.w_q_init
    assert len(state.optimizer.param_groups[0]["params"]) == len(list(model.parameters())) + 2
