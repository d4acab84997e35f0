"""The port's bfloat16 compute path (``ModelConfig.compute_dtype``) against
the JAX package's, on the CPU.

Tiny config, random Flax init with randomized batch-norm statistics, carried
across by the weight bridge; both packages get the same inputs, made with
numpy from a seed.  Parameters stay float32 on both sides: the bfloat16
network loads the float32 weights.

* Each layer: the output dtype is JAX's exactly (bf16 out of ``ConvMLP``,
  ``UpConv`` and ``FlowPredictor``; float32 out of ``DownConv``, whose mask
  product promotes, of ``CostVolume``, whose softmaxes run in float32, and
  out of batch norm for a float32 input).  Values within 2 bf16 ulps of the
  output's largest magnitude (2 * 2^-7 of it): both sides round at the same
  places, so most outputs agree bit for bit; where a float32 sum taken in
  another order rounds to the neighbouring bf16 value, the difference
  stays below that (0.08 ulp of scale in the cost volume, 0 elsewhere, when
  this was written).
* The whole network, eval mode, near-identity pose heads (as in
  tests/test_torch_model.py): the port's bf16 l0..l3 poses lie closer to
  JAX's bf16 poses than JAX's bf16 poses lie to JAX's float32 ones.  When
  this was written: port bf16 to JAX bf16 at most 1.1e-6 (t, l0), JAX bf16
  to JAX float32 at least 4.6e-5 (t, l3) and up to 1.7e-4 (q, l0).
* One bf16 training forward and backward: the losses within rtol 2e-3 (half
  a bf16 ulp, 2^-8 relative: batch statistics of bf16 activations; 6.0e-4
  at most when this was written) and every gradient float32.
* The features that reach ``select_and_group`` are float32 at every call of
  both packages' bf16 forward, so both CUDA kernels keep their float32
  contract.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import TrainConfig as TTrainConfig
from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.models import layers as TL
from efficientlo_net_torch.models import losses as TLoss
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_torch.ops import neighbors as TN
from efficientlo_net_torch.pretrained import train_state_to_torch
from efficientlo_net_torch.training import state as TState
from efficientlo_net_torch.training import step as TStep
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import synthetic as JSyn
from efficientlo_net_tpu.models import layers as JL
from efficientlo_net_tpu.models import losses as JLoss
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops import neighbors as JN
from efficientlo_net_tpu.ops.projection import project_to_range_image
from efficientlo_net_tpu.training.step import _forward_inputs as j_forward_inputs
from tests.test_model import synthetic_scan
from tests.torch_cases import make_grids
from tests.torch_parity import near_identity_heads, randomize_batch_stats, t, to_torch_module

ULPS = 2
BF16_EPS = 2.0 ** -7  # spacing of bf16 values in [1, 2)
LOSS_RTOL = 2e-3
J16, T16 = jnp.bfloat16, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers run at once: one intra-op thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer_cases():
    """name -> (JAX layer, port layer, inputs, static arguments)."""
    rng = np.random.default_rng(0)
    cases = {}
    x = rng.standard_normal((2, 64, 3, 11)).astype(np.float32)
    cases["conv_mlp"] = (JL.ConvMLP((16, 16, 8), dtype=J16), TL.ConvMLP(11, (16, 16, 8), T16),
                         [x], ())
    xyz, _ = make_grids(rng, b=2, h1=8, w1=16)
    feats = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), k=8, distance=3.0, mlp=(8, 8, 16), out_hw=(4, 4))
    cases["down_conv"] = (JL.DownConv(**kw, dtype=J16), TL.DownConv(4, **kw, dtype=T16),
                          [xyz, feats], ((2, 4),))
    xyz1, _ = make_grids(rng, b=2, h1=8, w1=16)
    _, xyz2 = make_grids(rng, b=2, h2=4, w2=8)
    f1 = rng.standard_normal((2, 128, 6)).astype(np.float32)
    f2 = rng.standard_normal((2, 4, 8, 5)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), nsample=4, distance=6.0, stride_hw=(2, 2),
              mlp=(16, 8), mlp2=(16, 8))
    cases["up_conv"] = (JL.UpConv(**kw, dtype=J16), TL.UpConv(6, 5, **kw, dtype=T16),
                        [xyz1, xyz2, f1, f2], ())
    xyz1, xyz2 = make_grids(rng, b=2, h1=8, w1=16, invalid_frac=0.2)
    f1 = rng.standard_normal((2, 8, 16, 6)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 16, 7)).astype(np.float32)
    kw = dict(kernel_size1=(3, 3), kernel_size2=(3, 5), nsample=4, nsample_q=6,
              distance=2.0, mlp1=(16, 8, 8), mlp2=(16, 8))
    cases["cost_volume"] = (JL.CostVolume(**kw, dtype=J16),
                            TL.CostVolume(6, 7, **kw, dtype=T16), [xyz1, xyz2, f1, f2], ())
    return cases


def _flow_predictor():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 32, 5)).astype(np.float32)
    b = rng.standard_normal((2, 32, 7)).astype(np.float32)
    jm, tm = JL.FlowPredictor((16, 8), dtype=J16), TL.FlowPredictor(12, (16, 8), T16)
    variables = jax.jit(lambda a, b: jm.init(jax.random.key(0), [a, b], False, 0.99))(a, b)
    variables = randomize_batch_stats(variables)
    want = jax.jit(lambda v, a, b: jm.apply(v, [a, b], False, 0.99))(variables, a, b)
    to_torch_module(tm, variables)
    with torch.no_grad():
        return want, tm([t(a), t(b)])


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


def _assert_close_in_ulps(got, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(w).max())
    assert scale > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=ULPS * BF16_EPS * scale)


@pytest.mark.parametrize("name", ["conv_mlp", "down_conv", "up_conv", "cost_volume",
                                  "flow_predictor"])
def test_layer_dtype_and_values_match_jax(name):
    if name == "flow_predictor":
        want, got = _flow_predictor()
    else:
        jm, tm, arrays, static = _layer_cases()[name]
        arrays = [jnp.asarray(a) for a in arrays]
        variables = jax.jit(lambda a: jm.init(jax.random.key(0), *a, *static, False, 0.99))(
            arrays)
        variables = randomize_batch_stats(variables)
        want = jax.jit(lambda v, a: jm.apply(v, *a, *static, False, 0.99))(variables, arrays)
        to_torch_module(tm, variables)
        with torch.no_grad():
            got = tm(*[t(a) for a in arrays], *static)
    if name == "down_conv":
        (want, want_xyz), (got, got_xyz) = want, got
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert _dtype_name(got) == str(want.dtype)
    _assert_close_in_ulps(got, want)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batch_norm_dtype_matches_jax(dtype, training):
    """Statistics and normalization in float32, the output in the input's
    dtype, the running statistics float32 (JAX ``layers.py:39-60``)."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((4, 16, 8)).astype(np.float32) * 3 + 1, dtype)
    jm = JL.ScheduledBatchNorm()
    variables = randomize_batch_stats(jm.init(jax.random.key(0), x, False, 0.9))
    want, mutated = jm.apply(variables, x, training, 0.9, mutable=["batch_stats"])
    tm = TL.ScheduledBatchNorm(8)
    to_torch_module(tm, variables).train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)),
                 0.9)
    assert _dtype_name(got) == str(want.dtype) == dtype
    _assert_close_in_ulps(got, want)
    assert tm.mean.dtype == tm.var.dtype == torch.float32
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(mutated["batch_stats"][name]), rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def nets():
    """The tiny network's float32 weights (randomized batch statistics,
    near-identity heads) through JAX in float32 and bfloat16 and through the
    port in bfloat16, on two batches of range images (B=2) projected by the
    JAX package; and the dtypes of the features that reached
    ``select_and_group`` in each package's bf16 forward."""
    j32 = j_tiny()
    j16 = dataclasses.replace(j32, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    h, w, n = j32.sensor.height, j32.sensor.width, j32.sensor.num_points
    projs = [
        project_to_range_image(jnp.asarray(np.stack([synthetic_scan(rng, n) for _ in range(2)])),
                               None, h, w, j32.sensor, method="packed")[0]
        for _ in range(2)
    ]
    variables = jax.jit(JNet(j32).init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, projs[0], projs[1], training=False)
    variables = randomize_batch_stats(variables)
    variables = {"params": near_identity_heads(variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    seen = {"jax": [], "port": []}

    def recorded(fn, key):
        def wrapped(xyz, feats, *args, **kwargs):
            seen[key].append((str(xyz.dtype), str(feats.dtype)))
            return fn(xyz, feats, *args, **kwargs)
        return wrapped

    def forward(cfg):
        return jax.jit(lambda v, a, b: JNet(cfg).apply(v, a, b, training=False))(variables, *projs)

    out = {"jax32": forward(j32)}
    j_group, t_group = JN.select_and_group, TN.select_and_group
    JN.select_and_group = recorded(j_group, "jax")
    TN.select_and_group = recorded(t_group, "port")
    try:
        out["jax16"] = forward(j16)
        port = to_torch_module(TNet(dataclasses.replace(t_tiny(), compute_dtype="bfloat16")),
                               variables)
        with torch.no_grad():
            out["port16"] = port(*[t(p) for p in projs])
    finally:
        JN.select_and_group, TN.select_and_group = j_group, t_group
    return out, seen, variables


def test_bf16_forward_is_closer_to_jax_bf16_than_jax_bf16_to_float32(nets):
    out, _, _ = nets
    for level in range(4):
        for key in ("q", "t"):
            port16 = out["port16"][key][level]
            assert port16.dtype == torch.float32  # the pose heads stay float32
            j16 = np.asarray(out["jax16"][key][level])
            j32 = np.asarray(out["jax32"][key][level])
            port_err = np.abs(port16.numpy() - j16).max()
            bf16_err = np.abs(j16 - j32).max()
            assert np.isfinite(port16.numpy()).all()
            assert port_err < bf16_err, (key, level, port_err, bf16_err)


def test_select_and_group_sees_float32_features(nets):
    """Every ``select_and_group`` call of both bf16 forwards (4 DownConvs of
    the merged tower and ``cv_down_l3``) gets float32 points and features."""
    _, seen, _ = nets
    assert len(seen["jax"]) == len(seen["port"]) == 5
    assert set(seen["jax"]) == {("float32", "float32")}
    assert set(seen["port"]) == {("torch.float32", "torch.float32")}


def test_bf16_train_step_matches_jax(nets):
    """The fixture's weights, one training forward and backward at B=2."""
    _, _, variables = nets
    j_cfg = dataclasses.replace(j_tiny(), compute_dtype="bfloat16", dropout_rate=0.0)
    t_cfg = dataclasses.replace(t_tiny(), compute_dtype="bfloat16", dropout_rate=0.0)
    batch = JSyn.synthetic_batch(np.random.default_rng(11), 2, j_cfg.sensor, training=True)
    p1, p2, q_gt, t_gt = j_forward_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                          j_cfg.sensor)
    model = JNet(j_cfg)
    params = {"model": variables["params"], "w_x": jnp.float32(0.1), "w_q": jnp.float32(-2.4)}

    def loss_fn(params, batch_stats):
        out, _ = model.apply({"params": params["model"], "batch_stats": batch_stats}, p1, p2,
                             training=True, bn_momentum=jnp.float32(0.5), stochastic=False,
                             mutable=["batch_stats"])
        return JLoss.total_loss(out, q_gt, t_gt, params["w_x"], params["w_q"])

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, variables["batch_stats"])
    assert {str(g.dtype) for g in jax.tree_util.tree_leaves(grads)} == {"float32"}

    host = jax.tree_util.tree_map(np.asarray, (params, variables["batch_stats"]))
    state_dict, w_x, w_q = train_state_to_torch(*host)
    net = TNet(t_cfg)
    net.load_state_dict(state_dict, strict=True)
    state = TState.create_train_state(net, TTrainConfig(batch_size=2), device="cpu",
                                      w_x=w_x, w_q=w_q)
    out = state.model(t(p1), t(p2), bn_momentum=torch.tensor(0.5), stochastic=False)
    loss, got = TLoss.total_loss(out, t(q_gt), t(t_gt), state.w_x, state.w_q)
    loss.backward()
    assert loss.dtype == torch.float32
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    assert {p.grad.dtype for p in state.parameters()} == {torch.float32}
    assert all(torch.isfinite(p.grad).all() for p in state.parameters())


def test_bf16_train_step_keeps_float32_state():
    """The port's ``make_train_step`` under bfloat16: float32 parameters,
    gradients, Adam moments and loss; the running statistics float32."""
    cfg = dataclasses.replace(t_tiny(), compute_dtype="bfloat16")
    cfg.validate()
    tcfg = TTrainConfig(batch_size=2, host_projection=False)
    torch.manual_seed(0)
    state = TState.create_train_state(TNet(cfg), tcfg, device="cpu")
    step = TStep.make_train_step(cfg, tcfg)
    batch = JSyn.synthetic_batch(np.random.default_rng(3), 2, cfg.sensor, training=True)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert metrics["loss"].dtype == torch.float32 and torch.isfinite(metrics["loss"])
    assert {p.dtype for p in state.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in state.parameters()} == {torch.float32}
    moments = [v for st in state.optimizer.state.values() for v in st.values() if v.dim() > 0]
    assert moments and {v.dtype for v in moments} == {torch.float32}
    assert {b.dtype for b in state.model.buffers()} == {torch.float32}
