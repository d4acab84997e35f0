"""Eval-mode batch norm + ReLU in one pass (``efficientlo::bn_relu``,
efficientlo_net_torch/ops/csrc/bn_relu.cu).

On the CPU: the operator passes ``torch.library.opcheck``; its CPU
implementation equals ``ConvMLP``'s eval chain (``ScheduledBatchNorm``, then
``torch.relu``) bit for bit, special values included; ``ConvMLP`` calls it
only for eval-mode batch norm with gradients off on a float32 CUDA tensor
(fake CUDA tensors stand in for the card), and every other case keeps the
chain and counts no ``launch.bn_relu``; the network has 12 batch-norm layers
in a tower and 77 in the correlation; ``cuda_build.load`` builds every
missing source in one call.

On the card (marked ``cuda``, skipped without one; no JAX import): the kernel
equals the chain bit for bit at every width of the network, odd row counts,
C = 5, wide and misaligned inputs, and NaN, ±inf, -0.0 and values near
1e±30; a full ``ModelConfig()`` eval forward gives the same poses with the
fused pass as with the chain; ``launch.bn_relu`` reads 12 a pyramid and 77
a correlation in ``make_streaming_eval_fns`` and 0 in a train step; the card
artifact traces with the operator and gives the direct call's poses.  Run on
the card with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_bn_relu.py
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from efficientlo_net_torch.config import ModelConfig, TrainConfig, tiny_model_config
from efficientlo_net_torch.data.synthetic import synthetic_batch, synthetic_pair
from efficientlo_net_torch.models import layers
from efficientlo_net_torch.models.pwclo import PWCLONet
from efficientlo_net_torch.ops import bn_relu as bnr
from efficientlo_net_torch.ops import cuda_build
from efficientlo_net_torch.ops.projection import crop_and_project
from efficientlo_net_torch.utils import profiling

CFG = tiny_model_config()
WIDTHS = (8, 16, 32, 64, 128)  # every width of the network's ConvMLPs
TOWER_LAYERS, CORRELATION_LAYERS = 12, 77
SPECIAL = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e30, -1e30, 1e-30, -1e-30,
           3.4e38, -3.4e38, 1e-45)


def _params(c, seed=0):
    """Running statistics, scale and bias of a trained-looking layer."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g), torch.rand(c, generator=g) * 2 + 1e-3,
            torch.randn(c, generator=g), torch.randn(c, generator=g))


def _special_x(rows, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=g) * 3
    pick = torch.randint(0, len(SPECIAL), (rows, c), generator=g)
    put = torch.rand(rows, c, generator=g) < 0.3
    return torch.where(put, torch.tensor(SPECIAL)[pick], x)


def _bn(c, seed=0):
    """An eval-mode ``ScheduledBatchNorm`` with ``_params``."""
    bn = layers.ScheduledBatchNorm(c).eval()
    mean, var, scale, bias = _params(c, seed)
    with torch.no_grad():
        bn.mean.copy_(mean)
        bn.var.copy_(var)
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    return bn


def _bits(t):
    """The float32 tensor's bits: equal bits compare NaNs and -0.0 too."""
    return t.contiguous().view(torch.int32)


def _randomize_bn(model, seed=0):
    """Give every batch norm of ``model`` trained-looking running statistics,
    scale and bias (fresh ones are mean 0, var 1, scale 1, bias 0)."""
    for i, bn in enumerate(m for m in model.modules()
                           if isinstance(m, layers.ScheduledBatchNorm)):
        src = _bn(bn.mean.shape[0], seed + i)
        bn.load_state_dict(src.state_dict())
    return model


class _Ops(TorchDispatchMode):
    """Records the name of every operator dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


# ---- CPU -------------------------------------------------------------------------

@pytest.mark.parametrize("c", [5, 8, 64, 128])
def test_opcheck(c):
    mean, var, scale, bias = _params(c)
    x = torch.randn(3, 11, c, generator=torch.Generator().manual_seed(c))
    torch.library.opcheck(bnr.bn_relu_op, (x, mean, var, scale, bias, 1e-3))


@pytest.mark.parametrize("special", [False, True], ids=["normal", "special"])
@pytest.mark.parametrize("c", [5, 8, 64, 128])
def test_cpu_op_equals_the_convmlp_chain(c, special):
    """The operator's CPU implementation against ``ConvMLP``'s eval chain."""
    bn = _bn(c, seed=c)
    x = _special_x(4 * 37, c, seed=c) if special else torch.randn(4 * 37, c) * 3
    x = x.reshape(4, 37, c)
    with torch.no_grad():
        want = torch.relu(bn(x))
        got = torch.ops.efficientlo.bn_relu(x, bn.mean, bn.var, bn.scale, bn.bias, bn.epsilon)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))


# (device, training, gradients on, compute dtype) -> the fused pass?
DISPATCH = {
    "cuda_eval_no_grad": ("cuda", False, False, torch.float32, True),
    "cuda_eval_grad": ("cuda", False, True, torch.float32, False),
    "cuda_eval_no_grad_bf16": ("cuda", False, False, torch.bfloat16, False),
    "cuda_train_no_grad": ("cuda", True, False, torch.float32, False),
    "cuda_train_grad": ("cuda", True, True, torch.float32, False),
    "cpu_eval_no_grad": ("cpu", False, False, torch.float32, False),
    "cpu_eval_grad": ("cpu", False, True, torch.float32, False),
    "cpu_train": ("cpu", True, True, torch.float32, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_rule(case):
    device, training, grad, dtype, fused = DISPATCH[case]
    bn = layers.ScheduledBatchNorm(8).train(training)
    with FakeTensorMode():
        x = torch.zeros(2, 3, 8, dtype=dtype, device=device)
        with torch.set_grad_enabled(grad):
            assert layers._fuses_bn_relu(bn, x) is fused


@pytest.mark.parametrize("case", [c for c in sorted(DISPATCH) if not DISPATCH[c][1]])
def test_convmlp_eval_calls_the_operator_only_where_the_rule_holds(case):
    """A two-layer ``ConvMLP`` in eval: on fake CUDA tensors for the card's
    cases (training-mode batch norm cannot update fake CUDA buffers; the
    rule is tested above and a real training forward below)."""
    device, _, grad, dtype, fused = DISPATCH[case]
    mlp = layers.ConvMLP(5, (8, 16), dtype).eval()
    profiling.reset(bnr.COUNTER)
    if device == "cuda":
        state = {**dict(mlp.named_parameters()), **dict(mlp.named_buffers())}
        with FakeTensorMode():
            fake = {k: torch.empty(v.shape, device="cuda") for k, v in state.items()}
            x = torch.zeros(2, 7, 3, 5, device="cuda")
            with torch.set_grad_enabled(grad), _Ops() as ops:
                y = torch.func.functional_call(mlp, fake, (x,))
    else:
        with torch.set_grad_enabled(grad), _Ops() as ops:
            y = mlp(torch.randn(2, 7, 3, 5))
    calls = ops.names.count("efficientlo.bn_relu.default")
    assert calls == (2 if fused else 0)
    assert ops.names.count("aten.relu.default") == (0 if fused else 2)
    assert y.shape == (2, 7, 3, 16) and y.device.type == device
    assert profiling.counters().get(bnr.COUNTER, 0) == 0  # fake or CPU: no launch


def test_training_forward_keeps_the_chain_and_updates_statistics():
    mlp = layers.ConvMLP(5, (8, 16)).train()
    profiling.reset(bnr.COUNTER)
    before = mlp.bn_0.mean.clone()
    with _Ops() as ops:
        y = mlp(torch.randn(2, 7, 3, 5), 0.9)
    y.sum().backward()
    assert "efficientlo.bn_relu.default" not in ops.names
    assert ops.names.count("aten.relu.default") == 2
    assert not torch.equal(mlp.bn_0.mean, before)
    assert mlp.dense_0.weight.grad is not None
    assert profiling.counters().get(bnr.COUNTER, 0) == 0


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_relu_is_relu_of_the_batch_norm(training):
    """``ScheduledBatchNorm.forward_relu`` on the CPU: ``relu(bn(x))``, the
    same running statistics after it in training."""
    x = torch.randn(3, 11, 8, generator=torch.Generator().manual_seed(5)) * 3
    a, b = _bn(8, seed=1).train(training), _bn(8, seed=1).train(training)
    with torch.no_grad():
        got = a.forward_relu(x, 0.9)
        want = torch.relu(b(x, 0.9))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)
    assert torch.equal(a.mean, _bn(8, seed=1).mean) != training


def _bn_calls(model, fn):
    """fn()'s calls of the batch norms of ``model``, counted by forward hooks."""
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in model.modules() if isinstance(m, layers.ScheduledBatchNorm)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


def test_the_network_has_12_tower_and_77_correlation_layers():
    """The layers the fused pass replaces, per streaming-eval step: 12 batch
    norms in ``encode`` (one pyramid) and 77 in ``correlate``."""
    from efficientlo_net_torch.training.step import make_streaming_eval_fns

    torch.manual_seed(0)
    model = PWCLONet(CFG).eval()
    encode, correlate = make_streaming_eval_fns(CFG)
    pc1, pc2, _ = synthetic_pair(np.random.default_rng(0), CFG.sensor)
    pyr = []
    assert _bn_calls(model, lambda: pyr.append(encode(model, torch.as_tensor(pc1[None])))) \
        == TOWER_LAYERS
    pyr.append(encode(model, torch.as_tensor(pc2[None])))
    assert _bn_calls(model, lambda: correlate(model, pyr[1], pyr[0])) == CORRELATION_LAYERS


def test_load_builds_every_missing_source_in_one_call(monkeypatch, tmp_path):
    calls = []

    def build(sources=cuda_build.SOURCES):
        calls.append(tuple(sources))
        return {s: tmp_path / s for s in sources}

    monkeypatch.setattr(cuda_build, "build", build)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    assert "bn_relu.cu" in cuda_build.SOURCES
    lib = cuda_build.load("bn_relu.cu")
    assert calls == [cuda_build.SOURCES] and lib == ("lib", str(tmp_path / "bn_relu.cu"))
    cuda_build.load("bn_relu.cu")
    assert len(calls) == 1


# ---- card ------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _launched(fn, n=1):
    """fn()'s result, checking that it launched the kernel ``n`` times."""
    before = profiling.counters().get(bnr.COUNTER, 0)
    out = fn()
    torch.cuda.synchronize()
    assert profiling.counters().get(bnr.COUNTER, 0) - before == n
    return out


def _card_case(x, bn, dev):
    """The kernel against the chain and the plain version on the card."""
    bn = bn.to(dev)
    x = x.to(dev)
    got = _launched(lambda: torch.ops.efficientlo.bn_relu(x, bn.mean, bn.var, bn.scale,
                                                           bn.bias, bn.epsilon))
    with torch.no_grad():
        chain = torch.relu(bn(x))
    plain = bnr.bn_relu_plain(x, bn.mean, bn.var, bn.scale, bn.bias, bn.epsilon)
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(chain))
    assert torch.equal(_bits(got), _bits(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 4097, 300_001])
@pytest.mark.parametrize("c", (5,) + WIDTHS)
def test_kernel_equals_the_chain_on_the_card(dev, c, rows):
    x = torch.randn(rows, c, generator=torch.Generator().manual_seed(rows + c)) * 3
    _card_case(x, _bn(c, seed=c), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("c", (5,) + WIDTHS)
def test_kernel_special_values_on_the_card(dev, c):
    """NaN, ±inf, -0.0 and values near 1e±30 in x, and in the layer's values
    a -0.0 bias and zero mean and scale, so that -0.0 reaches the ReLU."""
    x = _special_x(1001, c, seed=c)
    bn = _bn(c, seed=c)
    with torch.no_grad():
        bn.bias[::3] = -0.0
        bn.mean[::4] = 0.0
        bn.scale[1::5] = 0.0
        bn.var[2::7] = 1e30
    _card_case(x, bn, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned", "wide_vector", "wide_scalar", "batched"])
def test_kernel_other_layouts_on_the_card(dev, case):
    """A 4-byte-aligned x (the scalar path with C % 4 == 0), more than 256
    channel groups (a thread walks over several), and a 4-D activation."""
    g = torch.Generator().manual_seed(3)
    if case == "misaligned":
        c = 64
        x = (torch.randn(999 * c + 1, generator=g) * 3).to(dev)[1:].view(999, c)
    elif case == "wide_vector":
        c = 4 * 257
        x = torch.randn(301, c, generator=g) * 3
    elif case == "wide_scalar":
        c = 257
        x = torch.randn(301, c, generator=g) * 3
    else:
        c = 32
        x = torch.randn(3, 77, 9, c, generator=g) * 3
    _card_case(x, _bn(c, seed=c), dev)


def _full_forward(model, imgs):
    with torch.no_grad():
        out = model(*imgs)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_full_config_eval_forward_fused_equals_chain(dev, monkeypatch):
    cfg = ModelConfig()
    torch.manual_seed(0)
    model = _randomize_bn(PWCLONet(cfg)).to(dev).eval()
    rng = np.random.default_rng(7)
    pairs = [synthetic_pair(rng, cfg.sensor)[:2] for _ in range(2)]
    imgs = [crop_and_project(torch.as_tensor(np.stack(frames)).to(dev), cfg.sensor)
            for frames in zip(*pairs)]
    fused = _launched(lambda: _full_forward(model, imgs), TOWER_LAYERS + CORRELATION_LAYERS)
    monkeypatch.setattr(layers, "_fuses_bn_relu", lambda bn, x: False)
    chain = _launched(lambda: _full_forward(model, imgs), 0)
    for key in ("q", "t"):
        for a, b in zip(fused[key], chain[key]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counts_in_streaming_eval_and_training(dev):
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_streaming_eval_fns, make_train_step

    torch.manual_seed(0)
    model = PWCLONet(CFG).to(dev)
    encode, correlate = make_streaming_eval_fns(CFG)
    rng = np.random.default_rng(1)
    pc1, pc2, _ = synthetic_pair(rng, CFG.sensor)
    pyr1 = _launched(lambda: encode(model, torch.as_tensor(pc1[None])), TOWER_LAYERS)
    pyr2 = _launched(lambda: encode(model, torch.as_tensor(pc2[None])), TOWER_LAYERS)
    _launched(lambda: correlate(model, pyr2, pyr1), CORRELATION_LAYERS)

    tcfg = TrainConfig(batch_size=2, host_projection=False)
    state = create_train_state(PWCLONet(CFG), tcfg, device=dev)
    step = make_train_step(CFG, tcfg)
    batch = synthetic_batch(rng, 2, CFG.sensor, training=True)
    _launched(lambda: step(state, batch, torch.Generator(dev)), 0)


@pytest.mark.cuda
def test_card_artifact_holds_the_operator(dev, tmp_path):
    from efficientlo_net_torch.serving.export import (export_odometry, load_odometry,
                                                      make_infer_fn, save_artifact)

    torch.manual_seed(0)
    model = _randomize_bn(PWCLONet(CFG)).to(dev)
    exported = export_odometry(model, CFG, batch_size=1, device=dev)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("efficientlo.bn_relu.default") == TOWER_LAYERS + CORRELATION_LAYERS
    _, call = load_odometry(save_artifact(str(tmp_path / "odom"), exported))
    rng = np.random.default_rng(2)
    pc1, pc2 = (torch.as_tensor(s[None], device=dev) for s in synthetic_pair(rng, CFG.sensor)[:2])
    q, t = _launched(lambda: call(pc1, pc2), TOWER_LAYERS + CORRELATION_LAYERS)
    with torch.no_grad():
        q_d, t_d = make_infer_fn(model, CFG)(pc1, pc2)
    assert torch.equal(q, q_d) and torch.equal(t, t_d)
