"""The counts of ``counts/network.py`` against hand counts at the tiny
configuration, against the dense products the program's linear layers
really compute, and against the select calls the program really makes."""

import pytest
import torch

from benchmark import generate
from benchmark.counts import network as counts
from benchmark.tests.conftest import tiny_config_dict


def test_tower_flops_by_hand():
    # l0: 8x32 centres, K 8, in 3+3, widths 4,4,8; l1: 4x16, K 8, in 3+8,
    # widths 8,8,16; l2: 4x8, K 4, in 3+16, widths 16,16,32; l3: 4x4, K 4,
    # in 3+32, widths 32,32,64
    hand = (2 * 256 * 8 * (6 * 4 + 4 * 4 + 4 * 8) + 2 * 64 * 8 * (11 * 8 + 8 * 8 + 8 * 16)
            + 2 * 32 * 4 * (19 * 16 + 16 * 16 + 16 * 32) + 2 * 16 * 4 * (35 * 32 + 32 * 32 + 32 * 64))
    assert counts.mlp_flops(tiny_config_dict())["tower"] == hand == 1392640


def test_level_shapes_are_the_programs():
    from efficientlo_net_torch.config import ModelConfig, sensor_preset, tiny_model_config

    from benchmark import harness

    for name, cfg in (("hdl64", ModelConfig()), ("os1_64", ModelConfig(sensor=sensor_preset("os1_64")))):
        assert counts.level_shapes(harness.read_json(harness.HERE / "configs" / f"{name}.json")) \
            == list(cfg.level_shapes)
    assert counts.level_shapes(tiny_config_dict()) == list(tiny_model_config().level_shapes)


class _LinearFlops:
    """Forward hooks on every ``nn.Linear``: 2 x rows x in x out."""

    def __init__(self, model):
        self.flops = 0
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()
                        if isinstance(m, torch.nn.Linear)]

    def _hook(self, module, inputs, output):
        rows = inputs[0].numel() // module.in_features
        self.flops += 2 * rows * module.in_features * module.out_features

    def close(self):
        for h in self.handles:
            h.remove()


@pytest.fixture
def tiny_program(tiny_weights):
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.pretrained import load_model

    return load_model(str(tiny_weights), tiny_model_config(), device="cpu")[0]


def _eval_batch(tiny_program, b, between=lambda: None):
    """One batch of a sequence: the previous frames' pyramid, ``between()``,
    then the new frames encoded and correlated with it."""
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.training.step import make_streaming_eval_fns

    cfg = tiny_config_dict()
    batch = generate.train_batches(1, cfg["sensor"], {"pool": 1, "batch_size": b}, "cpu")[0]
    enc, cor = make_streaming_eval_fns(tiny_model_config())
    prev = enc(tiny_program, torch.as_tensor(batch["pc2"]))
    between()
    cor(tiny_program, enc(tiny_program, torch.as_tensor(batch["pc1"])), prev)


def _train_step(tiny_program, b):
    from efficientlo_net_torch.config import TrainConfig, tiny_model_config
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step

    batch = generate.train_batches(2, tiny_config_dict()["sensor"],
                                   {"pool": 1, "batch_size": b}, "cpu")[0]
    state = create_train_state(tiny_program, TrainConfig(batch_size=b), device="cpu")
    make_train_step(tiny_model_config(), TrainConfig(batch_size=b))(
        state, batch, torch.Generator().manual_seed(0))


def test_flops_match_the_programs_linear_layers(tiny_program):
    cfg = tiny_config_dict()
    f = counts.mlp_flops(cfg)
    hooks = _LinearFlops(tiny_program)
    try:
        _eval_batch(tiny_program, 4, between=lambda: setattr(hooks, "flops", 0))
        assert hooks.flops == 4 * counts.flops_per_sample(cfg, training=False)
        hooks.flops = 0
        _train_step(tiny_program, 2)
        # the forward of a training pair: both towers and the correlation
        assert hooks.flops == 2 * (2 * f["tower"] + f["correlate"])
        assert counts.flops_per_sample(cfg, training=True) == 3 * (2 * f["tower"] + f["correlate"])
    finally:
        hooks.close()


class _Recorder:
    """Stands in for ``torch.ops.efficientlo``: records each select call's
    arguments and results, then answers with the real operator."""

    def __init__(self):
        self.calls = []

    def window_select(self, *args):
        out = torch.ops.efficientlo.window_select(*args)
        self.calls.append(("window_select", args, out))
        return out

    def select_and_group(self, *args):
        out = torch.ops.efficientlo.select_and_group(*args)
        self.calls.append(("select_and_group", args, out))
        return out


def _recorded_bytes(kind, args, out):
    """Bytes from the recorded arguments, as ``chip_smoke.py::select_bytes``
    counts them: the source, the centres where they are another grid, the
    scan order (int32, as the kernel reads it) and what is written."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    perm = args[-1]
    order = 0 if perm is None else perm.numel() * 4
    if kind == "select_and_group":
        return nbytes(args[0], args[1], *out) + order
    xyz1, xyz2 = args[0], args[1]
    same = xyz1.data_ptr() == xyz2.data_ptr() and xyz1.shape == xyz2.shape
    centres = 0 if same else out[0].shape[0] * out[0].shape[1] * 3 * 4
    return centres + nbytes(xyz2, *out) + order


@pytest.mark.parametrize("training", [True, False])
def test_select_sites_match_the_recorded_calls(tiny_program, monkeypatch, training):
    from efficientlo_net_torch.ops import neighbors

    rec = _Recorder()
    neighbors._ops()  # registers the operators
    monkeypatch.setattr(neighbors, "_ops", lambda: rec)
    b = 2
    if training:
        _train_step(tiny_program, b)
    else:
        _eval_batch(tiny_program, b, between=rec.calls.clear)
    sites = counts.select_sites(tiny_config_dict(), b, training=training)
    kinds = [k for k, _, _ in rec.calls]
    assert kinds == [s.kind for s in sites]
    assert kinds.count("window_select") == (23 if training else 14)
    for site, (kind, args, out) in zip(sites, rec.calls):
        assert out[0].shape[:3] == (site.b, site.centres, site.k), site.name
        assert tuple(args[2]) == site.kernel, site.name
        assert (args[-1] is not None) == site.permuted, site.name
        assert _recorded_bytes(kind, args, out) == site.bytes, site.name


def test_select_bound_takes_the_larger_of_bytes_and_operations():
    site = counts.Site("s", "window_select", "knn", 1, (4, 4), (4, 4), (3, 5), 4)
    assert site.ops == 13 * 16 * 15
    assert site.bound_s(1.0, 1e12) == site.bytes
    assert site.bound_s(1e12, 1.0) == site.ops
    first_k = counts.Site("s", "window_select", "first_k", 1, (4, 4), (4, 4), (3, 5), 4)
    assert first_k.ops == 13 * 16 * 4
