"""The plain reference against the program's plain path, on the CPU at the
tiny configuration: the forward pass in eval and in training, the loss,
one train step's gradients and new statistics, and the streaming sequence
evaluation's poses.  (This test imports the program; the reference itself
imports nothing of it.)"""

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.reference import net as ref_net, train as ref_train
from benchmark.tests.conftest import tiny_config_dict


@pytest.fixture(scope="module")
def nets(tiny_weights):
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.pretrained import load_model

    cfg = tiny_config_dict()
    ref = ref_train.network(cfg, tiny_weights, "cpu")
    prog, _ = load_model(str(tiny_weights), tiny_model_config(), device="cpu")
    return prog, ref, cfg


def _images(cfg, seed, b=2):
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.training.step import _forward_inputs

    traffic = {"pool": 1, "batch_size": b}
    batch = generate.train_batches(seed, cfg["sensor"], traffic, "cpu")[0]
    got = _forward_inputs(batch, tiny_model_config().sensor, "cpu")
    want = ref_train.inputs(batch, cfg["sensor"], "cpu")
    return batch, got, want


def test_weights_reader_matches_the_program(nets, tiny_weights):
    prog, ref, _ = nets
    want = prog.state_dict()
    got = ref.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_inputs_match(nets, seed):
    _, got, want = _images(nets[2], seed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_forward_matches(nets, seed):
    prog, ref, cfg = nets
    _, (p1, p2, _, _), _ = _images(cfg, seed)
    with torch.no_grad():
        a = prog.eval()(p1, p2)
        b = ref.eval()(p1, p2)
    for lvl in range(4):
        assert torch.equal(a["q"][lvl], b["q"][lvl]) and torch.equal(a["t"][lvl], b["t"][lvl])


def test_training_forward_loss_and_gradients_match(nets):
    """One training step from the same weights, batch and generator seed:
    the losses of all levels equal, the gradients and the new batch
    statistics equal to rounding."""
    from efficientlo_net_torch.config import TrainConfig, tiny_model_config
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step

    prog0, ref, cfg = nets
    hp = {"base_learning_rate": 1e-3, "lr_decay_step": 200000, "lr_decay_rate": 0.7,
          "lr_floor": 1e-5, "bn_init_decay": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 200000,
          "bn_decay_clip": 0.99, "w_x_init": 0.0, "w_q_init": -2.5, "adam_b1": 0.9,
          "adam_b2": 0.999, "adam_eps": 1e-8}
    batch = generate.train_batches(3, cfg["sensor"], {"pool": 1, "batch_size": 2}, "cpu")[0]
    model = type(prog0)(tiny_model_config())
    model.load_state_dict(prog0.state_dict())
    state = create_train_state(model, TrainConfig(batch_size=2), device="cpu")
    grads = {}
    params = dict(state.model.named_parameters(), w_x=state.w_x, w_q=state.w_q)

    def keep_grads(name):
        if name == "backward":
            grads.update({n: p.grad.clone() for n, p in params.items()})

    _, metrics = make_train_step(tiny_model_config(), TrainConfig(batch_size=2))(
        state, batch, torch.Generator().manual_seed(9), stage=keep_grads)
    ref_copy = ref_net.Network(ref.cfg)
    ref_copy.load_state_dict(ref.state_dict())
    out = ref_train.train_steps(ref_copy, [batch], torch.Generator().manual_seed(9), hp, 2, "cpu")
    for k in ref_train.LOSS_KEYS:
        assert float(metrics[k]) == pytest.approx(out["losses"][k][0], rel=1e-6, abs=1e-6), k
    scale = max(float(g.abs().max()) for g in out["first_grad"].values())
    for n, g in out["first_grad"].items():
        assert torch.allclose(grads[n], g, rtol=0, atol=1e-5 * scale), n
    for n, buf in ref_copy.named_buffers():
        assert torch.allclose(dict(state.model.named_buffers())[n], buf, rtol=1e-5, atol=1e-6), n


def test_streaming_eval_poses_match(nets):
    """The program's streaming sequence evaluation over an in-memory drive
    against the reference's poses of the same frames."""
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.evaluation import runner
    from efficientlo_net_torch.training.step import make_streaming_eval_fns

    prog, ref, cfg = nets
    traffic = {"frames": 271, "spacing_m": [0.5, 1.5], "yaw_step_rad": 0.02,
               "block_spacing_m": 30.0}
    poses, world = generate.drive(4, cfg["sensor"], traffic)
    scans = generate.render(poses, world, cfg["sensor"], "cpu")

    class Drive:
        def read_scan(self, seq, frame):
            return scans[frame]

    enc, cor = make_streaming_eval_fns(tiny_model_config())
    q, t = runner.predict_sequence_streaming(enc, cor, prog, Drive(), 4, batch_size=8,
                                             num_workers=2)
    frames = [0, 1, 7, 8, 9, 100, 270]
    want = ref_train.sequence_poses(ref, lambda f: scans[f], frames, "cpu", block=4)
    got = np.concatenate([q[frames], t[frames]], axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
