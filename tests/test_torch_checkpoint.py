"""The port's checkpoints, trainer and logger, on the CPU, and a tiny trainer
on the card.

The checkpoint cases are those of the JAX package's tests/test_checkpoint.py;
the trainer cases those of tests/test_integration.py, plus exact resume:
a run that is saved, restored and continued gives the parameters, batch
statistics and optimizer state of the uninterrupted run, bit for bit.  No
JAX import, so the card case runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_checkpoint.py
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from efficientlo_net_torch import cli
from efficientlo_net_torch.config import ModelConfig, TrainConfig, tiny_model_config
from efficientlo_net_torch.data.kitti import SEQ_LENGTH_TABLE
from efficientlo_net_torch.data.synthetic import random_scene
from efficientlo_net_torch.models.pwclo import PWCLONet
from efficientlo_net_torch.pretrained import load_pretrained, variables_to_state_dict
from efficientlo_net_torch.training.checkpoint import CheckpointManager
from efficientlo_net_torch.training.state import create_train_state
from efficientlo_net_torch.training.trainer import Trainer
from efficientlo_net_torch.utils.logging import Logger
# bare name: pytest puts tests/ on sys.path, and a machine may have an
# unrelated "tests" package installed that would shadow tests.<module>
from torch_cases import KITTI_SEQ, build_fake_kitti

CFG = tiny_model_config()
TCFG = TrainConfig(batch_size=2)
ARTIFACT = str(Path(__file__).resolve().parents[1] / "pretrained" / "synthetic_drive_50ep.msgpack")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes gain nothing from torch's intra-op threads, and the suite
    runs several worker processes at once: one thread each keeps them from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0, step=0, device="cpu"):
    torch.manual_seed(seed)
    state = create_train_state(PWCLONet(CFG), TCFG, device=device)
    state.step = step
    return state


def _tensors(state):
    """Every tensor a checkpoint holds, by name: the network's state dict,
    w_x, w_q and the optimizer's state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update(w_x=state.w_x.detach(), w_q=state.w_q.detach())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def assert_states_equal(a, b):
    assert a.step == b.step
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k].cpu(), tb[k].cpu()), k


def _optimizer_moved(state):
    """Adam state on every parameter: one update from unit gradients."""
    for p in state.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# CheckpointManager: the five cases of the JAX package


def test_save_restore_roundtrip(tmp_path):
    state = _state(step=7)
    _optimizer_moved(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state) == 7
    assert os.path.exists(tmp_path / "ckpt" / "ckpt_7.pt")
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]
    other = _state(seed=123)
    restored = mgr.restore(other)
    assert restored is other and restored.step == 7
    assert_states_equal(restored, state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(other)


def test_best_model_retention(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.best_error() == float("inf")
    assert mgr.maybe_save_best(state, 2.0)
    assert not mgr.maybe_save_best(state, 3.0)  # worse: rejected
    state.step = 1
    assert mgr.maybe_save_best(state, 1.5)  # better: kept
    assert mgr.best_error() == 1.5
    assert not mgr.maybe_save_best(state, float("nan"))
    with open(tmp_path / "ckpt" / "best.json") as f:
        assert json.load(f) == {"val_t_rel": 1.5, "step": 1}
    assert os.listdir(tmp_path / "ckpt" / "best") == ["ckpt_1.pt"]  # one slot


def test_epoch_metadata_and_resume(tmp_path):
    state = _state(step=42)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state, metrics={"val_t_rel": 1.25}, epoch=3) == 42
    meta = mgr.metadata()
    assert meta["epoch"] == 3 and meta["val_t_rel"] == 1.25
    # idempotent per step: a second save keeps the checkpoint, rewrites the metadata
    mtime = os.path.getmtime(tmp_path / "ckpt" / "ckpt_42.pt")
    assert mgr.save(state, metrics={"val_t_rel": 1.20}, epoch=3) == 42
    assert mgr.metadata(42)["val_t_rel"] == 1.20
    assert os.path.getmtime(tmp_path / "ckpt" / "ckpt_42.pt") == mtime
    assert mgr.latest_step() == 42 and mgr.metadata(7) == {}


def test_best_survives_rotation_eviction(tmp_path):
    """max_to_keep newer routine saves never evict the best model."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    best = _state(seed=5, step=10)
    assert mgr.maybe_save_best(best, 1.0)
    for s in (20, 30, 40, 50, 60):
        state.step = s
        mgr.save(state, epoch=s)
    assert mgr.all_steps() == [50, 60]  # step 10 evicted from rotation
    restored = mgr.restore_best(_state(seed=9))
    assert restored.step == 10
    assert_states_equal(restored, best)


def test_mark_best_points_at_saved_step(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    step = mgr.save(state, epoch=0)
    mgr.mark_best(step, 0.9)
    assert mgr.best_error() == 0.9
    assert os.listdir(tmp_path / "ckpt" / "best") == []
    restored = mgr.restore_best(_state(seed=4))  # from the rotation, through best.json
    assert_states_equal(restored, state)


# ---------------------------------------------------------------------------
# Trainer


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    scene = random_scene(np.random.default_rng(0), 4096, CFG.sensor)
    root, gt_dir, _ = build_fake_kitti(tmp_path_factory.mktemp("kitti"), scene,
                                       CFG.sensor.num_points)
    return root, gt_dir


def _trainer(tree, log_dir, tcfg=TCFG, cfg=CFG, device="cpu"):
    root, gt_dir = tree
    return Trainer(cfg, tcfg, data_root=root, log_dir=str(log_dir), gt_dir=gt_dir,
                   train_list=[KITTI_SEQ], val_list=[KITTI_SEQ], device=device)


def test_train_one_epoch_and_logs(tree, tmp_path):
    trainer = _trainer(tree, tmp_path / "log")
    loss = trainer.train_one_epoch(0, limit_batches=3)
    assert trainer.state.step == 3 and np.isfinite(loss)
    assert trainer.state.model.training
    with open(tmp_path / "log" / "config.json") as f:
        snap = json.load(f)
    assert snap["train"] == dataclasses.asdict(TCFG)
    assert snap["model"]["sensor"]["width"] == CFG.sensor.width
    with open(tmp_path / "log" / "log_train_scalars.jsonl") as f:
        scalars = [json.loads(line) for line in f]
    assert [s["name"] for s in scalars] == ["loss", "l0_loss", "l1_loss", "l2_loss", "l3_loss",
                                            "learning_rate", "bn_decay"]
    assert all(s["step"] == 1 for s in scalars)
    assert scalars[-1]["value"] == 0.5 and scalars[-2]["value"] == TCFG.base_learning_rate
    assert "epoch 0 batch 0/135" in (tmp_path / "log" / "log_train.txt").read_text()


def test_warm_start_restore_from_other_run(tree, tmp_path):
    """Restoring another run's checkpoint directory carries the state and
    the epoch: training resumes at the next epoch."""
    t1 = _trainer(tree, tmp_path / "run1")
    t1.ckpt.save(t1.state, epoch=3)
    t2 = _trainer(tree, tmp_path / "run2")
    assert t2.start_epoch == 0
    t2.restore(path=str(tmp_path / "run1" / "checkpoints"))
    assert t2.start_epoch == 4
    assert_states_equal(t2.state, t1.state)


def test_resume_is_exact(tree, tmp_path):
    """2 batches of epoch 0, save, 2 of epoch 1; against a fresh trainer that
    restores and takes the same 2 batches of epoch 1."""
    run = _trainer(tree, tmp_path / "run")
    run.train_one_epoch(0, limit_batches=2)
    run.ckpt.save(run.state, epoch=0)
    run.train_one_epoch(1, limit_batches=2)

    resumed = _trainer(tree, tmp_path / "resumed")
    resumed.restore(path=str(tmp_path / "run" / "checkpoints"))
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train_one_epoch(resumed.start_epoch, limit_batches=2)
    assert resumed.state.step == 4
    assert_states_equal(resumed.state, run.state)


def test_load_pretrained_keeps_training_state(tree, tmp_path):
    trainer = _trainer(tree, tmp_path / "log", tcfg=TrainConfig(), cfg=ModelConfig())
    _optimizer_moved(trainer.state)
    trainer.state.step = 5
    with torch.no_grad():
        trainer.state.w_x.fill_(0.25)
    kept = {k: v.clone() for k, v in _tensors(trainer.state).items()
            if not k.startswith("model.")}
    meta = trainer.load_pretrained(ARTIFACT)
    assert meta["trained_epochs"] == 50
    want = variables_to_state_dict(load_pretrained(ARTIFACT)[0])
    got = trainer.state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert trainer.state.step == 5 and trainer.state.w_x.item() == 0.25
    after = _tensors(trainer.state)
    for k, v in kept.items():  # w_x, w_q and the Adam moments
        assert torch.equal(after[k], v), k
    # the optimizer still updates the network's own parameters
    params = trainer.state.optimizer.param_groups[0]["params"]
    assert all(a is b for a, b in zip(params, trainer.state.parameters()))


def test_fit_validation_cadence(tree, tmp_path, monkeypatch):
    """Validate every 20 epochs up to 100 and every 2 after; always save
    after a validation, mark best on improvement (NaN never)."""
    trainer = _trainer(tree, tmp_path / "log")
    epochs, vals = [], iter([2.0, 1.0, 3.0, 0.5, float("nan")])
    real = trainer.train_one_epoch
    monkeypatch.setattr(trainer, "train_one_epoch",
                        lambda epoch: (epochs.append(epoch), real(epoch, limit_batches=1)))
    monkeypatch.setattr(trainer, "validate", lambda: next(vals))
    trainer.fit(max_epoch=21)
    trainer.start_epoch = 99
    trainer.fit(max_epoch=105)
    assert epochs == list(range(21)) + list(range(99, 105))
    mgr = trainer.ckpt
    saved = {mgr.metadata(s)["epoch"]: s for s in mgr.all_steps()}
    assert sorted(saved) == [0, 20, 100, 102, 104]
    assert saved[20] == 21 and saved[102] == 25  # the step after that epoch's batch
    assert mgr.metadata(saved[100])["val_t_rel"] == 3.0
    with open(tmp_path / "log" / "checkpoints" / "best.json") as f:
        assert json.load(f) == {"val_t_rel": 0.5, "step": saved[102]}
    assert os.listdir(tmp_path / "log" / "checkpoints" / "best") == [f"ckpt_{saved[102]}.pt"]


def test_quantized_transfer_batches_arrive_as_int16(tree, tmp_path):
    trainer = _trainer(tree, tmp_path / "log", tcfg=dataclasses.replace(
        TCFG, quantized_transfer=True, host_projection=False))  # the clouds' transfer
    seen = []
    step = trainer.train_step
    trainer.train_step = lambda state, batch, gen: (seen.append(batch), step(state, batch, gen))[1]
    assert np.isfinite(trainer.train_one_epoch(0, limit_batches=1))
    (batch,) = seen
    assert batch["pc1"].dtype == batch["pc2"].dtype == torch.int16
    assert batch["T_gt"].dtype == torch.float32 and batch["aug_frame"].dtype == torch.int32
    assert all(v.device.type == "cpu" for v in batch.values())


def test_logger_writes_log_and_scalars(tmp_path, capsys):
    logger = Logger(str(tmp_path / "run.txt"))
    logger.log("hello")
    logger.scalar("loss", np.float32(1.5), np.int64(3))
    logger.close()
    assert "hello" in capsys.readouterr().out
    assert (tmp_path / "run.txt").read_text().endswith("hello\n")
    (line,) = (tmp_path / "run_scalars.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert rec["name"] == "loss" and rec["value"] == 1.5 and rec["step"] == 3
    Logger(None).scalar("x", 1.0, 0)  # no file: a no-op


def test_entry_points_refuse_missing_cuda(tree, tmp_path):
    """The trainer and the CLI default to the card and never fall back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _trainer(tree, tmp_path / "log", device="cuda")
    root, gt_dir = tree
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", "test", "--data_root", root, "--gt_dir", gt_dir,
                  "--log_dir", str(tmp_path / "cli_log"), "--test_list", str(KITTI_SEQ),
                  "--device", "cuda"])
    assert not list(tmp_path.glob("cli_log*"))


@pytest.mark.cuda
def test_tiny_trainer_on_the_card(tree, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from efficientlo_net_torch.ops import window_select as ws

    trainer = _trainer(tree, tmp_path / "log", device="cuda")
    ws.reset_launches()
    trainer.train_one_epoch(0, limit_batches=2)
    assert trainer.state.step == 2
    assert ws.launches == {"window_select": 46, "select_and_group": 0}
    trainer.ckpt.save(trainer.state, epoch=0)
    other = _trainer(tree, tmp_path / "log", device="cuda")
    other.restore()
    assert other.start_epoch == 1
    assert_states_equal(other.state, trainer.state)
    assert other.state.w_x.device.type == "cuda"
    ws.reset_launches()
    val = trainer.validate()
    n_batches = -(-(SEQ_LENGTH_TABLE[KITTI_SEQ + 1] - SEQ_LENGTH_TABLE[KITTI_SEQ]) // 2)
    assert ws.launches == {"window_select": 14 * n_batches, "select_and_group": 5 * n_batches}
    assert np.isfinite(val)
    assert (tmp_path / "log" / "val" / "04_pred.txt").exists()
