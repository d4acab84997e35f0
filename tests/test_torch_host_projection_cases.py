"""Behaviour of the port's host-projection slice and its profiling module,
on torch alone (no JAX), and card cases.

The native library's build (into ``efficientlo_net_torch/_build/``, never
into ``native/``; a failing compiler raises), the tri-state
``TrainConfig.host_projection``, the host-projected stream's refusal
without the library, a host-projected trainer with exact resume, and
``utils/profiling``.  The ``cuda`` cases need a card and skip without one:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_host_projection_cases.py
"""

import dataclasses
import json
import os
import stat

import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import SensorConfig, TrainConfig, tiny_model_config
from efficientlo_net_torch.data import native_io
from efficientlo_net_torch.data.synthetic import random_scene, synthetic_pair
from efficientlo_net_torch.evaluation.streaming import OdometryStream
from efficientlo_net_torch.models.pwclo import PWCLONet
from efficientlo_net_torch.ops.projection import project_to_range_image
from efficientlo_net_torch.training.trainer import Trainer
from efficientlo_net_torch.utils.profiling import StepTimer, annotate, trace
# bare name: a machine may have an unrelated "tests" package installed
from torch_cases import KITTI_SEQ, build_fake_kitti

CFG = tiny_model_config()
TCFG = TrainConfig(batch_size=2, host_projection=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fresh_library(tmp_path, monkeypatch):
    """Reset the binding's state and move its build directory to
    ``tmp_path``, so that the next call builds anew; restored after the
    test."""
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_io, "_state", {"probed": False, "lib": None})
    return tmp_path / "_build"


def _tree_listing(path):
    return sorted((p, os.stat(os.path.join(path, p)).st_mtime_ns) for p in os.listdir(path))


def test_library_builds_under_build_dir_and_not_in_native(tmp_path, monkeypatch):
    package = os.path.dirname(os.path.dirname(os.path.abspath(native_io.__file__)))
    assert str(native_io.BUILD_DIR) == os.path.join(package, "_build")
    native_dir = native_io.SOURCE.parent
    before = _tree_listing(native_dir)
    fresh = fresh_library(tmp_path, monkeypatch)
    assert native_io.available() and native_io.fused_available()
    assert native_io.abi_version() == 3
    built = native_io.library_path()
    assert built.parent == fresh and built.exists()
    assert [p.name for p in fresh.iterdir()] == [built.name]  # no temporary left
    assert _tree_listing(native_dir) == before


def test_broken_compiler_raises_with_its_output(tmp_path, monkeypatch):
    fresh = fresh_library(tmp_path, monkeypatch)
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake-cxx: internal error' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="fake-cxx: internal error"):
        native_io.available()
    assert not fresh.exists() or not list(fresh.iterdir())
    # no compiler at all: the numpy twins serve
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native_io.available() and not native_io.fused_available()
    path = tmp_path / "scan.bin"
    np.arange(40, dtype=np.float32).reshape(10, 4).tofile(path)
    np.testing.assert_array_equal(native_io.read_scan(str(path), 12)[:10],
                                  np.arange(40, dtype=np.float32).reshape(10, 4)[:, :3])
    with pytest.raises(RuntimeError, match="ABI"):
        native_io.augment_project_batch_native(np.zeros((1, 4, 3), np.float32),
                                               np.eye(4)[None], np.ones(1), 4, 8, SensorConfig())


def test_resolved_host_projection(monkeypatch):
    assert TrainConfig(host_projection=True).resolved_host_projection() is True
    assert TrainConfig(host_projection=False).resolved_host_projection() is False
    for available in (True, False):
        monkeypatch.setattr(native_io, "available", lambda: available)
        assert TrainConfig().host_projection is None
        assert TrainConfig().resolved_host_projection() is available
    monkeypatch.setattr(native_io, "available", lambda: pytest.fail("asked the library"))
    assert TrainConfig(host_projection=False).resolved_host_projection() is False


def test_host_projected_stream_needs_the_library(monkeypatch):
    monkeypatch.setattr(native_io, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library"):
        OdometryStream(PWCLONet(CFG), CFG, device="cpu", host_projection=True)
    OdometryStream(PWCLONet(CFG), CFG, device="cpu")  # device projection needs none


def test_host_projected_stream_projects_on_the_host():
    """The stream's image is the native projector's exact image of the
    cropped scan, and its poses are finite."""
    torch.manual_seed(0)
    stream = OdometryStream(PWCLONet(CFG), CFG, device="cpu", host_projection=True)
    s = CFG.sensor
    for scan in synthetic_pair(np.random.default_rng(1), s)[:2]:
        q, t = stream.push(scan)
        assert np.all(np.isfinite(q)) and np.all(np.isfinite(t))
        want = native_io.project_scan(scan, s.height, s.width, s, crop_radius=s.max_planar_radius)
        np.testing.assert_array_equal(stream.last_projection[0].numpy(), want)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    scene = random_scene(np.random.default_rng(0), 4096, CFG.sensor)
    return build_fake_kitti(tmp_path_factory.mktemp("kitti"), scene, CFG.sensor.num_points)[:2]


def _trainer(tree, log_dir, tcfg=TCFG, device="cpu"):
    root, gt_dir = tree
    return Trainer(CFG, tcfg, data_root=root, log_dir=str(log_dir), gt_dir=gt_dir,
                   train_list=[KITTI_SEQ], val_list=[KITTI_SEQ], device=device)


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update(w_x=state.w_x.detach(), w_q=state.w_q.detach())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def test_host_projected_trainer_trains_and_resumes_exactly(tree, tmp_path):
    """2 batches of epoch 0, save, 2 of epoch 1; a fresh trainer restores
    and takes the same 2 batches of epoch 1 to the same state, bit for bit."""
    run = _trainer(tree, tmp_path / "run")
    assert run.host_projection
    seen = []
    step = run.train_step
    run.train_step = lambda state, batch, gen: (seen.append(batch), step(state, batch, gen))[1]
    assert np.isfinite(run.train_one_epoch(0, limit_batches=2))
    run.train_step = step
    assert run.state.step == 2
    h, w = CFG.sensor.height, CFG.sensor.width
    assert all(b["p1"].shape == (2, h, w, 3) and "pc1" not in b for b in seen)
    run.ckpt.save(run.state, epoch=0)
    run.train_one_epoch(1, limit_batches=2)

    resumed = _trainer(tree, tmp_path / "resumed")
    resumed.restore(path=str(tmp_path / "run" / "checkpoints"))
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train_one_epoch(1, limit_batches=2)
    assert resumed.state.step == 4
    want, got = _tensors(run.state), _tensors(resumed.state)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_host_projected_trainer_quantizes_images(tree, tmp_path):
    trainer = _trainer(tree, tmp_path / "log",
                       tcfg=dataclasses.replace(TCFG, quantized_transfer=True))
    seen = []
    step = trainer.train_step
    trainer.train_step = lambda state, batch, gen: (seen.append(batch), step(state, batch, gen))[1]
    assert np.isfinite(trainer.train_one_epoch(0, limit_batches=1))
    (batch,) = seen
    assert batch["p1"].dtype == batch["p2"].dtype == torch.int16
    assert batch["T_gt"].dtype == torch.float32


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("elo_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "elo_region" for e in events)
    assert any(e.key == "elo_region" for e in prof.key_averages())


def test_step_timer_records_its_history():
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        assert timer.stop(sync=torch.zeros(1)) >= 0.0  # a CPU tensor: nothing to wait for
    assert len(timer.history) == 3
    assert timer.mean == pytest.approx(sum(timer.history) / 3)
    assert StepTimer().mean == 0.0


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exact_projections_on_the_card(card):
    """``sort`` equals ``scatter`` on the card bit for bit, and the card's
    ``sort`` the CPU's but for atan2 / asin ulps at pixel borders."""
    s = SensorConfig()
    rng = np.random.default_rng(2)
    pts = torch.as_tensor(np.stack([synthetic_pair(rng, s)[0] for _ in range(2)]))
    feats = torch.randn(pts.shape[:2] + (4,), generator=torch.Generator().manual_seed(0))
    img, feat = project_to_range_image(pts.to(card), feats.to(card), s.height, s.width, s)
    img_s, feat_s = project_to_range_image(pts.to(card), feats.to(card), s.height, s.width, s,
                                           method="scatter")
    assert torch.equal(img, img_s) and torch.equal(feat, feat_s)
    cpu, _ = project_to_range_image(pts, None, s.height, s.width, s)
    differs = torch.any(img.cpu() != cpu, dim=-1).float().mean().item()
    assert differs <= 1e-3, differs


@pytest.mark.cuda
def test_tiny_host_projected_trainer_on_the_card(card, tree, tmp_path):
    from efficientlo_net_torch.ops import window_select as ws

    trainer = _trainer(tree, tmp_path / "log", device="cuda")
    assert trainer.host_projection
    ws.reset_launches()
    trainer.train_one_epoch(0, limit_batches=2)
    assert trainer.state.step == 2
    assert ws.launches == {"window_select": 46, "select_and_group": 0}
    assert all(torch.isfinite(p).all() for p in trainer.state.parameters())
