"""Fixtures of the benchmark's CPU tests: the tiny network as a cell of its
own (configuration, weights file, small mixes, the real cells' limits) and
stand-ins for the CUDA calls the drivers make, so a whole run can be driven
on the CPU."""

import dataclasses
import json

import pytest
import torch

from benchmark import harness


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One host thread a test process: the tests run side by side in
    several processes, and torch's thread pools would contend for the
    cores."""
    torch.set_num_threads(1)


class _Event:
    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self, stream=None):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Stream:
    def synchronize(self):
        pass


@pytest.fixture
def cpu_cuda(monkeypatch):
    """The drivers' CUDA calls made harmless on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def tiny_config_dict():
    from efficientlo_net_torch.config import tiny_model_config

    d = dataclasses.asdict(tiny_model_config())
    sensor, dtype = d.pop("sensor"), d.pop("compute_dtype")
    return {"sensor": sensor, "model": d, "compute_dtype": dtype}


@pytest.fixture(scope="session")
def tiny_weights(tmp_path_factory):
    """A seeded tiny network written as a weights file.  Its pose heads are
    damped to near-identity motion: with random heads the tiny network's
    warps are chaotic, and two float orders part after a step."""
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.pretrained import save_pretrained, state_dict_to_variables

    torch.manual_seed(0)
    net = PWCLONet(tiny_model_config())
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "q_head" in name or "t_head" in name:
                p.mul_(0.01)
                if name.endswith("q_head.dense.bias"):
                    p.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
    path = tmp_path_factory.mktemp("weights") / "tiny.msgpack"
    save_pretrained(str(path), state_dict_to_variables(net.state_dict()))
    return path


def tiny_cell(kind, weights, **traffic):
    """The tiny network under a small version of a real cell's mix, with
    that cell's limits."""
    real = {"train": "hdl64.train_b8", "eval": "hdl64.seq_eval_b8"}[kind]
    base = harness.resolve_cell(real)
    config = dict(tiny_config_dict(), weights=str(weights))
    return harness.Cell(name=f"tiny.{kind}", chips=1, config=config,
                        traffic=dict(base.traffic, **traffic), limits=base.limits,
                        end_to_end=base.end_to_end, per_layer=base.per_layer)


@pytest.fixture
def tiny_train_cell(tiny_weights):
    return tiny_cell("train", tiny_weights, batch_size=2, pool=4)


@pytest.fixture
def tiny_eval_cell(tiny_weights):
    return tiny_cell("eval", tiny_weights, batch_size=8, check_frames=6)


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])
