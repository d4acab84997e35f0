"""The port's recorder of spans and counters (``utils/profiling.py``) on the
CPU, with no JAX import.

Off, a span reads its flags and hands back one shared object: no clock, no
``record_function``.  On, spans nest by thread and carry their root's id;
the buffer keeps the newest spans and counts the ones it lets go; under
``torch.profiler`` spans record with no ``enable()``, on the profiler's
clock.  A tiny train step and a streaming sequence evaluation give the span
tree their modules document, each select counted under the span of its
place in the network; ``torch.export`` traces none of it; the select
kernels' launch counters are the recorder's.
"""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import TrainConfig, tiny_model_config
from efficientlo_net_torch.data.synthetic import synthetic_batch, synthetic_pair
from efficientlo_net_torch.evaluation import runner
from efficientlo_net_torch.models.pwclo import PWCLONet
from efficientlo_net_torch.ops import neighbors as nbr
from efficientlo_net_torch.ops import window_select as ws
from efficientlo_net_torch.training.state import create_train_state
from efficientlo_net_torch.training.step import make_streaming_eval_fns, make_train_step
from efficientlo_net_torch.utils import profiling

CFG = tiny_model_config()
MODEL = ["pyramid"] + [f"down_l{i}" for i in range(4)]
CORRELATION = ["correlation", "l3", "cv_origin", "cv_down_l3", "head"] + [
    name for i in range(3)
    for name in (f"refine_l{i}", "warp_project", "cv", "up_w", "up_feat", "head")]
#: the select counts filed under each span that makes selects
FIRST_K, BOTH = {"select.first_k": 1}, {"select.knn": 1, "select.first_k": 1}
SELECTS = {**{f"down_l{i}": FIRST_K for i in range(4)}, "cv_origin": BOTH, "cv": BOTH,
           "cv_down_l3": FIRST_K, "up_w": FIRST_K, "up_feat": FIRST_K}


@pytest.fixture(autouse=True)
def recorder():
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return PWCLONet(CFG)


def _names(spans):
    return collections.Counter(s.name for s in spans)


def _path(s):
    out = []
    while s is not None:
        out.append(s.name)
        s = s.parent
    return "/".join(reversed(out))


def _assert_selects_filed(spans, times):
    """Every span of a select site holds its selects' counts, no other span
    holds any, and the totals are their sum."""
    for s in spans:
        assert s.counts == SELECTS.get(s.name), (_path(s), s.counts)
    total = collections.Counter()
    for name, n in _names(spans).items():
        total.update({k: v * n for k, v in SELECTS.get(name, {}).items()})
    assert profiling.counters() == dict(total)
    assert sum(total.values()) == times


def test_off_records_nothing_and_returns_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("read while off")

    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("a", id=3) as a:
        with profiling.span("b") as b:
            profiling.count("n", 2)
    assert a is b is profiling.OFF
    assert profiling.spans() == []
    assert profiling.counters() == {"n": 2}


def test_on_nests_parents_and_inherits_the_request_id_by_thread():
    profiling.enable()
    started = threading.Barrier(2)

    def worker(rid):
        with profiling.span("root", id=rid):
            started.wait()
            with profiling.span("child"):
                with profiling.span("leaf"):
                    profiling.count("hits")
            with profiling.span("other", id="own"):
                pass

    threads = [threading.Thread(target=worker, args=(rid,)) for rid in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = profiling.spans()
    assert _names(spans) == {"root": 2, "child": 2, "leaf": 2, "other": 2}
    roots = {s.thread: s for s in spans if s.name == "root"}
    assert {r.id for r in roots.values()} == {7, 8} and len(roots) == 2
    for s in spans:
        root = roots[s.thread]
        if s.name == "leaf":
            assert s.parent.name == "child" and s.parent.thread == s.thread
            assert s.counts == {"hits": 1}
        else:
            assert s.parent is {"root": None, "child": root, "other": root}[s.name]
        assert s.id == ("own" if s.name == "other" else root.id)
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert profiling.counters() == {"hits": 2}


def test_counts_from_many_threads_lose_no_update():
    """More threads than cores count at once, the interpreter switching
    threads as often as it can: every count arrives."""
    threads, per_thread = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def counting():
            for _ in range(per_thread):
                profiling.count("n")

        workers = [threading.Thread(target=counting) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counters() == {"n": threads * per_thread}


def test_buffer_drops_the_oldest_spans_and_counts_the_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    profiling.enable()
    for i in range(7):
        with profiling.span("s", id=i):
            pass
    assert [s.id for s in profiling.spans()] == [3, 4, 5, 6]
    assert profiling.counters()[profiling.DROPPED] == 3


def test_spans_record_under_the_profiler_on_its_clock():
    """No ``enable()``: a CPU profile turns recording on.  Each span's
    stamps lie inside its ``record_function`` event of the profile."""
    with profiling.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span("clock.outer", id=i):
                torch.ones(32, 32) @ torch.ones(32, 32)
                with profiling.span("clock.inner"):
                    torch.ones(8) + 1
    with profiling.span("after"):
        pass
    spans = profiling.spans()
    assert _names(spans) == {"clock.outer": 3, "clock.inner": 3}
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    slack = 50_000
    for s in spans:
        assert any(a - slack <= s.start_ns <= s.end_ns <= b + slack
                   for a, b in events[s.name]), s.name


def test_train_step_yields_the_span_tree_and_counts_selects_by_site(model):
    tcfg = TrainConfig(batch_size=2)
    state = create_train_state(model, tcfg, device="cpu")
    batch = synthetic_batch(np.random.default_rng(0), 2, CFG.sensor, training=True)
    profiling.enable()
    make_train_step(CFG, tcfg)(state, batch, torch.Generator().manual_seed(0))
    spans = profiling.spans()
    (step,) = [s for s in spans if s.name == "train.step"]
    assert step.parent is None and step.id == 0
    stages = ["train.inputs", "train.forward", "train.loss", "train.backward",
              "train.optimizer"]
    assert [s.name for s in spans if s.parent is step] == stages
    names = _names(spans)
    assert names == collections.Counter(["train.step"] + stages + MODEL * 2 + CORRELATION)
    assert {_path(s) for s in spans if s.name == "down_l2"} == \
        {"train.step/train.forward/pyramid/down_l2"}
    assert {s.id for s in spans} == {0}
    _assert_selects_filed(spans, 23)


def test_streaming_eval_yields_the_span_tree(model, monkeypatch):
    """Ten frames in batches of four: three batches, each read by the
    reader thread, its id its first frame."""
    monkeypatch.setattr(runner, "sequence_indices", lambda seq: np.arange(10))
    rng = np.random.default_rng(1)
    scans = [synthetic_pair(rng, CFG.sensor)[0] for _ in range(10)]

    class Drive:
        def read_scan(self, seq, frame):
            return scans[frame]

    encode, correlate = make_streaming_eval_fns(CFG)
    profiling.enable()
    q, _ = runner.predict_sequence_streaming(encode, correlate, model.eval(), Drive(), 4,
                                             batch_size=4, num_workers=1)
    assert q.shape == (10, 4)
    spans = profiling.spans()
    batches = [s for s in spans if s.name == "eval.batch"]
    assert [b.id for b in batches] == [0, 4, 8]
    for b in batches:
        assert [s.name for s in spans if s.parent is b] == [
            "eval.wait_scans", "eval.to_device", "eval.encode", "eval.splice",
            "eval.correlate", "eval.poses_to_host"]
    reads = [s for s in spans if s.name == "eval.read_block"]
    assert sorted(s.id for s in reads) == [0, 4, 8]
    assert all(s.parent is None and s.thread != batches[0].thread for s in reads)
    assert {_path(s) for s in spans if s.name == "down_l0"} == \
        {"eval.batch/eval.encode/pyramid/down_l0"}
    assert {_path(s) for s in spans if s.name == "up_feat"} == \
        {f"eval.batch/eval.correlate/correlation/refine_l{i}/up_feat" for i in range(3)}
    _assert_selects_filed(spans, 3 * 19)


@pytest.mark.parametrize("on", [False, True])
def test_export_traces_no_span(model, on):
    """The tower, the part of the network with spans at every level, traced
    by ``torch.export`` as ``serving/export.py`` does: recording on or off,
    the graph holds the same operations and no profiler call, and no span
    is recorded."""

    class Tower(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, img):
            return self.net._pyramid(img)[-1][1]

    img = torch.randn(1, CFG.sensor.height, CFG.sensor.width, 3)
    profiling.enable(on)
    with nbr.plain_selects():
        exported = torch.export.export(Tower(model.eval()), (img,), strict=False)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert len(targets) > 100
    assert profiling.spans() == []


def test_launch_counters_are_the_recorders():
    profiling.count("launch.window_select", 3)
    profiling.count("select.first_k")
    assert ws.launches == {"window_select": 3, "select_and_group": 0}
    assert dict(ws.launches) == {"window_select": 3, "select_and_group": 0}
    ws.reset_launches()
    assert ws.launches == {"window_select": 0, "select_and_group": 0}
    assert profiling.counters() == {"select.first_k": 1}
    with pytest.raises(KeyError):
        ws.launches["other"]
