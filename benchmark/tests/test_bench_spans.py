"""The program's spans and counters as the benchmark reads them: the select
calls the program files under its spans are ``counts/network.py``'s sites,
by name; each span metric reads None from an empty recorder, or from a
program without one, and its number from a recorder of known spans; and a
traced run on the CPU reports the span metrics of its cell."""

import collections
import types

import pytest

from benchmark import harness
from benchmark.counts import network as counts
from benchmark.tests.conftest import tiny_config_dict
from benchmark.tests.test_bench_counts import _eval_batch, _train_step, tiny_program  # noqa: F401
from benchmark.tests.test_bench_run import measure

SPAN_METRICS = {
    "eval": ["eval_wait_scans_ms", "eval_to_device_ms", "eval_encode_host_ms",
             "eval_correlate_host_ms"],
    "train": ["train_inputs_host_ms", "train_optimizer_host_ms"],
}
PER_KERNEL = {"train": "host_us_per_kernel.train", "eval": "host_us_per_kernel.eval"}


@pytest.fixture
def recorder():
    from efficientlo_net_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _sites(spans):
    """``counts/network.py``'s name of each select the program counted: the
    span the count is filed under, its level's span and the select's mode
    (a cost volume's KNN stage and its first-K self stage); training's two
    towers are the frames of the step."""
    towers = collections.defaultdict(list)
    for s in spans:
        if s.name == "pyramid":
            towers[id(s.parent)].append(s)
    sites = collections.Counter()
    for s in spans:
        for key, n in (s.counts or {}).items():
            mode = key[len("select."):]
            level = s.parent.name[len("refine_"):] if s.parent else ""
            if s.name.startswith("down_l"):
                tower = towers[id(s.parent.parent)]
                frame = [t is s.parent for t in tower].index(True) + 1
                name = s.name + (f".frame{frame}" if len(tower) > 1 else "")
            elif s.name in ("cv_origin", "cv"):
                stage = "knn" if mode == "knn" else "self"
                name = f"cv_origin.{stage}" if s.name == "cv_origin" else f"cv.{stage}_{level}"
            elif s.name in ("up_w", "up_feat"):
                name = f"{s.name}_{level}"
            else:
                name = s.name
            sites[name] += n
    return dict(sites)


@pytest.mark.parametrize("training", [True, False])
def test_select_counts_by_site_are_the_counted_sites(tiny_program, recorder,  # noqa: F811
                                                     training):
    sites = counts.select_sites(tiny_config_dict(), 2, training=training)
    recorder.enable()
    if training:
        _train_step(tiny_program, 2)
    else:
        # the previous frames' tower is the batch before's: counted there
        _eval_batch(tiny_program, 2, between=recorder.reset)
    assert _sites(recorder.spans()) == {s.name: 1 for s in sites}
    assert len(sites) == (23 if training else 19)


def _span(name, start_ms, end_ms):
    return types.SimpleNamespace(name=name, start_ns=int(start_ms * 1e6),
                                 end_ns=int(end_ms * 1e6))


def _ctx(kind, kernels=1000, steps=2):
    return {"kind": kind, "trace": {"kernels": kernels, "steps": steps}}


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_span_readers_read_none_without_spans(recorder, monkeypatch, kind):
    names = SPAN_METRICS[kind] + [PER_KERNEL[kind]]
    assert all(harness.metric_reader(n)(_ctx(kind)) is None for n in names)
    # a program whose recorder has no spans to give (one before them)
    monkeypatch.delattr(recorder, "spans")
    assert all(harness.metric_reader(n)(_ctx(kind)) is None for n in names)


def test_span_readers_read_known_spans(recorder, monkeypatch):
    known = [_span("eval.wait_scans", 0, 3), _span("eval.wait_scans", 10, 15),
             _span("eval.to_device", 3, 4), _span("eval.encode", 4, 12),
             _span("eval.splice", 12, 12.5), _span("eval.correlate", 12.5, 40),
             _span("eval.correlate", 50, 80.5),
             _span("train.inputs", 0, 6), _span("train.optimizer", 0, 2),
             _span("train.optimizer", 0, 4), _span("train.step", 0, 150),
             _span("train.step", 0, 170)]
    monkeypatch.setattr(recorder, "spans", lambda: list(known))
    read = {n: harness.metric_reader(n) for k in SPAN_METRICS for n in SPAN_METRICS[k]}
    assert read["eval_wait_scans_ms"](_ctx("eval")) == pytest.approx(4.0)
    assert read["eval_to_device_ms"](_ctx("eval")) == pytest.approx(1.0)
    assert read["eval_encode_host_ms"](_ctx("eval")) == pytest.approx(8.0)
    assert read["eval_correlate_host_ms"](_ctx("eval")) == pytest.approx(29.0)
    assert read["train_inputs_host_ms"](_ctx("train")) == pytest.approx(6.0)
    assert read["train_optimizer_host_ms"](_ctx("train")) == pytest.approx(3.0)
    # a step of 160 ms over 8000 / 2 kernels; a batch of 8 + 0.5 + 29 ms over 1500
    assert harness.metric_reader(PER_KERNEL["train"])(_ctx("train", 8000, 2)) == \
        pytest.approx(40.0)
    assert harness.metric_reader(PER_KERNEL["eval"])(_ctx("eval", 15000, 10)) == \
        pytest.approx(25.0)
    # the other kind's spans, or a stretch without kernels, read nothing
    assert read["train_inputs_host_ms"](_ctx("eval")) is None
    assert harness.metric_reader(PER_KERNEL["eval"])(_ctx("eval", 0, 10)) is None
    assert harness.metric_reader(PER_KERNEL["train"])({"kind": "train", "trace": None}) is None


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_traced_cpu_run_reports_the_span_metrics(cpu_cuda, tiny_train_cell, tiny_eval_cell,
                                                 capsys, monkeypatch, recorder, kind):
    """The profiled stretch records the host on the CPU, so the spans are
    on there as they are on the card; with no kernel, the per-kernel
    metrics are left out."""
    import torch

    from benchmark import stretch

    monkeypatch.setattr(stretch, "activities", lambda: [torch.profiler.ProfilerActivity.CPU])
    cell = tiny_train_cell if kind == "train" else tiny_eval_cell
    line = measure(cell, capsys, trace=1, seconds=3.0 if kind == "train" else 4.0)
    assert line["correct"] is True
    values = {n: line["metrics"][n]["value"] for n in SPAN_METRICS[kind]}
    assert all(v > 0 for v in values.values()), values
    assert PER_KERNEL[kind] not in line["metrics"]
    # the recorder held the stretch's spans alone: the train stretch's
    # three steps
    if kind == "train":
        steps = [s for s in recorder.spans() if s.name == "train.step"]
        assert len(steps) == cell.traffic["profile_steps"]
