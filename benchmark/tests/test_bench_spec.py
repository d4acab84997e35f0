"""``BENCHMARK.json`` and the files it names: the characters and sizes its
names, units and lines may have, every file found by name, every per-layer
metric's end-to-end metric reported where it is, the configurations the
program's own, and no JAX anywhere the benchmark runs."""

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in SPEC["workloads"]] + [c["source"] for c in SPEC["configs"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    c = harness.resolve_cell(cell)
    assert (harness.HERE / "drivers" / f"{c.driver}.py").is_file()
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    c = harness.resolve_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_every_metric_names_cells_that_exist_and_every_config_is_used():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)


def test_configurations_are_the_programs():
    from efficientlo_net_torch.config import ModelConfig, sensor_preset

    from benchmark import program

    by_name = {c["name"]: harness.read_json(harness.ROOT / c["file"]) for c in SPEC["configs"]}
    assert program.model_config(by_name["hdl64"]) == ModelConfig()
    assert program.model_config(by_name["os1_64"]) == ModelConfig(sensor=sensor_preset("os1_64"))
    for c in SPEC["configs"]:
        assert by_name[c["name"]]["reduced"] == c["reduced"] == []


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_loaded({"efficientlo_net_torch.ops", "jaxtyping", "flaxen"}) == []
    assert harness.forbidden_loaded({"jax.numpy", "efficientlo_net_tpu.config", "torch"}) == \
        ["efficientlo_net_tpu", "jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_file_imports_jax_and_the_reference_none_of_the_program():
    for path in harness.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN_MODULES), path
        if "reference" in path.relative_to(harness.HERE).parts:
            assert "efficientlo_net_torch" not in tops and "benchmark" not in tops, path


def test_what_a_run_loads_holds_no_jax():
    """Every module of the benchmark and of the program parts it drives,
    imported in a fresh process: no forbidden top-level name appears."""
    code = """
import sys
sys.path.insert(0, {root!r})
from benchmark import harness, program, generate, compare, readers, stretch
from benchmark.reference import net, ops, train, weights
from benchmark.counts import network
for d in ("train_step", "seq_eval"):
    harness.driver_module(d)
import efficientlo_net_torch.training.step, efficientlo_net_torch.training.state
import efficientlo_net_torch.evaluation.runner, efficientlo_net_torch.pretrained
harness.load_file_module(harness.HERE / "run.py", "run")
print(harness.forbidden_loaded())
""".format(root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
