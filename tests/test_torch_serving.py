"""The port's serving surface against the JAX package, on the CPU.

* Both ``efficientlo::`` operators pass ``torch.library.opcheck`` and, on
  CPU tensors, equal the plain versions exactly.
* The portable export artifact (``export_odometry(device="cpu")``) holds no
  custom operator, saves, loads (also in a bare PyTorch process) and gives
  ``make_infer_fn``'s poses within atol 1e-5; far points beyond the planar
  crop do not move them (the JAX package's tests/test_export.py); and
  ``make_infer_fn`` gives the JAX package's ``make_infer_fn`` poses on the
  same weights within atol 1e-4 (float32 sums in another order; near-identity
  pose heads, as in tests/test_torch_model.py).
* The weight writer: the port's file is the JAX package's file byte for
  byte, the JAX package reads it to the same arrays and meta, the port reads
  the JAX package's file to the same arrays, and the port's round trip is
  exact; ``variables_from_train_state`` and the Flax layout of
  ``state_dict_to_variables``.
* Sensor presets, ``ModelConfig`` defaults and ``validate``; the CLI's flags
  and defaults parse as the JAX package's, and ``--coordinator`` joins a
  process group (tests/test_torch_parallel.py runs it on two ranks);
  ``evaluate_cli`` prints and writes what the
  JAX package's does; ``write_all_plots`` writes the same files, and
  ``evaluate_sequences(make_plots=True)`` writes them per sequence.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from efficientlo_net_torch import cli as TCli
from efficientlo_net_torch import config as TC
from efficientlo_net_torch import pretrained as TPre
from efficientlo_net_torch.evaluation import evaluate_cli as TEval
from efficientlo_net_torch.evaluation import plots as TPlots
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_torch.ops import neighbors as TN
from efficientlo_net_torch.ops import window_select as TWS
from efficientlo_net_torch.serving import export as TX
from efficientlo_net_tpu import cli as JCli
from efficientlo_net_tpu import config as JC
from efficientlo_net_tpu import pretrained as JPre
from efficientlo_net_tpu.evaluation import evaluate_cli as JEval
from efficientlo_net_tpu.evaluation import plots as JPlots
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.serving.export import make_infer_fn as j_make_infer_fn
from tests.test_model import synthetic_scan
from tests.torch_cases import (GROUP_CASES, MODES, SELECT_CASES, build_fake_kitti, group_inputs,
                               select_inputs)
from tests.torch_parity import near_identity_heads, randomize_batch_stats, t

CFG = TC.tiny_model_config()
ARTIFACT = Path(__file__).resolve().parents[1] / "pretrained" / "synthetic_drive_50ep.msgpack"
EXPORT_ATOL = 1e-5
POSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers run at once: one intra-op thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the operators ---------------------------------------------------------------

def _select_args(case, mode, with_perm):
    g1, g2, ks, k, dist, cs, ss, perm = select_inputs(case, with_perm)
    return (t(g1), t(g2), list(ks), k, dist, list(cs), list(ss), mode,
            None if perm is None else torch.as_tensor(perm))


def _group_args(case):
    xyz, feats, ks, k, dist, cs, mode = group_inputs(case)
    return t(xyz), t(feats), list(ks), k, dist, list(cs), mode, None


@pytest.mark.parametrize("op", ["window_select", "select_and_group"])
def test_opcheck(op):
    args = (_select_args("centre_stride", "first_k", True) if op == "window_select"
            else _group_args("c64_k32"))
    torch.library.opcheck(getattr(TWS, f"{op}_op"), args)


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_window_select_op_on_cpu_equals_plain(case, mode, with_perm):
    args = _select_args(case, mode, with_perm)
    got = torch.ops.efficientlo.window_select(*args)
    want = TN.select_neighbors_plain(*args)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_select_and_group_op_on_cpu_equals_plain(case):
    args = _group_args(case)
    got = torch.ops.efficientlo.select_and_group(*args)
    for g, w in zip(got, TN.select_and_group_plain(*args)):
        assert torch.equal(g, w)


def test_network_calls_the_operators_unless_plain_selects():
    """Every select of the eval forward goes through the operators: 14
    ``window_select`` and 5 ``select_and_group`` calls; inside
    ``plain_selects()`` none does, and the poses are the same."""
    calls = []
    tracked = {}
    for name in ("window_select", "select_and_group"):
        op = getattr(torch.ops.efficientlo, name)
        tracked[name] = op

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return tracked[name]

    torch.manual_seed(0)
    model = TNet(CFG).eval()
    p1, p2 = _images(2)
    real = TN._ops
    TN._ops = Spy
    try:
        with torch.no_grad():
            out = model(p1, p2)
            assert calls.count("window_select") == 14 and calls.count("select_and_group") == 5
            del calls[:]
            with TN.plain_selects():
                plain = model(p1, p2)
            assert not calls
    finally:
        TN._ops = real
    for key in ("q", "t"):
        for a, b in zip(out[key], plain[key]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_plain_selects_refuses_cuda_tensors(fused):
    """``plain_selects()`` is for the CPU export only: a select on a CUDA
    tensor inside it raises instead of skipping the kernel (a fake CUDA
    tensor stands in for one here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        xyz = torch.zeros(1, 4, 8, 3, device="cuda")
        with TN.plain_selects(), pytest.raises(RuntimeError, match="CPU only"):
            if fused:
                TN.select_and_group(xyz, xyz, (3, 3), 4, 1.0, fused=True)
            else:
                TN.select_neighbors(xyz, xyz, (3, 3), 4, 1.0)


# ---- export ---------------------------------------------------------------------

def _scans(seed=0, n=1):
    rng = np.random.default_rng(seed)
    pc1 = np.stack([synthetic_scan(rng, CFG.sensor.num_points) for _ in range(n)])
    pc2 = np.stack([synthetic_scan(rng, CFG.sensor.num_points) for _ in range(n)])
    return pc1, pc2


def _images(seed):
    from efficientlo_net_torch.ops.projection import crop_and_project

    return [crop_and_project(t(pc), CFG.sensor) for pc in _scans(seed)]


@pytest.fixture(scope="module")
def weights():
    """A random tiny network's weights in the Flax layout (randomized batch
    statistics, near-identity heads) and the port's network with them."""
    torch.manual_seed(0)
    variables = TPre.state_dict_to_variables(TNet(CFG).state_dict())
    variables = randomize_batch_stats(variables)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": near_identity_heads(variables["params"]),
        "batch_stats": variables["batch_stats"]})
    model = TNet(CFG)
    model.load_state_dict(TPre.variables_to_state_dict(variables), strict=True)
    return variables, model.eval()


def test_portable_artifact_round_trip(weights, tmp_path):
    _, model = weights
    exported = TX.export_odometry(model, CFG, batch_size=1, device="cpu")
    targets = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert not [x for x in targets if "efficientlo" in x]
    path = TX.save_artifact(str(tmp_path / "odom"), exported)
    assert path.endswith(".pt2")
    pc1, pc2 = _scans(1)

    # a bare PyTorch process, with no module of this repository importable,
    # loads the file while this one does
    np.save(tmp_path / "pc1.npy", pc1)
    np.save(tmp_path / "pc2.npy", pc2)
    script = (
        "import sys, numpy as np, torch\n"
        f"m = torch.export.load({path!r}).module()\n"
        "with torch.no_grad():\n"
        "    q, t = m(torch.from_numpy(np.load('pc1.npy')), torch.from_numpy(np.load('pc2.npy')))\n"
        "np.save('q.npy', q.numpy())\n"
        "assert not any(m.startswith('efficientlo') for m in sys.modules)\n")
    bare = subprocess.Popen([sys.executable, "-I", "-c", script], cwd=tmp_path)
    try:
        _, call = TX.load_odometry(path)
        q_x, t_x = call(pc1, pc2)
        with torch.no_grad():
            q_d, t_d = TX.make_infer_fn(model, CFG)(t(pc1), t(pc2))
        assert bare.wait(timeout=300) == 0
    finally:
        bare.kill()
    np.testing.assert_allclose(q_x.numpy(), q_d.numpy(), atol=EXPORT_ATOL)
    np.testing.assert_allclose(t_x.numpy(), t_d.numpy(), atol=EXPORT_ATOL)
    np.testing.assert_allclose(np.linalg.norm(q_x.numpy(), axis=-1), 1.0, atol=1e-5)
    # (its intra-op threads may sum in another order)
    np.testing.assert_allclose(np.load(tmp_path / "q.npy"), q_x.numpy(), atol=EXPORT_ATOL)


def test_infer_fn_matches_jax(weights):
    variables, model = weights
    pc1, pc2 = _scans(2, n=2)
    q_j, t_j = jax.jit(j_make_infer_fn(JNet(JC.tiny_model_config()), JC.tiny_model_config(),
                                       variables))(pc1, pc2)
    with torch.no_grad():
        q, t_ = TX.make_infer_fn(model, CFG)(t(pc1), t(pc2))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=POSE_ATOL)
    np.testing.assert_allclose(t_.numpy(), np.asarray(t_j), atol=POSE_ATOL)


def test_infer_fn_crops_like_streaming(weights):
    """Far points beyond the planar radius do not change the output: the
    inference function crops as the stream and the trainer do."""
    _, model = weights
    pc1, pc2 = _scans(0)

    def base_and_spiked(pc, rng):
        base = pc.copy()
        base[0, -32:] = 0.0
        far = rng.uniform(CFG.sensor.max_planar_radius * 1.5,
                          CFG.sensor.max_planar_radius * 2.0, size=(32, 3)).astype(np.float32)
        far[:, 2] = rng.uniform(-1.0, 1.0, size=32)
        spiked = base.copy()
        spiked[0, -32:] = far
        return base, spiked

    rng = np.random.default_rng(7)
    b1, s1 = base_and_spiked(pc1, rng)
    b2, s2 = base_and_spiked(pc2, rng)
    infer = TX.make_infer_fn(model, CFG)
    with torch.no_grad():
        q0, t0 = infer(t(b1), t(b2))
        q1, t1 = infer(t(s1), t(s2))
    np.testing.assert_allclose(q1.numpy(), q0.numpy(), atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=1e-6)


# ---- the weight writer -------------------------------------------------------------

def _leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _assert_same_arrays(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_writer_matches_jax_writer_and_reader(weights, tmp_path):
    variables, _ = weights
    meta = {"trained_epochs": 3, "note": "test", "val_t_rel": 1.25}
    port_path, jax_path = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    size = TPre.save_pretrained(str(port_path), variables, meta=meta)
    assert size == port_path.stat().st_size
    JPre.save_pretrained(str(jax_path), variables, meta=meta)
    assert port_path.read_bytes() == jax_path.read_bytes()

    loaded, got_meta = JPre.load_pretrained(str(port_path))
    assert got_meta == dict(meta, format_version=1, param_count=sum(
        a.size for a in _leaves(variables["params"]).values()))
    _assert_same_arrays(loaded, variables)
    port_loaded, port_meta = TPre.load_pretrained(str(jax_path))
    assert port_meta == got_meta
    _assert_same_arrays(port_loaded, variables)
    again, _ = TPre.load_pretrained(str(port_path))
    _assert_same_arrays(again, variables)


def test_writer_demotes_float64_and_needs_params(tmp_path):
    path = str(tmp_path / "w.msgpack")
    TPre.save_pretrained(path, {"params": {"a": np.arange(3.0)}, "other": {"b": 1}})
    loaded, meta = TPre.load_pretrained(path)
    assert set(loaded) == {"params"} and loaded["params"]["a"].dtype == np.float32
    assert meta["param_count"] == 3
    with pytest.raises(ValueError, match="params"):
        TPre.save_pretrained(path, {"batch_stats": {}})


def test_state_dict_to_variables_inverts_the_bridge():
    variables, _ = TPre.load_pretrained(str(ARTIFACT))
    state_dict = TPre.variables_to_state_dict(variables)
    _assert_same_arrays(TPre.state_dict_to_variables(state_dict), variables)


def test_variables_from_train_state(weights, tmp_path):
    from efficientlo_net_torch.training.state import create_train_state

    variables, model = weights
    state = create_train_state(model, TC.TrainConfig(batch_size=2), device="cpu")
    got = TPre.variables_from_train_state(state)
    assert set(got) == {"params", "batch_stats"}
    assert "w_x" not in got["params"] and "w_q" not in got["params"]
    _assert_same_arrays(got, variables)
    # written and read back, it drives a fresh network to the same poses
    path = str(tmp_path / "state.msgpack")
    TPre.save_pretrained(path, got)
    loaded, _ = TPre.load_model(path, CFG, device="cpu")
    p1, p2 = _images(3)
    with torch.no_grad():
        a, b = state.model.eval()(p1, p2), loaded(p1, p2)
    for key in ("q", "t"):
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))


# ---- configuration and CLIs --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JC.SENSOR_PRESETS))
def test_sensor_presets_match_jax(name):
    assert dataclasses.asdict(TC.sensor_preset(name)) == dataclasses.asdict(
        JC.sensor_preset(name))
    assert TC.sensor_preset(name).vertical_resolution == JC.sensor_preset(name).vertical_resolution


def test_unknown_sensor_preset_raises_as_jax():
    with pytest.raises(ValueError) as got:
        TC.sensor_preset("hdl128")
    with pytest.raises(ValueError) as want:
        JC.sensor_preset("hdl128")
    assert str(got.value) == str(want.value)


def test_model_config_defaults_and_validate_match_jax():
    got, want = dataclasses.asdict(TC.ModelConfig()), dataclasses.asdict(JC.ModelConfig())
    assert got == want and got["compute_dtype"] == "float32"
    TC.ModelConfig().validate()
    TC.tiny_model_config().validate()


CLI_ARGVS = {
    "defaults": [],
    "extras": ["--mode", "test", "--sensor", "vlp16", "--compute_dtype", "bfloat16",
               "--no_mesh", "--coordinator", "host0:1234", "--host_projection"],
    "no_host_projection": ["--no_host_projection"],
    "lists": ["--train_list", "0", "2", "--val_list", "9", "--test_list", "4",
              "--batch_size", "4", "--optimizer", "momentum", "--learning_rate", "0.01",
              "--pretrained", "w.msgpack", "--checkpoint_path", "ckpt",
              "--quantized_transfer"],
}


@pytest.mark.parametrize("argv", sorted(CLI_ARGVS))
def test_cli_parses_as_jax(argv):
    got = vars(TCli.build_parser().parse_args(CLI_ARGVS[argv]))
    want = vars(JCli.build_parser().parse_args(CLI_ARGVS[argv]))
    assert got.pop("device") == "cuda"  # the port's explicit device
    assert got == want


def test_cli_coordinator_raises_until_parallelism(tmp_path, monkeypatch):
    """``--coordinator`` no longer raises: since the parallelism slice it
    joins a process group (here one gloo rank on 127.0.0.1) and hands
    ``use_mesh`` to the trainer (a stub here), ``--no_mesh`` turning it off."""
    import torch.distributed as dist

    from efficientlo_net_torch.training import trainer as TTrainer
    from torch_parallel_cases import free_port

    seen = []

    class StubTrainer:
        def __init__(self, *args, **kwargs):
            seen.append((dist.is_initialized() and dist.get_world_size(), kwargs["use_mesh"]))

        def fit(self):
            pass

    monkeypatch.setattr(TTrainer, "Trainer", StubTrainer)
    for extra in ([], ["--no_mesh"]):
        try:
            TCli.main(["--coordinator", f"127.0.0.1:{free_port()}", "--device", "cpu",
                       "--log_dir", str(tmp_path / "log")] + extra)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    assert seen == [(1, True), (1, False)]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A fake KITTI sequence's ground truth and a noisy trajectory of it."""
    base = tmp_path_factory.mktemp("seq")
    scene = np.zeros((8, 3), dtype=np.float32)
    _, gt_dir, _ = build_fake_kitti(base, scene, 8)
    rows = np.loadtxt(Path(gt_dir) / "04.txt")
    rng = np.random.default_rng(5)
    noisy = rows + rng.normal(0.0, 0.02, rows.shape) * np.tile([0, 0, 0, 1], 3)
    return gt_dir, noisy


@pytest.mark.parametrize("camera", [False, True])
def test_evaluate_cli_matches_jax(scored, tmp_path, capsys, camera):
    gt_dir, noisy = scored
    outs = {}
    for name, main in (("port", TEval.main), ("jax", JEval.main)):
        result = tmp_path / name
        result.mkdir()
        np.savetxt(result / "04_pred.txt", noisy)
        argv = ["--result_dir", str(result), "--gt_dir", gt_dir, "--eva_seqs", "04_pred"]
        assert main(argv + (["--toCameraCoord"] if camera else [])) == 0
        outs[name] = (capsys.readouterr().out, (result / "04_errors.txt").read_text())
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].splitlines()
    assert len(lines) == 2 and lines[0].startswith("seq04 Average_t_error")


def test_write_all_plots_writes_jax_files(scored, tmp_path):
    from efficientlo_net_torch.evaluation.kitti_metrics import evaluate_sequence, poses_from_rows

    gt_dir, noisy = scored
    poses_gt = poses_from_rows(np.loadtxt(Path(gt_dir) / "04.txt"))
    poses = poses_from_rows(noisy)
    errors = evaluate_sequence(poses_gt, poses).errors
    assert errors
    for name, plots in (("port", TPlots), ("jax", JPlots)):
        plots.write_all_plots("04", poses_gt, poses, errors, str(tmp_path / name))
        plots.write_all_plots("04", None, poses, [], str(tmp_path / f"{name}_no_gt"))
    for sub in ("", "_no_gt"):
        got = sorted(p.name for p in (tmp_path / f"port{sub}").iterdir())
        want = sorted(p.name for p in (tmp_path / f"jax{sub}").iterdir())
        assert got == want and got
    assert TPlots.euler_zyx_from_matrix(poses[5][:3, :3]) == JPlots.euler_zyx_from_matrix(
        poses[5][:3, :3])


def test_evaluate_sequences_writes_plots(tmp_path):
    """``make_plots=True`` writes each sequence's plots under
    ``<result_dir>/<seq>_eval`` (the JAX runner's layout)."""
    from efficientlo_net_torch.data.kitti import OdometryDataset
    from efficientlo_net_torch.data.synthetic import random_scene
    from efficientlo_net_torch.evaluation.runner import evaluate_sequences
    from efficientlo_net_torch.training.step import make_eval_step, make_streaming_eval_fns

    scene = random_scene(np.random.default_rng(0), 4096, CFG.sensor)
    root, gt_dir, _ = build_fake_kitti(tmp_path / "kitti", scene, CFG.sensor.num_points)
    torch.manual_seed(0)
    model = TNet(CFG).eval()
    dataset = OdometryDataset(root, num_points=CFG.sensor.num_points, gt_pose_dir=gt_dir)
    result = tmp_path / "result"
    results = evaluate_sequences(make_eval_step(CFG), model, dataset, [4], gt_dir=gt_dir,
                                 result_dir=str(result), log=lambda *a: None, make_plots=True,
                                 stream_fns=make_streaming_eval_fns(CFG))
    assert set(results) == {4}
    assert sorted(p.name for p in (result / "04_eval").iterdir()) == [
        "04_errors.png", "04_path.png", "04_rpy.png", "04_xyz.png"]
