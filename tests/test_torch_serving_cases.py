"""The ``efficientlo::`` operators, the exported artifact and the bfloat16
stream on the card.

Both operators called directly on CUDA tensors launch their kernel once and
equal the plain versions on the same tensors (masks and indices exactly, in
slot order; grouped values exactly); a tiny network exported for the card
holds 14 + 5 operator calls, launches them at every call and gives
``make_infer_fn``'s poses (atol 1e-5: the same operations in the same
order); a tiny bfloat16 stream launches 14 + 5 kernels a push and stays
within the JAX package's bfloat16 bounds of the float32 stream.  The
kernels have no CPU mode, so without a card every test skips.  No JAX
import: run on the card with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_serving_cases.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import tiny_model_config
from efficientlo_net_torch.data.synthetic import synthetic_pair
from efficientlo_net_torch.evaluation.streaming import OdometryStream
from efficientlo_net_torch.models.pwclo import PWCLONet
from efficientlo_net_torch.ops import neighbors as nbr
from efficientlo_net_torch.ops import window_select as ws
from efficientlo_net_torch.serving.export import (export_odometry, load_odometry, make_infer_fn,
                                                  save_artifact)
# bare name: pytest puts tests/ on sys.path, and a machine may have an
# unrelated "tests" package installed that would shadow tests.<module>
from torch_cases import GROUP_CASES, MODES, SELECT_CASES, group_inputs, select_inputs

pytestmark = pytest.mark.cuda

CFG = tiny_model_config()
PUSH = {"window_select": 14, "select_and_group": 5}
EXPORT_ATOL = 1e-5
# tests/test_bf16.py's bounds on bfloat16 against float32 poses
BF16_Q_BOUND, BF16_T_BOUND = 0.2, 0.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda(x, dev):
    return None if x is None else torch.as_tensor(np.asarray(x)).to(dev)


def _counted(fn):
    """fn()'s result and the kernel launches it made."""
    before = dict(ws.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: ws.launches[k] - before[k] for k in before}


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("case", ["plain", "centre_stride", "source_stride",
                                  "wide_11x41_k6"])
def test_window_select_op_on_the_card_equals_plain(dev, case, mode, with_perm):
    g1, g2, ks, k, dist, cs, ss, perm = select_inputs(case, with_perm)
    args = (_cuda(g1, dev), _cuda(g2, dev), list(ks), k, dist, list(cs), list(ss), mode,
            _cuda(perm, dev))
    (idx, mask), counts = _counted(lambda: torch.ops.efficientlo.window_select(*args))
    assert counts == {"window_select": 1, "select_and_group": 0}
    idx_p, mask_p = nbr.select_neighbors_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(idx, idx_p)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_select_and_group_op_on_the_card_equals_plain(dev, case):
    xyz, feats, ks, k, dist, cs, mode = group_inputs(case)
    args = (_cuda(xyz, dev), _cuda(feats, dev), list(ks), k, dist, list(cs), mode, None)
    got, counts = _counted(lambda: torch.ops.efficientlo.select_and_group(*args))
    assert counts == {"window_select": 0, "select_and_group": 1}
    for g, w in zip(got, nbr.select_and_group_plain(*args)):
        assert torch.equal(g, w)


def _near_identity(model):
    """Pose heads that predict near-identity motion, as a trained network
    does on consecutive scans (random heads make l0 chaotic between any two
    float orders)."""
    with torch.no_grad():
        for name in ("l3_head", "head_l0", "head_l1", "head_l2"):
            head = getattr(model, name)
            for lin, bias in ((head.q_head.dense, [1.0, 0.0, 0.0, 0.0]),
                              (head.t_head.dense, [0.0, 0.0, 0.0])):
                lin.weight.mul_(0.01)
                lin.bias.copy_(torch.tensor(bias))
    return model


def _tiny_model(cfg=CFG, seed=0):
    torch.manual_seed(seed)
    return _near_identity(PWCLONet(cfg))


def _scans(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        out += list(synthetic_pair(rng, CFG.sensor)[:2])
    return out[:n]


def test_card_artifact_matches_direct_call(dev, tmp_path):
    model = _tiny_model().to(dev)
    exported = export_odometry(model, CFG, batch_size=1, device=dev)
    ops = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"
           and str(n.target).startswith("efficientlo.")]
    assert ops.count("efficientlo.window_select.default") == 14
    assert ops.count("efficientlo.select_and_group.default") == 5
    _, call = load_odometry(save_artifact(str(tmp_path / "odom"), exported))
    pc1, pc2 = (torch.as_tensor(s[None], device=dev) for s in _scans(2))
    (q, t), counts = _counted(lambda: call(pc1, pc2))
    assert counts == PUSH
    with torch.no_grad():
        q_d, t_d = make_infer_fn(model, CFG)(pc1, pc2)
    torch.testing.assert_close(q, q_d, atol=EXPORT_ATOL, rtol=0)
    torch.testing.assert_close(t, t_d, atol=EXPORT_ATOL, rtol=0)


def test_tiny_bf16_push_on_the_card(dev):
    scans = _scans(3)
    poses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(CFG, compute_dtype=dtype)
        stream = OdometryStream(_tiny_model(cfg), cfg, device=dev)
        poses[dtype] = []
        for s in scans:
            pose, counts = _counted(lambda: stream.push(s))
            assert counts == PUSH
            poses[dtype].append(pose)
    for (q16, t16), (q32, t32) in zip(poses["bfloat16"], poses["float32"]):
        assert np.all(np.isfinite(q16)) and np.all(np.isfinite(t16))
        assert abs(float(np.linalg.norm(q16)) - 1.0) < 1e-3
        assert np.abs(q16 - q32).max() < BF16_Q_BOUND
        assert np.abs(t16 - t32).max() < BF16_T_BOUND
