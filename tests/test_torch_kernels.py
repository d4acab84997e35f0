"""The CUDA select kernels (efficientlo_net_torch/ops/csrc/window_select.cu) on the card.

Each kernel against its plain PyTorch version on the same CUDA tensors, over
the select cases of the CPU tests (centre and source strides, uneven
strides, a window wider than the grid, windows of more than 32 slots, which
the kernels scan in rounds of 32, FIRST_K with and without a scan
permutation, KNN with ties): masks and indices must be equal exactly, in the
same slot order, and the fused kernel's grouped values too.  The training
path (``select_and_group(fused=False)``: the select kernel, then a gather)
gives the plain version's values and gradients; the select kernel at the
full-width geometry of ``down_l0`` in training (B=8, 64x1800, a random scan
order).  The kernels have no CPU mode, so without a card every test skips.
No JAX import: run on the card with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from efficientlo_net_torch.ops import neighbors as nbr
from efficientlo_net_torch.ops import window_select as ws
# bare names: pytest puts tests/ on sys.path, and a machine may have an
# unrelated "tests" package installed that would shadow tests.<module>
from oracles import oracle_window_select
from torch_cases import (GROUP_CASES, MODES, SELECT_CASES, group_inputs, make_grids,
                         select_inputs, sets_equal)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda(x, dev):
    return None if x is None else torch.as_tensor(np.asarray(x)).to(dev)


def _launched(name, fn):
    """fn()'s result, checking that it launched ``name`` exactly once."""
    before = ws.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert ws.launches[name] == before + 1
    return out


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_window_select_matches_plain_and_oracle(dev, case, mode, with_perm):
    g1, g2, ks, k, dist, cs, ss, perm = select_inputs(case, with_perm)
    args = (_cuda(g1, dev), _cuda(g2, dev), ks, k, dist, cs, ss, mode, _cuda(perm, dev))
    idx, mask = _launched("window_select", lambda: nbr.select_neighbors(*args))
    idx_p, mask_p = nbr.select_neighbors_plain(*args)
    assert torch.equal(mask, mask_p)
    assert torch.equal(idx, idx_p)
    centres = np.stack(np.meshgrid(np.arange(0, g1.shape[1], cs[0]),
                                   np.arange(0, g1.shape[2], cs[1]), indexing="ij"), -1)
    o_idx, o_mask = oracle_window_select(g1, g2, centres.reshape(-1, 2), ks, k, dist,
                                         stride=ss, mode=mode, perm=perm)
    np.testing.assert_array_equal(mask.cpu().numpy()[..., 0], o_mask)
    sets_equal(idx.cpu().numpy(), mask.cpu().numpy(), o_idx, o_mask[..., None])


@pytest.mark.parametrize("mode", ["first_k", "knn"])
def test_window_select_ties_and_max_k(dev, mode):
    """Integer coordinates make many equal distances (KNN keeps the lowest
    window slot, also across the kernel's rounds of 32 slots: the 9x15
    window takes five); K = 32 is the widest the kernel takes."""
    rng = np.random.default_rng(5)
    g = rng.integers(-3, 4, (2, 12, 20, 3)).astype(np.float32)
    x = _cuda(g, dev)
    args = (x, x, (9, 15), 32, 4.0, (1, 1), (1, 1), mode, None)
    idx, mask = _launched("window_select", lambda: ws.window_select(*args))
    idx_p, mask_p = nbr.select_neighbors_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(idx, idx_p)
    assert mask.sum() > 0


@pytest.mark.parametrize("mode,with_perm", MODES)
@pytest.mark.parametrize("stride", [(1, 1), (2, 4), (2, 3)])
def test_select_and_group_matches_plain(dev, stride, mode, with_perm):
    rng = np.random.default_rng(11)
    g, _ = make_grids(rng, b=2, h1=7, w1=16)
    feats = rng.standard_normal((2, 7, 16, 5)).astype(np.float32)
    perm = rng.permutation(15) if with_perm else None
    args = (_cuda(g, dev), _cuda(feats, dev), (3, 5), 4, 2.0, stride, mode, _cuda(perm, dev))
    got = _launched("select_and_group", lambda: nbr.select_and_group(*args, fused=True))
    want = nbr.select_and_group_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_select_and_group_cases_match_plain(dev, case):
    """One feature channel; 64 channels with K = 32; the fused kernel in KNN."""
    xyz, feats, ks, k, dist, cs, mode = group_inputs(case)
    args = (_cuda(xyz, dev), _cuda(feats, dev), ks, k, dist, cs, mode, None)
    got = _launched("select_and_group", lambda: nbr.select_and_group(*args, fused=True))
    want = nbr.select_and_group_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert want[2].sum() > 0


def _count(fn):
    """fn()'s result and the launches of each kernel it made."""
    before = dict(ws.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: ws.launches[k] - before[k] for k in before}


@pytest.mark.parametrize("mode,with_perm", MODES)
def test_unfused_select_and_group_launches_select_and_matches_plain(dev, mode, with_perm):
    """The training path: one ``window_select`` launch, no fused launch, and
    the plain version's values exactly (same indices, same gather)."""
    rng = np.random.default_rng(12)
    g, _ = make_grids(rng, b=2, h1=8, w1=16)
    feats = rng.standard_normal((2, 8, 16, 5)).astype(np.float32)
    perm = rng.permutation(15) if with_perm else None
    args = (_cuda(g, dev), _cuda(feats, dev), (3, 5), 4, 2.0, (2, 4), mode, _cuda(perm, dev))
    got, counts = _count(lambda: nbr.select_and_group(*args, fused=False))
    assert counts == {"window_select": 1, "select_and_group": 0}
    want = nbr.select_and_group_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert want[2].sum() > 0


def test_unfused_select_and_group_gradients_match_plain(dev):
    """Gradients of the grouped values into the source coordinates and
    features: through the kernel's indices and through the plain version's.
    The gather's backward adds with atomics, in an order that changes from
    run to run, so the two agree to float32 rounding (rtol 1e-5, atol 1e-6),
    not bit for bit."""
    rng = np.random.default_rng(13)
    g, _ = make_grids(rng, b=2, h1=16, w1=32)
    feats = rng.standard_normal((2, 16, 32, 8)).astype(np.float32)
    perm = rng.permutation(45)
    cot_x = torch.as_tensor(rng.standard_normal((2, 64, 16, 3)).astype(np.float32)).to(dev)
    cot_f = torch.as_tensor(rng.standard_normal((2, 64, 16, 8)).astype(np.float32)).to(dev)
    grads = []
    for fn in (lambda *a: nbr.select_and_group(*a, fused=False), nbr.select_and_group_plain):
        xyz = _cuda(g, dev).requires_grad_()
        f = _cuda(feats, dev).requires_grad_()
        gx, gf, _ = fn(xyz, f, (5, 9), 16, 3.0, (2, 4), "first_k", _cuda(perm, dev))
        ((gx * cot_x).sum() + (gf * cot_f).sum()).backward()
        grads.append((xyz.grad, f.grad))
    for a, b in zip(*grads):
        assert b.abs().sum() > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_window_select_at_train_down_l0_geometry(dev):
    """``down_l0`` in a full-width train step: B=8 projected 150k-point
    scans (64x1800), a 9x15 window scanned in a random order, K=32,
    centres every (4, 8) pixels, radius 0.5 m."""
    from efficientlo_net_torch.config import SensorConfig
    from efficientlo_net_torch.data.synthetic import synthetic_pair
    from efficientlo_net_torch.ops.projection import project_to_range_image

    s = SensorConfig()
    rng = np.random.default_rng(14)
    pts = torch.as_tensor(np.stack([synthetic_pair(rng, s)[0] for _ in range(8)])).to(dev)
    grid, _ = project_to_range_image(pts, None, s.height, s.width, s)
    perm = torch.randperm(135, device=dev, generator=torch.Generator(dev).manual_seed(0))
    args = (grid, grid, (9, 15), 32, 0.5, (4, 8), (1, 1), "first_k", perm)
    (idx, mask), counts = _count(lambda: nbr.select_neighbors(*args))
    assert counts == {"window_select": 1, "select_and_group": 0}
    assert idx.shape == (8, 16 * 225, 32)
    idx_p, mask_p = nbr.select_neighbors_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(idx, idx_p)
    assert mask.sum() > 0


def test_wrappers_refuse_bad_input(dev):
    x = torch.zeros(1, 4, 8, 3, device=dev)
    before = dict(ws.launches)
    bad_calls = [
        lambda: ws.window_select(x.double(), x, (3, 3), 4, 1.0),
        lambda: ws.window_select(x.transpose(1, 2), x, (3, 3), 4, 1.0),
        lambda: ws.window_select(x, x, (3, 3), 33, 1.0),
        lambda: ws.window_select(x, x, (3, 3), 4, 1.0, mode="first_k", perm=torch.arange(8)),
        lambda: ws.window_select(x, x[:, :, :, :2].contiguous(), (3, 3), 4, 1.0),
        lambda: ws.select_and_group(x, torch.zeros(1, 4, 7, 2, device=dev), (3, 3), 4, 1.0),
        lambda: ws.select_and_group(x, x.cpu(), (3, 3), 4, 1.0),
    ]
    for call in bad_calls:
        with pytest.raises((ValueError, TypeError)):
            call()
    assert ws.launches == before
