"""The CUDA select kernels (efficientlo_net_torch/ops/csrc/window_select.cu) on the card.

Each kernel against its plain PyTorch version on the same CUDA tensors, over
the select cases of the CPU tests (centre and source strides, uneven
strides, a window wider than the grid, FIRST_K with and without a scan
permutation, KNN with ties): masks and indices must be equal exactly, in the
same slot order, and the fused kernel's grouped values too.  The kernels
have no CPU mode, so without a card every test skips.  No JAX import: run
on the card with

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
from torch_cases import MODES, SELECT_CASES, make_grids, select_inputs, sets_equal

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
    window slot); K = 32 over a 9x15 window is the widest the kernel takes."""
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
    got = _launched("select_and_group", lambda: nbr.select_and_group(*args))
    want = nbr.select_and_group_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


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
