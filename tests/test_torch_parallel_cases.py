"""Both select kernels on the halo-widened blocks of the W-axis ring, on the card.

For every rank of the ring, the kernels run with the block offsets of
``parallel/ring.py`` (centres from the rank's sector, windows on its block
widened by kw/2 columns each side, ``n_w`` centres a row) at the full-width
geometries of tests/test_ring.py.  Each result must equal, exactly: the
plain block version (``ring._select_on_block``, and its gather for the
grouped values) on the same block, and, after the global-index mapping, the
rows of the rank's sector in the unsharded kernel's output, slot for slot.
The ring's training path (the ``window_select`` kernel on each block, a
gather, and the backward folded onto the sectors by ``ring.fold_halo_grad``)
must give the unsharded ``select_and_group(fused=False)``'s groups exactly
and its gradients within TRAIN_GRAD_REL = 1e-6 of their scale (the order
of the gathers' scatter-adds).  The kernels have no CPU mode, so without a
card every test skips.  No JAX import: run on the card with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_parallel_cases.py
"""

import numpy as np
import pytest
import torch

from efficientlo_net_torch.ops import window_select as ws
# bare name: pytest puts tests/ on sys.path, and a machine may have an
# unrelated "tests" package installed that would shadow tests.<module>
from torch_cases import make_grids
from torch_parallel_cases import (FIRST_K, GEOMETRIES, ring_inputs, select_and_group_block,
                                  train_block_grads, unsharded_group_grads, window_select_block)

pytestmark = pytest.mark.cuda
TRAIN_GRAD_REL = 1e-6

# the level-0 DownConv of the full config: 64x1800, 9x15, K=32, stride (4, 8),
# first-K in a permuted scan order; C=3 zero features there, C=5 random here
GROUP_GEOMETRIES = {
    "down_l0_r3": ((64, 1800), 5, (9, 15), 32, 0.5, (4, 8), 3),
    "down_l0_r5": ((64, 1800), 5, (9, 15), 32, 0.5, (4, 8), 5),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _each_rank(name, kernel, args, ring_size, check_block):
    """Every rank's block call: one launch each, exact against the plain
    block version and the unsharded kernel's sector."""
    whole = getattr(ws, kernel)(*args)
    for r in range(ring_size):
        before = ws.launches[kernel]
        _, plain, unsharded = check_block(args, ring_size, r, whole)
        torch.cuda.synchronize()
        assert ws.launches[kernel] == before + 1, (name, r)
        assert plain == 0.0, (name, r, plain)
        assert unsharded == 0.0, (name, r, unsharded)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_window_select_on_ring_blocks(dev, name):
    _, _, kernel, k, dist, cs, ss, mode, ring_size = GEOMETRIES[name]
    g1, g2, perm = ring_inputs(name)
    args = (torch.from_numpy(g1).to(dev), torch.from_numpy(g2).to(dev), kernel, k, dist, cs, ss,
            mode, None if perm is None else torch.from_numpy(perm).to(dev))
    _each_rank(name, "window_select", args, ring_size, window_select_block)


@pytest.mark.parametrize("name", list(GROUP_GEOMETRIES))
def test_select_and_group_on_ring_blocks(dev, name):
    (h, w), c, kernel, k, dist, cs, ring_size = GROUP_GEOMETRIES[name]
    rng = np.random.default_rng(7)
    xyz, _ = make_grids(rng, b=2, h1=h, w1=w, h2=4, w2=6)
    feats = rng.standard_normal((2, h, w, c)).astype(np.float32)
    perm = rng.permutation(kernel[0] * kernel[1])
    args = (torch.from_numpy(xyz).to(dev), torch.from_numpy(feats).to(dev), kernel, k, dist, cs,
            FIRST_K, torch.from_numpy(perm).to(dev))
    _each_rank(name, "select_and_group", args, ring_size, select_and_group_block)


@pytest.mark.parametrize("name", list(GROUP_GEOMETRIES))
def test_ring_training_select_and_backward_on_ring_blocks(dev, name):
    """The level-0 DownConv in training on the ring: each rank's
    ``window_select`` on its widened block exact (one launch each), then
    the groups and their folded gradient (one ``window_select`` launch a
    block, no ``select_and_group``) against the unsharded ones."""
    (h, w), c, kernel, k, dist, cs, ring_size = GROUP_GEOMETRIES[name]
    rng = np.random.default_rng(8)
    xyz, _ = make_grids(rng, b=2, h1=h, w1=w, h2=4, w2=6)
    xyz = torch.from_numpy(xyz).to(dev)
    feats = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(kernel[0] * kernel[1])).to(dev)
    sargs = (xyz, xyz, kernel, k, dist, cs, (1, 1), FIRST_K, perm)
    _each_rank(name, "window_select", sargs, ring_size, window_select_block)
    gargs = (xyz, feats, kernel, k, dist, cs, FIRST_K, perm)
    n = -(-h // cs[0]) * -(-w // cs[1])
    upstream = torch.from_numpy(rng.standard_normal((2, n, k, 3 + c)).astype(np.float32)).to(dev)
    whole = unsharded_group_grads(gargs, upstream)
    before = dict(ws.launches)
    groups, grad_xyz, grad_feats = train_block_grads(gargs, ring_size, upstream, whole)
    torch.cuda.synchronize()
    launched = {name: ws.launches[name] - before[name] for name in before}
    assert launched == {"window_select": ring_size, "select_and_group": 0}, launched
    assert groups == 0.0
    assert grad_xyz <= TRAIN_GRAD_REL and grad_feats <= TRAIN_GRAD_REL, (grad_xyz, grad_feats)
