"""Select cases and comparisons shared by the port's tests (tests/test_torch_*.py).

Numpy only, with no JAX import, so the card tests (tests/test_torch_kernels.py)
can use it on a machine that has no JAX.
"""

import numpy as np

# name -> (kernel_size, k, distance, center_stride, source_stride, grid shapes)
SELECT_CASES = {
    "plain": ((3, 5), 4, 2.0, (1, 1), (1, 1), dict(b=2, h1=8, w1=16)),
    "unbounded": ((3, 5), 6, 1000.0, (1, 1), (1, 1), dict(b=2, h1=8, w1=16)),
    "centre_stride": ((3, 5), 4, 2.0, (2, 4), (1, 1), dict(b=2, h1=8, w1=16)),
    "uneven_centre_stride": ((3, 3), 4, 100.0, (2, 3), (1, 1), dict(b=1, h1=7, w1=10)),
    "source_stride": ((3, 5), 3, 6.0, (1, 1), (2, 2), dict(b=2, h1=8, w1=16, h2=4, w2=8)),
    "uneven_source_stride": ((3, 5), 4, 6.0, (1, 1), (1, 2), dict(b=1, h1=5, w1=9, h2=5, w2=5)),
    "window_wider_than_w": ((3, 7), 3, 1000.0, (1, 1), (1, 1),
                            dict(b=1, h1=4, w1=4, h2=4, w2=4)),
}
# (mode, with a permuted scan order)
MODES = [("first_k", False), ("first_k", True), ("knn", False)]


def make_grids(rng, b=2, h1=8, w1=16, h2=8, w2=16, invalid_frac=0.3):
    """Two random (B, H, W, 3) grids with a share of invalid (zero) pixels."""
    g1 = rng.standard_normal((b, h1, w1, 3)).astype(np.float32) * 2.0
    g2 = rng.standard_normal((b, h2, w2, 3)).astype(np.float32) * 2.0
    for g in (g1, g2):
        g[rng.random(g.shape[:-1]) < invalid_frac] = 0.0
    return g1, g2


def select_inputs(case, with_perm, seed=0):
    """(g1, g2, kernel_size, k, distance, center_stride, source_stride, perm)
    of one case; a centre-strided case searches its own grid, as DownConv does."""
    ks, k, dist, cs, ss, shapes = SELECT_CASES[case]
    rng = np.random.default_rng(seed)
    g1, g2 = make_grids(rng, **shapes)
    if cs != (1, 1):
        g2 = g1
    perm = rng.permutation(ks[0] * ks[1]) if with_perm else None
    return g1, g2, ks, k, dist, cs, ss, perm


def sets_equal(idx_a, mask_a, idx_b, mask_b):
    """Per centre, the selected index sets and the mask counts must match;
    the order within the K slots is free."""
    idx_a, mask_a = np.asarray(idx_a), np.asarray(mask_a)[..., 0]
    idx_b, mask_b = np.asarray(idx_b), np.asarray(mask_b)[..., 0]
    np.testing.assert_array_equal(mask_a.sum(-1), mask_b.sum(-1))
    b, n, _ = idx_a.shape
    for bi in range(b):
        for ni in range(n):
            got = sorted(idx_a[bi, ni][mask_a[bi, ni] > 0].tolist())
            want = sorted(idx_b[bi, ni][mask_b[bi, ni] > 0].tolist())
            assert got == want, (bi, ni, got, want)


def rows_equal_as_multisets(got, want):
    """(B, N, K, C) values: per centre, the K rows must be equal as multisets
    (each row compared whole, so its channels stay together)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    b, n = got.shape[:2]
    for bi in range(b):
        for ni in range(n):
            g = sorted(map(tuple, got[bi, ni].tolist()))
            w = sorted(map(tuple, want[bi, ni].tolist()))
            assert g == w, (bi, ni)
