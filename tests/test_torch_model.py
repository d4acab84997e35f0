"""Parity of the port's layers and network with the JAX package, on the CPU.

Tiny config, random Flax init with randomized batch-norm statistics, carried
across by the weight bridge; both packages get the same range images.
Tolerances (rtol 1e-4, atol 1e-5 on features; atol 1e-4 on poses) cover
float32 sums taken in another order by the two frameworks; neighbour
selection is exact on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.models import layers as TL
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.models import layers as JL
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops.projection import project_to_range_image
from tests.test_model import synthetic_scan
from tests.torch_cases import make_grids
from tests.torch_parity import randomize_batch_stats, t, to_torch_module

FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
POSE_ATOL = 1e-4


def _layer_pair(j_module, t_module, arrays, static=()):
    """Init the Flax layer on ``arrays`` (+ ``static`` arguments), carry its
    weights into the torch layer; returns (jax output, torch output) on the
    same inputs."""
    variables = jax.jit(
        lambda a: j_module.init(jax.random.key(0), *a, *static, False, 0.99))(arrays)
    variables = randomize_batch_stats(variables)
    want = j_module.apply(variables, *arrays, *static, False, 0.99)
    to_torch_module(t_module, variables)
    with torch.no_grad():
        got = t_module(*[t(a) for a in arrays], *static)
    return want, got


def test_down_conv_matches_jax():
    rng = np.random.default_rng(0)
    xyz, _ = make_grids(rng, b=2, h1=8, w1=16)
    feats = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), k=8, distance=3.0, mlp=(8, 8, 16), out_hw=(4, 4))
    want, got = _layer_pair(JL.DownConv(**kw), TL.DownConv(4, **kw),
                            (jnp.asarray(xyz), jnp.asarray(feats)), static=((2, 4),))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FEAT_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_up_conv_matches_jax():
    rng = np.random.default_rng(1)
    xyz1, _ = make_grids(rng, b=2, h1=8, w1=16)
    _, xyz2 = make_grids(rng, b=2, h2=4, w2=8)
    feat1 = rng.standard_normal((2, 128, 6)).astype(np.float32)
    feat2 = rng.standard_normal((2, 4, 8, 5)).astype(np.float32)
    kw = dict(kernel_size=(3, 5), nsample=4, distance=6.0, stride_hw=(2, 2),
              mlp=(16, 8), mlp2=(16, 8))
    want, got = _layer_pair(JL.UpConv(**kw), TL.UpConv(6, 5, **kw),
                            [jnp.asarray(a) for a in (xyz1, xyz2, feat1, feat2)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


def test_cost_volume_matches_jax():
    rng = np.random.default_rng(2)
    xyz1, xyz2 = make_grids(rng, b=2, h1=8, w1=16, invalid_frac=0.2)
    f1 = rng.standard_normal((2, 8, 16, 6)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 16, 7)).astype(np.float32)
    kw = dict(kernel_size1=(3, 3), kernel_size2=(3, 5), nsample=4, nsample_q=6,
              distance=2.0, mlp1=(16, 8, 8), mlp2=(16, 8))
    want, got = _layer_pair(JL.CostVolume(**kw), TL.CostVolume(6, 7, **kw),
                            [jnp.asarray(a) for a in (xyz1, xyz2, f1, f2)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


@pytest.fixture(scope="module")
def nets():
    """JAX and torch tiny networks with the same weights, and two batches of
    range images (B=2) projected once, by the JAX package."""
    cfg = j_tiny()
    rng = np.random.default_rng(0)
    h, w, n = cfg.sensor.height, cfg.sensor.width, cfg.sensor.num_points
    projs = [
        project_to_range_image(jnp.asarray(np.stack([synthetic_scan(rng, n) for _ in range(2)])),
                               None, h, w, cfg.sensor, method="packed")[0]
        for _ in range(2)
    ]
    model = JNet(cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)},
        projs[0], projs[1], training=False,
    )
    variables = randomize_batch_stats(variables)
    return model, variables, to_torch_module(TNet(t_tiny()), variables), projs


def test_pyramid_matches_jax(nets):
    model, variables, tm, (p1, _) = nets
    want = jax.jit(lambda v, p: model.apply(v, p, False, 0.99, False, method=model._pyramid))(
        variables, p1)
    with torch.no_grad():
        got = tm._pyramid(t(p1))
    assert len(got) == len(want) == 4
    for (gx, gf, gfp), (wx, wf, wfp) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **FEAT_TOL)
        np.testing.assert_allclose(gfp.numpy(), np.asarray(wfp), **FEAT_TOL)


def test_forward_and_forward_from_pyramids_match_jax(nets):
    model, variables, tm, (p1, p2) = nets
    want = jax.jit(lambda v, a, b: model.apply(v, a, b, training=False))(variables, p1, p2)
    with torch.no_grad():
        got = tm(t(p1), t(p2))
        cached = tm.forward_from_pyramids(tm._pyramid(t(p1)), tm._pyramid(t(p2)))
    for level in range(4):
        for key in ("q", "t"):
            np.testing.assert_allclose(got[key][level].numpy(), np.asarray(want[key][level]),
                                       atol=POSE_ATOL)
            # the merged 2B tower equals two separate towers (up to the BLAS
            # kernel a different batch size may pick)
            np.testing.assert_allclose(cached[key][level].numpy(), got[key][level].numpy(),
                                       atol=1e-6)
    q0 = got["q"][0].numpy()
    np.testing.assert_allclose(np.linalg.norm(q0, axis=-1), 1.0, atol=1e-5)
