"""The port's OdometryStream against the JAX package's, on the CPU.

Three raw scans through both streams (35 m crop, packed projection, cached
pyramids), tiny config with the same random weights.  Poses agree to 1e-4
(float32 sums in another order); the projections agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data import synthetic as TS
from efficientlo_net_torch.evaluation.streaming import OdometryStream as TStream
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.data import synthetic as JS
from efficientlo_net_tpu.evaluation.streaming import OdometryStream as JStream
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops.projection import project_to_range_image
from tests.test_model import synthetic_scan
from tests.torch_parity import randomize_batch_stats, to_torch_module

POSE_ATOL = 1e-4


def test_stream_matches_jax_stream():
    cfg = j_tiny()
    rng = np.random.default_rng(0)
    scans = [synthetic_scan(rng, cfg.sensor.num_points) for _ in range(3)]
    scans[1][::5] = 0.0  # padding
    scans[2][:40, :2] *= 1.3  # some points beyond the 35 m planar crop
    h, w = cfg.sensor.height, cfg.sensor.width
    p0, _ = project_to_range_image(jnp.asarray(scans[0][None]), None, h, w, cfg.sensor)
    model = JNet(cfg)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)},
        p0, p0, training=False,
    )
    variables = randomize_batch_stats(variables)
    j_stream = JStream(model, variables, cfg)
    t_stream = TStream(to_torch_module(TNet(t_tiny()), variables), t_tiny(), device="cpu")

    for s in scans:
        jq, jt = j_stream.push(s)
        tq, tt = t_stream.push(s)
        assert tq.shape == (4,) and tt.shape == (3,)
        np.testing.assert_allclose(tq, jq, atol=POSE_ATOL)
        np.testing.assert_allclose(tt, jt, atol=POSE_ATOL)
        np.testing.assert_array_equal(t_stream.last_projection.numpy(),
                                      np.asarray(j_stream.last_projection))

    # reset clears the cached pyramid: the next scan pairs with itself
    t_stream.reset()
    j_stream.reset()
    np.testing.assert_allclose(t_stream.push(scans[2])[0], j_stream.push(scans[2])[0],
                               atol=POSE_ATOL)


def test_stream_refuses_missing_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TStream(TNet(t_tiny()), t_tiny())


def test_synthetic_pair_matches_jax_package():
    """The port's own copy of the scan generator gives the same scans and
    motion from the same seed."""
    j_pair = JS.synthetic_pair(np.random.default_rng(7), j_tiny().sensor)
    t_pair = TS.synthetic_pair(np.random.default_rng(7), t_tiny().sensor)
    for a, b in zip(t_pair, j_pair):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
