"""The port's artifact reader, writer and weight bridge (efficientlo_net_torch/pretrained.py).

The pure-Python msgpack reader against ``msgpack`` and
``flax.serialization.msgpack_restore``, and its writer against
``msgpack.packb`` and ``flax.serialization.msgpack_serialize``, byte for
byte; the bridge maps the 50-epoch artifact's 899,132 parameters one to
one onto ``PWCLONet``; an artifact written by the JAX package drives both
networks to the same poses (atol 1e-4: float32 sums in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from efficientlo_net_torch import pretrained as TPre
from efficientlo_net_torch.config import ModelConfig as TConfig
from efficientlo_net_torch.config import tiny_model_config as t_tiny
from efficientlo_net_torch.data.synthetic import synthetic_pair
from efficientlo_net_torch.models.pwclo import PWCLONet as TNet
from efficientlo_net_tpu.config import ModelConfig as JConfig
from efficientlo_net_tpu.config import tiny_model_config as j_tiny
from efficientlo_net_tpu.models.pwclo import PWCLONet as JNet
from efficientlo_net_tpu.ops.projection import project_to_range_image
from efficientlo_net_tpu.pretrained import save_pretrained
from tests.torch_parity import randomize_batch_stats, t

ARTIFACT = Path(__file__).resolve().parents[1] / "pretrained" / "synthetic_drive_50ep.msgpack"
FULL_PARAMS = 899_132
POSE_ATOL = 1e-4


def _leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def test_reader_matches_flax_msgpack_restore():
    variables, meta = TPre.load_pretrained(str(ARTIFACT))
    blob = msgpack.unpackb(ARTIFACT.read_bytes())
    assert meta == json.loads(blob["meta"])
    got = _leaves(variables)
    want = _leaves(serialization.msgpack_restore(blob["variables"]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w)


def test_bridge_maps_artifact_one_to_one():
    variables, meta = TPre.load_pretrained(str(ARTIFACT))
    params = _leaves(variables["params"])
    assert sum(v.size for v in params.values()) == FULL_PARAMS == meta["param_count"]

    state = TPre.variables_to_state_dict(variables)
    model = TNet(TConfig())
    assert set(state) == set(model.state_dict())
    assert len(state) == len(params) + len(_leaves(variables["batch_stats"]))
    assert sum(p.numel() for p in model.parameters()) == FULL_PARAMS
    model.load_state_dict(state, strict=True)
    named = dict(model.named_parameters())
    for path, value in params.items():
        if path[-1] == "kernel":  # Flax Dense (in, out) -> nn.Linear (out, in)
            got = named[".".join(path[:-1] + ("weight",))].detach().numpy().T
        else:
            got = named[".".join(path)].detach().numpy()
        np.testing.assert_array_equal(got, value)


# name -> (object, first byte of its msgpack encoding)
FORMATS = {
    "fixmap": ({"a": 1}, 0x81),
    "map16": ({str(i): i for i in range(20)}, 0xDE),
    "map32": ({i: None for i in range(70_000)}, 0xDF),
    "fixstr": ("abc", 0xA3),
    "str8": ("x" * 40, 0xD9),
    "str16": ("x" * 300, 0xDA),
    "str32": ("x" * 70_000, 0xDB),
    "bin8": (b"\x01" * 10, 0xC4),
    "bin16": (b"\x02" * 300, 0xC5),
    "bin32": (b"\x03" * 70_000, 0xC6),
    "fixarray": ([1, [2, 3]], 0x92),
    "array16": (list(range(20)), 0xDC),
    "array32": (list(range(70_000)), 0xDD),
    "positive_fixint": (127, 0x7F),
    "negative_fixint": (-32, 0xE0),
    "uint8": (200, 0xCC),
    "uint16": (60_000, 0xCD),
    "uint32": (2**31, 0xCE),
    "uint64": (2**63, 0xCF),
    "int8": (-33, 0xD0),
    "int16": (-200, 0xD1),
    "int32": (-40_000, 0xD2),
    "int64": (-(2**40), 0xD3),
    "float64": (1.0 / 3.0, 0xCB),
    "nil": (None, 0xC0),
    "false": (False, 0xC2),
    "true": (True, 0xC3),
}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_reader_decodes_each_msgpack_format(name):
    obj, tag = FORMATS[name]
    data = msgpack.packb(obj)
    assert data[0] == tag
    assert TPre.unpackb(data) == msgpack.unpackb(data, strict_map_key=False)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_writer_encodes_each_msgpack_format(name):
    """``packb`` lays each format out as ``msgpack.packb`` does."""
    obj, tag = FORMATS[name]
    data = TPre.packb(obj)
    assert data[0] == tag and data == msgpack.packb(obj)


def test_reader_decodes_float32():
    data = msgpack.packb(0.1, use_single_float=True)
    assert data[0] == 0xCA
    assert TPre.unpackb(data) == msgpack.unpackb(data)


# name -> ((shape, dtype name), first byte of the ext's encoding)
EXT_ARRAYS = {
    "fixext8": (((), "u1"), 0xD7),
    "fixext16": (((5,), "uint8"), 0xD8),
    "ext8": (((3, 4), "float32"), 0xC7),
    "ext16": (((2, 500), "float32"), 0xC8),
    "ext32": (((20_000,), "float32"), 0xC9),
}


@pytest.mark.parametrize("name", sorted(EXT_ARRAYS))
def test_reader_decodes_ndarray_ext(name):
    (shape, dtype), tag = EXT_ARRAYS[name]
    rng = np.random.default_rng(0)
    array = rng.integers(0, 255, shape).astype(dtype)
    # Flax's encoding of an ndarray leaf: ext type 1 around (shape, dtype, bytes)
    payload = msgpack.packb((list(shape), dtype, array.tobytes()))
    data = msgpack.packb({"leaf": msgpack.ExtType(1, payload)})
    assert data[len(msgpack.packb({"leaf": 0})) - 1] == tag
    got = TPre.unpackb(data)["leaf"]
    assert got.dtype == array.dtype and got.shape == array.shape
    np.testing.assert_array_equal(got, array)


@pytest.mark.parametrize("name", sorted(EXT_ARRAYS))
def test_writer_encodes_ndarray_ext_as_flax(name):
    (shape, dtype), _ = EXT_ARRAYS[name]
    array = np.random.default_rng(0).integers(0, 255, shape).astype(dtype)
    assert TPre.packb({"leaf": array}) == serialization.msgpack_serialize({"leaf": array})


@pytest.mark.parametrize("data", [
    b"\xc1",                                                # never-used type byte
    msgpack.packb(msgpack.ExtType(5, b"\x00" * 4)),         # ext type other than ndarray
    msgpack.packb(msgpack.ExtType(5, b"\x00" * 40)),
    msgpack.packb("abc")[:-1],                              # truncated
    msgpack.packb(1) + b"\x00",                             # trailing bytes
], ids=["reserved", "fixext_type5", "ext8_type5", "truncated", "trailing"])
def test_reader_rejects_malformed_input(data):
    with pytest.raises(ValueError):
        TPre.unpackb(data)


def test_reader_rejects_future_format(tmp_path):
    path = tmp_path / "future.msgpack"
    path.write_bytes(msgpack.packb({"meta": json.dumps({"format_version": 99}),
                                    "variables": b""}))
    with pytest.raises(ValueError, match="newer"):
        TPre.load_pretrained(str(path))


def _artifact_parity(path, j_cfg, t_cfg, seed=0):
    """The artifact at ``path`` through the JAX package and through the
    port's reader (``load_model`` on the CPU): the same range images of a
    synthetic pair give the same l0..l3 poses."""
    from efficientlo_net_tpu.pretrained import load_pretrained

    pc1, pc2, _ = synthetic_pair(np.random.default_rng(seed), t_cfg.sensor)
    s = j_cfg.sensor
    projs = [project_to_range_image(jnp.asarray(p[None]), None, s.height, s.width, s,
                                     method="packed")[0] for p in (pc1, pc2)]
    variables, _ = load_pretrained(str(path))
    want = jax.jit(lambda v, a, b: JNet(j_cfg).apply(v, a, b, training=False))(
        variables, *projs)
    model, _ = TPre.load_model(str(path), t_cfg, device="cpu")
    with torch.no_grad():
        got = model(*[t(p) for p in projs])
    for level in range(4):
        for key in ("q", "t"):
            np.testing.assert_allclose(got[key][level].numpy(), np.asarray(want[key][level]),
                                       atol=POSE_ATOL, err_msg=f"{key} l{level}")


def test_artifact_written_by_jax_drives_port_like_jax(tmp_path):
    cfg = j_tiny()
    p = jnp.zeros((1, cfg.sensor.height, cfg.sensor.width, 3))
    variables = jax.jit(JNet(cfg).init, static_argnames=("training",))(
        {"params": jax.random.key(0), "neighbor": jax.random.key(1),
         "dropout": jax.random.key(2)}, p, p, training=False)
    path = tmp_path / "tiny.msgpack"
    save_pretrained(str(path), randomize_batch_stats(variables), meta={"trained_epochs": 0})
    _artifact_parity(path, cfg, t_tiny())


def test_full_config_50ep_artifact_matches_jax():
    """Full HDL-64 width (64x1800, 150k points) with the 50-epoch weights."""
    _artifact_parity(ARTIFACT, JConfig(), TConfig())
