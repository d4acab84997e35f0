"""Pretrained-weight artifacts: reader and weight bridge.

The artifacts in ``pretrained/*.msgpack`` are msgpack maps
``{"meta": <json str>, "variables": <bin>}``; the bin is itself msgpack,
nested maps ``{"params": ..., "batch_stats": ...}`` whose leaves are ext
type 1, each holding a packed ``(shape, dtype_name, raw_bytes)`` (Flax's
serialization of an ndarray).  ``load_pretrained`` decodes that with the
small pure-Python msgpack reader below, so neither ``msgpack`` nor ``flax``
is needed.  ``variables_to_state_dict`` maps the nested variables onto
``PWCLONet``'s ``state_dict``: a Flax ``Dense.kernel`` (in, out) becomes the
transposed ``nn.Linear.weight``; batch-norm ``scale``/``bias`` and running
``mean``/``var`` carry across by name.  ``train_state_to_torch`` does the
same for a JAX train state and returns its loss weights ``w_x``/``w_q``.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models.pwclo import PWCLONet

FORMAT_VERSION = 1
_NDARRAY_EXT = 1


class _Reader:
    """Decoder for the msgpack subset the artifacts use: maps, strings,
    binaries, ext, arrays, ints, floats, nil and bool.  Anything else raises."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(">" + fmt)))[0]

    def _str(self, n: int) -> str:
        return self._take(n).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code != _NDARRAY_EXT:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()

    def _ext_sized(self, fmt: str):
        n = self._unpack(fmt)
        return self._ext(self._unpack("b"), n)

    # type byte -> decoder of what follows it (fixed-size and sized types)
    _DECODERS = {
        0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
        0xC4: lambda r: r._take(r._unpack("B")),
        0xC5: lambda r: r._take(r._unpack("H")),
        0xC6: lambda r: r._take(r._unpack("I")),
        0xC7: lambda r: r._ext_sized("B"),
        0xC8: lambda r: r._ext_sized("H"),
        0xC9: lambda r: r._ext_sized("I"),
        0xCA: lambda r: r._unpack("f"), 0xCB: lambda r: r._unpack("d"),
        0xCC: lambda r: r._unpack("B"), 0xCD: lambda r: r._unpack("H"),
        0xCE: lambda r: r._unpack("I"), 0xCF: lambda r: r._unpack("Q"),
        0xD0: lambda r: r._unpack("b"), 0xD1: lambda r: r._unpack("h"),
        0xD2: lambda r: r._unpack("i"), 0xD3: lambda r: r._unpack("q"),
        0xD4: lambda r: r._ext(r._unpack("b"), 1),
        0xD5: lambda r: r._ext(r._unpack("b"), 2),
        0xD6: lambda r: r._ext(r._unpack("b"), 4),
        0xD7: lambda r: r._ext(r._unpack("b"), 8),
        0xD8: lambda r: r._ext(r._unpack("b"), 16),
        0xD9: lambda r: r._str(r._unpack("B")),
        0xDA: lambda r: r._str(r._unpack("H")),
        0xDB: lambda r: r._str(r._unpack("I")),
        0xDC: lambda r: [r.read() for _ in range(r._unpack("H"))],
        0xDD: lambda r: [r.read() for _ in range(r._unpack("I"))],
        0xDE: lambda r: r._map(r._unpack("H")),
        0xDF: lambda r: r._map(r._unpack("I")),
    }

    def read(self) -> Any:
        tag = self._take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self._str(tag & 0x1F)
        if tag not in self._DECODERS:
            raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")
        return self._DECODERS[tag](self)


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_pretrained(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read an artifact: returns ``(variables, meta)``, ``variables`` the
    nested dict of numpy arrays ``{"params": ..., "batch_stats": ...}``."""
    with open(path, "rb") as f:
        blob = unpackb(f.read())
    meta = json.loads(blob["meta"])
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta['format_version']} is newer than this "
            f"library supports ({FORMAT_VERSION})"
        )
    return unpackb(blob["variables"]), meta


def _walk(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map Flax variables (nested dicts of arrays) onto ``PWCLONet``'s
    ``state_dict`` keys; one tensor per leaf."""
    out = {}
    for path, value in _walk(variables.get("params", {})):
        array = np.array(value, dtype=np.float32)  # a writable copy
        if path[-1] == "kernel":
            path, array = path[:-1] + ("weight",), array.T
        out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(array))
    for path, value in _walk(variables.get("batch_stats", {})):
        out[".".join(path)] = torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
    return out


def train_state_to_torch(params: Dict[str, Any], batch_stats: Dict[str, Any]):
    """Map a JAX train state (``params = {"model": ..., "w_x": ..., "w_q":
    ...}`` and ``batch_stats``, as numpy) onto the port: returns
    (``PWCLONet`` state dict, w_x, w_q), the loss weights as floats for
    ``training.state.create_train_state``."""
    state_dict = variables_to_state_dict({"params": params["model"], "batch_stats": batch_stats})
    return state_dict, float(np.asarray(params["w_x"])), float(np.asarray(params["w_q"]))


def load_model(path: str, cfg, device="cuda"):
    """``PWCLONet(cfg)`` with the artifact's weights, in eval mode on
    ``device`` (``training.state.create_train_state`` turns it into a
    training start).  Returns (model, meta)."""
    variables, meta = load_pretrained(path)
    model = PWCLONet(cfg)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.to(resolve_device(device)).eval(), meta
