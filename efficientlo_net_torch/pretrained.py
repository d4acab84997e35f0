"""Pretrained-weight artifacts: reader, writer and weight bridge.

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

``save_pretrained`` writes the same format with the pure-Python msgpack
encoder below, the inverse of the reader: it lays the bytes out as
``msgpack.packb`` and ``flax.serialization.msgpack_serialize`` do (keys of
the variables sorted, as a Flax pytree orders them), so the JAX package's
``load_pretrained`` reads it.  ``state_dict_to_variables`` and
``variables_from_train_state`` give the port's weights in the Flax layout.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

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


# (unsigned format, its type byte, signed format, its type byte), smallest first
_INT_FORMS = (("B", 0xCC, "b", 0xD0), ("H", 0xCD, "h", 0xD1), ("I", 0xCE, "i", 0xD2),
              ("Q", 0xCF, "q", 0xD3))


def _pack_int(x: int) -> bytes:
    """The smallest encoding of ``x``: a fixint, else the narrowest sized
    int of its sign."""
    if -32 <= x < 0x80:
        return struct.pack(">b" if x < 0 else ">B", x)
    for ufmt, utag, sfmt, stag in _INT_FORMS:
        bits = 8 * struct.calcsize(ufmt)
        if 0 <= x < 1 << bits:
            return struct.pack(">B" + ufmt, utag, x)
        if -(1 << (bits - 1)) <= x < 0:
            return struct.pack(">B" + sfmt, stag, x)
    raise ValueError(f"integer {x} does not fit in 64 bits")


def _pack_sized(n: int, tags: Tuple[int, ...], fix: Optional[Tuple[int, int]] = None) -> bytes:
    """The header of an object of ``n`` entries or bytes: the fix form
    ``fix`` (type byte, largest n), where there is one, else the narrowest
    of the 8-, 16- and 32-bit length forms whose type bytes are ``tags``."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for tag, fmt in zip(tags, "BHI"[3 - len(tags):]):
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            return struct.pack(">B" + fmt, tag, n)
    raise ValueError(f"object of {n} entries is too large for msgpack")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as ``msgpack.packb`` does (``use_bin_type=True``):
    dicts, lists and tuples, str, bytes, int, float (as float64), bool and
    None; a numpy array (or numpy scalar) as Flax's ndarray ext type 1
    around ``(shape, dtype name, raw bytes)``."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return struct.pack(">Bd", 0xCB, obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_sized(len(raw), (0xD9, 0xDA, 0xDB), fix=(0xA0, 31)) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_sized(len(obj), (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_pack_sized(len(obj), (0xDC, 0xDD), fix=(0x90, 15))
                + b"".join(packb(v) for v in obj))
    if isinstance(obj, dict):
        return (_pack_sized(len(obj), (0xDE, 0xDF), fix=(0x80, 15))
                + b"".join(packb(k) + packb(v) for k, v in obj.items()))
    if isinstance(obj, (np.ndarray, np.generic)):
        array = np.asarray(obj)
        payload = packb([list(array.shape), array.dtype.name, array.tobytes(order="C")])
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            head = bytes([{1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}[n]])
        else:
            head = _pack_sized(n, (0xC7, 0xC8, 0xC9))
        return head + struct.pack(">b", _NDARRAY_EXT) + payload
    raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


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


def state_dict_to_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``variables_to_state_dict``: a ``PWCLONet`` state dict
    as Flax variables ``{"params": ..., "batch_stats": ...}`` of float32
    numpy arrays (``nn.Linear.weight`` back to the (in, out) ``kernel``;
    batch-norm ``mean``/``var`` to ``batch_stats``)."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        path = key.split(".")
        array = tensor.detach().to("cpu", torch.float32).numpy().copy()
        if path[-1] == "weight":
            path, array = path[:-1] + ["kernel"], np.ascontiguousarray(array.T)
        node = out["batch_stats" if path[-1] in ("mean", "var") else "params"]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = array
    return out


def variables_from_train_state(state) -> Dict[str, Any]:
    """Inference variables of a train state (``training.state.TrainState``):
    the network's weights and batch-norm statistics in the Flax layout, the
    loss weights left out, as every inference surface and
    ``save_pretrained`` take them."""
    return state_dict_to_variables(state.model.state_dict())


def _sorted(tree):
    """Dicts with their keys in sorted order at every level, as a Flax
    pytree orders them; leaves as numpy (float64 demoted to float32)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    array = np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)
    return array.astype(np.float32) if array.dtype == np.float64 else array


def save_pretrained(path: str, variables: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> int:
    """Write ``variables`` (a dict with at least "params"; typically also
    "batch_stats") and ``meta`` to ``path`` in the format of the JAX
    package's ``save_pretrained``, with the same header fields
    (``format_version``, ``param_count``).  Returns the file size in bytes."""
    keep = {k: _sorted(v) for k, v in variables.items() if k in ("params", "batch_stats")}
    if "params" not in keep:
        raise ValueError("variables must contain 'params'")
    header = dict(meta or {})
    header["format_version"] = FORMAT_VERSION
    header["param_count"] = int(sum(a.size for _, a in _walk(keep["params"])))
    blob = packb({"meta": json.dumps(header), "variables": packb(_sorted(keep))})
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


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
