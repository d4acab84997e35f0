"""Reader of the weights file the benchmark's configurations name.

The file is a msgpack map ``{"meta": <json str>, "variables": <bin>}``;
the bin is msgpack again, nested maps ``{"params": ..., "batch_stats":
...}`` whose leaves are ext type 1 holding ``(shape, dtype name, raw
bytes)`` (Flax's serialization of an array).  ``state_dict`` maps them onto
the reference network's parameter names: a Flax ``Dense.kernel`` (in, out)
is the transposed ``nn.Linear.weight``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch


class _Reader:
    """The msgpack subset these files use."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code != 1:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.take(tag & 0x1F).decode()
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if tag in sized:
            return self.take(self.unpack(sized[tag]))
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if tag in strs:
            return self.take(self.unpack(strs[tag])).decode()
        exts = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if tag in exts:
            n = self.unpack(exts[tag])
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= tag <= 0xD8:
            return self.ext(self.unpack("b"), 1 << (tag - 0xD4))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if tag in scalars:
            return self.unpack(scalars[tag])
        if tag in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack("H" if tag == 0xDC else "I"))]
        if tag in (0xDE, 0xDF):
            return self.map(self.unpack("H" if tag == 0xDE else "I"))
        if tag in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[tag]
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _walk(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def read_variables(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        blob = _Reader(f.read()).read()
    return _Reader(blob["variables"]).read()


def state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The file's weights and batch-norm statistics under the reference
    network's names, float32 on the CPU."""
    variables = read_variables(path)
    out = {}
    for keys, value in _walk(variables.get("params", {})):
        array = np.asarray(value, dtype=np.float32)
        if keys[-1] == "kernel":
            keys, array = keys[:-1] + ("weight",), array.T
        out[".".join(keys)] = torch.from_numpy(np.ascontiguousarray(array))
    for keys, value in _walk(variables.get("batch_stats", {})):
        out[".".join(keys)] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out
