"""ctypes bindings of the repo's native IO library (``native/lidar_io.cpp``).

The port's copy of ``efficientlo_net_tpu/data/native_io.py``: parallel C++
scan decoding and the exact host projector (nearest point per pixel, ties
to the lowest index: the ``sort`` / ``scatter`` image), with the GIL
released inside every call, so loader threads decode and project in
parallel.

The port builds its own library, at first use, from ``native/lidar_io.cpp``
with ``$CXX`` (default ``g++``) and ``native/Makefile``'s flags into the
git-ignored ``efficientlo_net_torch/_build/``, named by a hash of the source
and the flags.  It never writes into ``native/`` and never loads a library
built there.  Without a host compiler (or without the source, as in an
installed wheel) ``available()`` is False and the numpy twins
``_read_scan_numpy`` and ``_project_scan_numpy`` serve; a compiler that is
present but fails raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lidar_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
MIN_ABI = 2
FUSED_ABI = 3

_F = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()  # loader threads may be the first callers
_state = {"probed": False, "lib": None}


def compiler() -> Optional[str]:
    """Path of the host C++ compiler (``$CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libefficientlo_io_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/lidar_io.cpp`` unless its library exists.  The
    compiler writes a file of its own (pid-suffixed) that is then renamed
    into place, so processes that build at once never load a partial one."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler: set CXX or install g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} with {cxx} failed "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.elo_abi_version.argtypes = []
    lib.elo_abi_version.restype = ctypes.c_int32
    abi = lib.elo_abi_version()
    if abi < MIN_ABI:
        raise RuntimeError(f"{path.name}: native ABI {abi}, need {MIN_ABI} or more")
    lib.elo_read_scan.restype = ctypes.c_int64
    lib.elo_read_scan.argtypes = [ctypes.c_char_p, _F, ctypes.c_int64]
    lib.elo_read_batch.restype = ctypes.c_int32
    lib.elo_read_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _F,
                                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int32]
    lib.elo_project_scan.restype = None
    lib.elo_project_scan.argtypes = [_F, ctypes.c_int64, _F, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int32]
    lib.elo_project_batch.restype = None
    lib.elo_project_batch.argtypes = [_F, ctypes.c_int64, ctypes.c_int64, _F, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_int32]
    if abi >= FUSED_ABI:  # the fused crop + augment + project
        lib.elo_augment_project_batch.restype = None
        lib.elo_augment_project_batch.argtypes = [
            _F, _F, ctypes.POINTER(ctypes.c_uint8), _F, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, _F, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_int32]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None without a compiler
    or source.  A failed build raises (and is tried again next call)."""
    if _state["probed"]:
        return _state["lib"]
    with _lock:
        if not _state["probed"]:
            if SOURCE.exists() and (library_path().exists() or compiler() is not None):
                _state["lib"] = _bind(build())
            _state["probed"] = True
    return _state["lib"]


def available() -> bool:
    """True when the native library is loaded (building it if needed)."""
    return _load() is not None


def abi_version() -> int:
    """The loaded library's ABI version; raises without one."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    return int(lib.elo_abi_version())


def fused_available() -> bool:
    """True when the library carries the ABI-3 fused crop + augment + project."""
    lib = _load()
    return lib is not None and lib.elo_abi_version() >= FUSED_ABI


def read_scan(path: str, num_points: int) -> np.ndarray:
    """A ``velodyne/*.bin`` scan (float32 N x 4) as (num_points, 3) float32,
    truncated or zero-padded.  ``FileNotFoundError`` if it cannot be read."""
    lib = _load()
    if lib is None:
        return _read_scan_numpy(path, num_points)
    out = np.zeros((num_points, 3), dtype=np.float32)
    if lib.elo_read_scan(path.encode(), out.ctypes.data_as(_F), num_points) < 0:
        raise FileNotFoundError(path)
    return out


def read_batch(paths: List[str], num_points: int, num_threads: int = 8) -> np.ndarray:
    """(len(paths), num_points, 3) float32, decoded in parallel."""
    lib = _load()
    if lib is None:
        return np.stack([_read_scan_numpy(p, num_points) for p in paths])
    b = len(paths)
    out = np.zeros((b, num_points, 3), dtype=np.float32)
    counts = np.zeros((b,), dtype=np.int64)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    rc = lib.elo_read_batch(arr, b, out.ctypes.data_as(_F), num_points,
                            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), num_threads)
    if rc != 0:
        raise FileNotFoundError(f"failed to read scans: {[p for p, c in zip(paths, counts) if c < 0]}")
    return out


def _fov(sensor):
    return math.radians(sensor.vertical_fov_up_deg), math.radians(sensor.vertical_fov_down_deg)


def project_batch(points: np.ndarray, height: int, width: int, sensor, crop_radius: float = 0.0,
                  num_threads: int = 8) -> np.ndarray:
    """Host projection (B, N, 3) -> (B, H, W, 3) float32 with the exact
    semantics of ``ops.projection.project_to_range_image(method="sort")``
    (up to libm ulps of atan2 / asin at pixel borders).  ``crop_radius > 0``
    also applies the network's planar crop."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    b, n = points.shape[0], points.shape[1]
    up, down = _fov(sensor)
    lib = _load()
    if lib is None:
        return np.stack([_project_scan_numpy(points[i], height, width, up, down, crop_radius)
                         for i in range(b)])
    out = np.zeros((b, height, width, 3), dtype=np.float32)
    lib.elo_project_batch(points.ctypes.data_as(_F), b, n, out.ctypes.data_as(_F), height, width,
                          up, down, crop_radius, num_threads)
    return out


def project_scan(points: np.ndarray, height: int, width: int, sensor, crop_radius: float = 0.0,
                 num_threads: int = 4) -> np.ndarray:
    """One scan (N, 3) -> (H, W, 3) float32, chunk-parallel over
    ``num_threads`` (private planes merged in index order: the sequential
    result, bit for bit)."""
    return project_batch(points[None], height, width, sensor, crop_radius, num_threads)[0]


def augment_project_batch_native(points: np.ndarray, T: np.ndarray, apply: np.ndarray,
                                 height: int, width: int, sensor,
                                 ysign: Optional[np.ndarray] = None,
                                 num_threads: int = 4) -> np.ndarray:
    """Fused mirror -> crop -> SE(3) perturbation -> projection of one frame
    of a training batch, (B, N, 3) raw clouds -> (B, H, W, 3), in one
    streaming pass per cloud.  ``T`` (B, 4, 4) perturbations, applied where
    ``apply`` (B,) is set; ``ysign`` (B,) +1 / -1 reflects y before the
    perturbation (``mirror_batch(clouds=False)``); the planar crop at
    ``sensor.max_planar_radius`` is taken on the raw coordinates, as
    ``crop_and_augment`` + ``project_batch`` do.  Needs ``fused_available()``."""
    if not fused_available():
        raise RuntimeError(f"fused native op unavailable (need ABI >= {FUSED_ABI})")
    lib = _load()
    points = np.ascontiguousarray(points, dtype=np.float32)
    T = np.ascontiguousarray(T, dtype=np.float32)
    apply = np.ascontiguousarray(apply, dtype=np.uint8)
    b, n = points.shape[0], points.shape[1]
    if T.shape != (b, 4, 4) or apply.shape != (b,):
        raise ValueError(f"T {T.shape} and apply {apply.shape} must match a batch of {b}")
    up, down = _fov(sensor)
    out = np.zeros((b, height, width, 3), dtype=np.float32)
    if ysign is None:
        ysign_p = ctypes.cast(None, _F)
    else:
        ysign = np.ascontiguousarray(ysign, dtype=np.float32)
        if ysign.shape != (b,):
            raise ValueError(f"ysign {ysign.shape} must match a batch of {b}")
        ysign_p = ysign.ctypes.data_as(_F)
    lib.elo_augment_project_batch(points.ctypes.data_as(_F), T.ctypes.data_as(_F),
                                  apply.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ysign_p,
                                  b, n, float(sensor.max_planar_radius), out.ctypes.data_as(_F),
                                  height, width, up, down, num_threads)
    return out


def _project_scan_numpy(points, height, width, up, down, crop_radius):
    """Numpy twin of ``elo_project_scan`` (a lexsort by pixel, range, index)."""
    az_res = 2.0 * np.pi / width
    v_res = (up - down) / max(height - 1, 1)
    v_off = -down / v_res

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r_sq = x * x + y * y + z * z
    valid = r_sq > 1e-10
    if crop_radius > 0.0:
        valid &= x * x + y * y <= np.float32(crop_radius) ** 2
    r = np.sqrt(np.where(valid, r_sq, 1.0), dtype=np.float32)

    col = ((np.float32(np.pi) - np.arctan2(y, x)) / np.float32(az_res)).astype(np.int32)
    beta = np.arcsin(np.clip(z / r, -1.0, 1.0))
    row = height - (beta / np.float32(v_res) + np.float32(v_off)).astype(np.int32)
    row = np.clip(row, 0, height - 1)
    col = np.clip(col, 0, width - 1)

    num_pix = height * width
    pix = np.where(valid, row * width + col, num_pix)
    order = np.lexsort((np.arange(len(points)), r, pix))
    pix_s = pix[order]
    first = np.ones(len(points), dtype=bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    win_pix = pix_s[first]
    win_idx = order[first]
    keep = win_pix < num_pix

    img = np.zeros((num_pix, 3), dtype=np.float32)
    img[win_pix[keep]] = points[win_idx[keep]]
    return img.reshape(height, width, 3)


def _read_scan_numpy(path: str, num_points: int) -> np.ndarray:
    """Numpy twin of ``elo_read_scan``."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    out = np.zeros((num_points, 3), dtype=np.float32)
    out[: min(len(pts), num_points)] = pts[:num_points]
    return out
