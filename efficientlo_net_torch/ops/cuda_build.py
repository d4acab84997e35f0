"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes.  Libraries are built
at first use into ``efficientlo_net_torch/_build/`` (git-ignored), named by a
hash of the source and flags, so an edited source is rebuilt.  ``build``
starts one ``nvcc`` per source, all at once, and waits for all of them; the
first ``load`` builds every missing library of ``SOURCES`` in that one call,
so a second source adds no ``nvcc`` in series to a checkout's first run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("window_select.cu", "bn_relu.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas register / spill report of each source built by this process
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``; raises if the CUDA toolkit cannot be found."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "efficientlo_net_torch are built from source at first use"
        )
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs[src] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        build_logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {src: library_path(src) for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (one of ``SOURCES``), built first,
    with every other missing library of ``SOURCES``, if needed."""
    if source not in _loaded:
        path = build()[source]
        _loaded[source] = ctypes.CDLL(str(path))
    return _loaded[source]
