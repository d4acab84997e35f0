"""Eval-mode batch norm and ReLU in one CUDA pass: wrapper, plain version and
the ``efficientlo::bn_relu`` operator.

The source is ``csrc/bn_relu.cu``; it replaces no TPU kernel (XLA fuses the
same chain in the JAX package).  ``bn_relu`` takes CUDA tensors only and
launches on the current stream; ``bn_relu_plain`` is the eager chain that
``models.layers.ScheduledBatchNorm.forward_relu`` runs everywhere else
(``normalize``, the batch norm's formula in every mode, then
``torch.relu``), and the kernel equals it bit for bit.  Each launch counts
``launch.bn_relu`` in ``utils.profiling``.

Importing this module registers ``efficientlo::bn_relu``: the CUDA
implementation is the wrapper (looked up at each call), the CPU
implementation the plain version, and a fake implementation gives the
output's shape, so that ``torch.export`` can trace a network that calls it.
It registers no autograd: the batch norm calls it only with gradients off.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import cuda_build

SOURCE = "bn_relu.cu"
COUNTER = "launch.bn_relu"

_P = ctypes.c_void_p
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.elo_bn_relu.argtypes = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P,
                                    ctypes.c_float, _P, _P]
        lib.elo_bn_relu.restype = ctypes.c_int
        _lib = lib
    return _lib


def normalize(x, mean, var, scale, bias, eps: float):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis, in
    this order: the batch norm's formula, which the kernel follows step by
    step."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def bn_relu_plain(x, mean, var, scale, bias, eps: float):
    """``relu(normalize(...))``, as the eager chain computes it."""
    return torch.relu(normalize(x, mean, var, scale, bias, eps))


def bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``bn_relu_plain`` in one kernel launch: x (..., C) and the (C,)
    vectors float32 on one CUDA device; returns a new contiguous tensor."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"x must be a float32 CUDA tensor, got {x.dtype} on {x.device}")
    c = x.shape[-1]
    params = [p.contiguous() for p in (mean, var, scale, bias)]
    for name, p in zip(("mean", "var", "scale", "bias"), params):
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"{name} must be float32 ({c},) on {x.device}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    err = _library().elo_bn_relu(
        x.data_ptr(), x.numel() // c if c else 0, c, *(p.data_ptr() for p in params),
        float(eps), y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_relu kernel launch failed with CUDA error {err}")
    profiling.count(COUNTER)
    return y


@torch.library.custom_op(
    "efficientlo::bn_relu", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor mean, Tensor var, Tensor scale, Tensor bias, float eps) -> Tensor")
def bn_relu_op(x, mean, var, scale, bias, eps):
    """On the CPU: the plain version (contiguous, as the kernel's output)."""
    return bn_relu_plain(x.contiguous(), mean, var, scale, bias, eps)


@bn_relu_op.register_kernel("cuda")
def _(*args):
    return bn_relu(*args)


@bn_relu_op.register_fake
def _(x, mean, var, scale, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
