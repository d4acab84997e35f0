"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for CUDA when no card is present
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
