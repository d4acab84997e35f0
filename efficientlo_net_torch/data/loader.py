"""int16 point transfer: the quantization the JAX package's loader applies
before the host-to-device copy (``TrainConfig.quantized_transfer``).  The
train step dequantizes (``training.step._forward_inputs``).  The loader
itself comes with the trainer slice."""

from __future__ import annotations

import numpy as np

POINT_QUANT_SCALE = 800.0  # 1.25 mm steps, range ±40.9 m


def quantize_points(x: np.ndarray) -> np.ndarray:
    """Point coordinates to int16 at 1/``POINT_QUANT_SCALE`` m."""
    return np.clip(np.rint(x * POINT_QUANT_SCALE), -32767, 32767).astype(np.int16)
