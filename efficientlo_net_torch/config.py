"""Configuration dataclasses for the PyTorch / CUDA port.

The port's own copy of the sensor, network and training hyperparameters of
``efficientlo_net_tpu/config.py`` (the JAX package is the reference and is
never imported here).  Defaults are the full HDL-64 configuration;
``tiny_model_config`` is the scaled-down one the CPU tests use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Cylindrical range-image sensor model (Velodyne HDL-64 by default)."""

    height: int = 64
    width: int = 1800
    vertical_fov_up_deg: float = 2.0
    vertical_fov_down_deg: float = -24.8
    max_planar_radius: float = 35.0  # planar crop applied before projection
    num_points: int = 150000  # zero-padded scan size

    @property
    def azimuth_resolution(self) -> float:
        return (360.0 / self.width) * math.pi / 180.0

    @property
    def vertical_resolution(self) -> float:
        up = self.vertical_fov_up_deg * math.pi / 180.0
        down = self.vertical_fov_down_deg * math.pi / 180.0
        return (up - down) / (self.height - 1)

    @property
    def vertical_pixel_offset(self) -> float:
        down = self.vertical_fov_down_deg * math.pi / 180.0
        return -down / self.vertical_resolution


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PWCLO network hyperparameters (full HDL-64 configuration)."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)

    # Stride pyramid: levels pre1, pre2, l0, l1, l2, l3.
    stride_h: Tuple[int, ...] = (1, 1, 4, 2, 2, 1)
    stride_w: Tuple[int, ...] = (1, 1, 8, 2, 2, 2)

    # Radii.
    down_conv_dis: Tuple[float, ...] = (0.5, 3.0, 6.0, 12.0)
    up_conv_dis: Tuple[float, ...] = (3.0, 6.0, 9.0)
    cost_volume_dis: Tuple[float, ...] = (1.0, 2.0, 4.0)

    # Siamese set-conv pyramid.
    down_kernels: Tuple[Tuple[int, int], ...] = ((9, 15), (7, 11), (5, 9), (5, 9))
    down_K: Tuple[int, ...] = (32, 32, 16, 16)
    down_mlps: Tuple[Tuple[int, ...], ...] = (
        (8, 8, 16),
        (16, 16, 32),
        (32, 32, 64),
        (64, 64, 128),
    )

    # Cost volumes: kernel1 is the self-aggregation window; kernel2 per
    # refinement level l0/l1/l2 plus the coarse "origin" correlation at l2.
    cv_kernel1: Tuple[int, int] = (3, 5)
    cv_kernel2: Tuple[Tuple[int, int], ...] = ((11, 41), (7, 25), (5, 15), (5, 35))
    cv_nsample: int = 4
    cv_nsample_q: Tuple[int, ...] = (6, 6, 6, 32)
    cv_mlp1: Tuple[int, ...] = (128, 64, 64)
    cv_mlp2: Tuple[int, ...] = (128, 64)

    # The down_conv that pools the coarse cost volume to l3.
    cv_down_mlp: Tuple[int, ...] = (128, 64, 64)

    # up_conv layers.
    up_kernel: Tuple[int, int] = (7, 15)
    up_nsample: int = 8
    up_mlp1: Tuple[int, ...] = (128, 64)
    up_mlp2: Tuple[int, ...] = (128, 64)

    # flow_predictor MLPs.
    predictor_mlp: Tuple[int, ...] = (128, 64)

    # Pose head.
    head_dim: int = 256
    dropout_rate: float = 0.5

    # Compute dtype of the MLP stacks ("float32" or "bfloat16").  Parameters,
    # batch-norm statistics, the softmaxes, the pose heads and the
    # quaternion algebra stay float32.
    compute_dtype: str = "float32"

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(H, W) for levels [pre1, pre2, l0, l1, l2, l3] (ceil-division
        chain over the strides)."""
        h = _ceil_div(self.sensor.height, self.stride_h[0])
        w = _ceil_div(self.sensor.width, self.stride_w[0])
        shapes = [(h, w)]
        for i in range(1, 6):
            h = _ceil_div(h, self.stride_h[i])
            w = _ceil_div(w, self.stride_w[i])
            shapes.append((h, w))
        return tuple(shapes)

    def validate(self) -> None:
        assert len(self.level_shapes) == 6


def tiny_model_config(height: int = 16, width: int = 128, num_points: int = 2048) -> ModelConfig:
    """A scaled-down config for CPU tests."""
    sensor = SensorConfig(height=height, width=width, num_points=num_points)
    return ModelConfig(
        sensor=sensor,
        stride_h=(1, 1, 2, 2, 1, 1),
        stride_w=(1, 1, 4, 2, 2, 2),
        down_kernels=((3, 5), (3, 5), (3, 3), (3, 3)),
        down_K=(8, 8, 4, 4),
        down_mlps=((4, 4, 8), (8, 8, 16), (16, 16, 32), (32, 32, 64)),
        cv_kernel1=(3, 3),
        cv_kernel2=((3, 7), (3, 5), (3, 3), (3, 5)),
        cv_nsample=4,
        cv_nsample_q=(4, 4, 4, 8),
        cv_mlp1=(32, 16, 16),
        cv_mlp2=(32, 16),
        cv_down_mlp=(32, 16, 16),
        up_kernel=(3, 5),
        up_nsample=4,
        up_mlp1=(32, 16),
        up_mlp2=(32, 16),
        predictor_mlp=(32, 16),
        head_dim=64,
    )


# Common spinning-LiDAR models as projection presets.  The network defaults
# (strides, kernels, radii) are tuned for the 64x1800 grid; for much coarser
# sensors, shrink the pyramid as ``tiny_model_config`` does.
SENSOR_PRESETS = {
    "hdl64": SensorConfig(),
    "hdl32e": SensorConfig(
        height=32, width=1800,
        vertical_fov_up_deg=10.67, vertical_fov_down_deg=-30.67,
        num_points=80000,
    ),
    "vlp16": SensorConfig(
        height=16, width=1800,
        vertical_fov_up_deg=15.0, vertical_fov_down_deg=-15.0,
        num_points=40000,
    ),
    "os1_64": SensorConfig(
        height=64, width=1024,
        vertical_fov_up_deg=16.6, vertical_fov_down_deg=-16.6,
        num_points=70000,
    ),
}


def sensor_preset(name: str) -> SensorConfig:
    try:
        return SENSOR_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown sensor preset {name!r}; have {sorted(SENSOR_PRESETS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters, the port's copy of the JAX package's
    ``TrainConfig`` (same defaults).  The schedules are in
    ``training/state.py``."""

    batch_size: int = 8
    base_learning_rate: float = 1e-3
    lr_decay_step: int = 200000  # in samples
    lr_decay_rate: float = 0.7
    lr_floor: float = 1e-5
    optimizer: str = "adam"  # "adam" | "momentum"
    momentum: float = 0.9
    max_epoch: int = 1000

    # Batch-norm EMA decay schedule.
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_step: int = 200000
    bn_decay_clip: float = 0.99

    # Initial values of the learned homoscedastic loss weights.
    w_x_init: float = 0.0
    w_q_init: float = -2.5

    # int16 point transfer (data/loader.py quantize_points): the trainer
    # sends clouds at 1.25 mm steps, half the host-to-device bytes.
    quantized_transfer: bool = False

    # Host-projected training (data/host_preprocess.py): the loader's
    # workers crop, perturb and project on the CPU with the native
    # projector, and the step takes dense range images.  None = auto: on
    # whenever the native library loads (resolved_host_projection).
    host_projection: Optional[bool] = None

    # Decoded-scan RAM cache of the training dataset (data/kitti.py): each
    # scan is read twice an epoch (frame t of one pair, t-1 of the next).
    cache_decoded_scans: bool = True

    def resolved_host_projection(self) -> bool:
        """``host_projection``, with None resolved to whether the native
        library is available.  That asks ``data.native_io.available()``,
        which builds the library with the host compiler on its first call
        (a few seconds) and raises if a present compiler fails."""
        if self.host_projection is not None:
            return self.host_projection
        from .data import native_io

        return native_io.available()
