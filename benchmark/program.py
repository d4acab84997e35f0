"""What the benchmark takes from the program under test
(``efficientlo_net_torch``): its configuration objects and its model
loaded from the weights file a configuration names.  The program is
imported inside these functions only; the drivers call its entries."""

from __future__ import annotations

import dataclasses
from typing import Dict

from .harness import ROOT


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def model_config(config: Dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from efficientlo_net_torch.config import ModelConfig, SensorConfig

    return ModelConfig(sensor=SensorConfig(**config["sensor"]),
                       compute_dtype=config["compute_dtype"],
                       **{k: _tuples(v) for k, v in config["model"].items()})


def train_config(traffic: Dict):
    """The program's ``TrainConfig`` of a training mix: its batch size and
    the hyperparameters the mix states; every other field at its default."""
    from efficientlo_net_torch.config import TrainConfig

    names = {f.name for f in dataclasses.fields(TrainConfig)}
    hp = {k: v for k, v in traffic["hyperparameters"].items() if k in names}
    return TrainConfig(batch_size=traffic["batch_size"], **hp)


def load_model(config: Dict, device):
    """``PWCLONet`` of the configuration with its weights file, in eval mode
    on ``device``."""
    from efficientlo_net_torch.pretrained import load_model as load

    model, _ = load(str(ROOT / config["weights"]), model_config(config), device=device)
    return model
