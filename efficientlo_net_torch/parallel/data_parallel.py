"""Data-parallel training: parameters replicated, the batch split over the
``data`` dimension of a mesh, gradients all-reduced.

The port's copy of ``efficientlo_net_tpu/parallel/data_parallel.py``.  JAX
compiles one step over the sharded batch and lets XLA place the reductions;
here each process runs ``training.step.make_train_step`` on its rows with
the data group, which makes batch norm normalize over the global batch
(``models/layers.py``), draws dropout for the global batch, and averages
the gradients of the network, ``w_x`` and ``w_q`` with one flat all-reduce
after ``backward()``.  ``DistributedDataParallel`` is not used: it would
miss ``w_x`` and ``w_q``, which live outside the network, and its buffer
broadcast would fight the synchronized statistics.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, TrainConfig
from ..training.state import TrainState
from ..training.step import make_train_step
from .distributed import broadcast_, broadcast_object
from .mesh import DATA_AXIS, axis_group, replicated


def make_sharded_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh,
                            host_projected: bool = False):
    """The train step of one rank of a data-parallel run: ``train_step(state,
    batch, generator, stage=None)`` as ``make_train_step``'s, where
    ``batch`` holds this rank's rows of the global batch (``mesh.shard_batch``)
    and ``train_cfg.batch_size`` is the global batch.  ``mesh``: a
    ``DeviceMesh`` with a "data" dimension, or the data group itself.  Every
    rank passes a generator seeded alike and gets the same new state and
    the global metrics.  On one rank it is the single-process step."""
    return make_train_step(model_cfg, train_cfg, host_projected=host_projected,
                           data_group=axis_group(mesh, DATA_AXIS))


@torch.no_grad()
def replicate_state(state: TrainState, mesh) -> TrainState:
    """Make every rank's ``state`` rank 0's, in place: the network's
    parameters and batch-norm statistics, ``w_x``, ``w_q``, the optimizer's
    state and the step count, broadcast over the mesh (a ``DeviceMesh`` or a
    process group).  Every rank must hold a state of the same structure (an
    optimizer state for the same parameters).  Returns ``state``."""
    group = replicated(mesh)
    for tensor in state.model.state_dict().values():
        broadcast_(tensor, 0, group)
    broadcast_(state.w_x.data, 0, group)
    broadcast_(state.w_q.data, 0, group)
    opt_state = state.optimizer.state_dict()["state"]
    for index in sorted(opt_state):
        for key in sorted(opt_state[index]):
            value = opt_state[index][key]
            if torch.is_tensor(value):
                broadcast_(value, 0, group)
    state.step = int(broadcast_object(int(state.step), 0, group))
    return state
