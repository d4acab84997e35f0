"""Checkpoints with resume metadata and best-model retention.

The port's copy of ``efficientlo_net_tpu/training/checkpoint.py``, with the
same public surface and layout of metadata.  A checkpoint is one
``torch.save`` file per step, ``ckpt_{step}.pt``: the network's state dict
(parameters and batch-norm statistics), ``w_x``, ``w_q``, the optimizer's
state dict and ``step``.  It is written under a temporary name and renamed,
so a crash never leaves half a checkpoint, and read with
``weights_only=True``.  The latest ``max_to_keep`` steps stay in rotation;
the best model has its own single slot in ``best/``, which rotation never
evicts.  ``meta_{step}.json`` holds the epoch and metrics of a step,
``best.json`` the best ``{"val_t_rel", "step"}``.

Multi-process runs (``parallel/distributed.py``): the state is replicated,
so process 0 alone creates the directories and writes every file, between
two barriers: none writes while another process may still read what the
write replaces, and none reads a file before it is whole.  Every process
restores.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import process_count, process_index
from .state import TrainState

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def _barrier(name: str) -> None:
    """All processes meet here (nothing with one process).  ``name`` says
    which write the barrier closes; torch.distributed needs no name."""
    if process_count() > 1:
        if dist.get_backend() == dist.Backend.NCCL:
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _is_primary() -> bool:
    return process_index() == 0


def _steps(directory: str) -> List[int]:
    """The steps saved in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def _write(directory: str, state: TrainState) -> None:
    payload = {
        "model": state.model.state_dict(),
        "w_x": state.w_x.detach(),
        "w_q": state.w_q.detach(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    path = _path(directory, int(state.step))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read(directory: str, step: int, state: TrainState) -> TrainState:
    """Load step ``step`` into ``state`` in place (its tensors keep their
    device); returns it."""
    payload = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    with torch.no_grad():
        state.w_x.copy_(payload["w_x"])
        state.w_q.copy_(payload["w_q"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")
        if _is_primary():
            os.makedirs(self._best_dir, exist_ok=True)
        _barrier("ckpt_dir")
        self._best_path = os.path.join(self.directory, "best.json")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"meta_{step}.json")

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def save(self, state: TrainState, metrics: Optional[dict] = None,
             epoch: Optional[int] = None) -> int:
        """Persist the state once per step (a second save of a step rewrites
        only its metadata), then evict the oldest steps beyond
        ``max_to_keep``.  Returns the step."""
        step = int(state.step)
        _barrier("ckpt_save")
        if _is_primary():
            if step not in self.all_steps():
                _write(self.directory, state)
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(_path(self.directory, old))
            meta = {"epoch": epoch}
            if metrics:
                meta.update(metrics)
            with open(self._meta_path(step), "w") as f:
                json.dump(meta, f)
        _barrier("ckpt_meta")
        return step

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default the latest) into ``state``; returns it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return _read(self.directory, step, state)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: Optional[int] = None) -> dict:
        """The epoch and metrics saved with a step; {} if absent."""
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self._meta_path(step)):
            return {}
        with open(self._meta_path(step)) as f:
            return json.load(f)

    # --- the best model -----------------------------------------------------
    def best_error(self) -> float:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)["val_t_rel"]
        return float("inf")

    def mark_best(self, step: int, val_t_rel: float, state: Optional[TrainState] = None) -> None:
        """Record ``step`` as the best model.  With ``state``, also copy it
        into the ``best/`` slot, which rotation never evicts (without it,
        only ``best.json`` changes: valid while the step is in rotation)."""
        _barrier("ckpt_mark_best")
        if _is_primary():
            if state is not None:
                _write(self._best_dir, state)
                for old in _steps(self._best_dir):
                    if old != int(state.step):
                        os.remove(_path(self._best_dir, old))
            with open(self._best_path, "w") as f:
                json.dump({"val_t_rel": val_t_rel, "step": step}, f)
        _barrier("ckpt_best")

    def restore_best(self, state: TrainState) -> TrainState:
        """Load the best model: the ``best/`` slot, else the rotation step
        that ``best.json`` names."""
        steps = _steps(self._best_dir)
        if steps:
            return _read(self._best_dir, steps[-1], state)
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return self.restore(state, json.load(f)["step"])
        raise FileNotFoundError(f"no best checkpoint in {self.directory}")

    def maybe_save_best(self, state: TrainState, val_t_rel: float,
                        epoch: Optional[int] = None) -> bool:
        """Save and mark best when ``val_t_rel`` improves on the best."""
        if not np.isfinite(val_t_rel) or val_t_rel >= self.best_error():
            return False
        step = self.save(state, metrics={"val_t_rel": val_t_rel}, epoch=epoch)
        self.mark_best(step, val_t_rel, state=state)
        return True
