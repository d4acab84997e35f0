"""The training loop: epochs over shuffled frame pairs, periodic validation
on whole sequences, checkpoints with best-model retention, scalar logs.

The port's copy of ``efficientlo_net_tpu/training/trainer.py``, on
``device`` (the current card by default).  In a multi-process run
(``parallel/distributed.py``, one process per device) with ``use_mesh``,
it trains data-parallel over a ``data`` mesh of every process: the state is
replicated from process 0, every process loads the same global batch from
the same seeded loader and keeps its rows, and validation splits the
sequences over the processes and aggregates the metric.  Batches
come from ``PrefetchLoader``, whose workers also quantize (with
``quantized_transfer``) and, for a CUDA device, stage each batch in pinned
memory, through ``device_prefetch``.  With host projection
(``TrainConfig.resolved_host_projection()``: by default, whenever the
native library loads) the workers also crop, perturb and project each
pair, and the step takes the images; otherwise the device projects the
clouds.  Validation always projects on the device.  Each epoch's dropout
masks and scan orders come from one ``torch.Generator`` on the state's
device, seeded from ``SeedSequence([seed, epoch])``, so a restored run
continues as the uninterrupted one would.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data.kitti import SEQ_LENGTH_TABLE, OdometryDataset
from ..data.loader import (PrefetchLoader, device_prefetch, pin_batch, quantize_points,
                           to_device)
from ..device import resolve_device
from ..evaluation.runner import evaluate_sequences, mean_t_rel
from ..models.pwclo import PWCLONet
from ..parallel.data_parallel import make_sharded_train_step, replicate_state
from ..parallel.distributed import (aggregate_mean_t_rel, process_count, process_index,
                                    shard_sequences_by_host)
from ..parallel.mesh import make_mesh, shard_batch
from ..pretrained import load_pretrained, variables_to_state_dict
from ..utils.logging import Logger
from .checkpoint import CheckpointManager
from .state import bn_momentum_schedule, create_train_state, lr_schedule
from .step import make_eval_step, make_streaming_eval_fns, make_train_step

LOG_EVERY = 50  # batches


def train_indices_for(sequences: Sequence[int]) -> np.ndarray:
    """All global frame indices of the given sequences."""
    return np.concatenate([np.arange(SEQ_LENGTH_TABLE[s], SEQ_LENGTH_TABLE[s + 1])
                           for s in sequences])


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, data_root: str,
                 log_dir: str, gt_dir: Optional[str] = None,
                 train_list: Sequence[int] = tuple(range(7)),
                 val_list: Sequence[int] = tuple(range(7, 11)), seed: int = 0,
                 device="cuda", use_mesh: bool = True):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        rank = process_index()
        # every process logs; process 0 to the log the JAX package writes
        self.logger = Logger(os.path.join(log_dir, "log_train.txt" if rank == 0
                                          else f"log_train_rank{rank}.txt"))
        if rank == 0:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump({"model": dataclasses.asdict(model_cfg),
                           "train": dataclasses.asdict(train_cfg)}, f, indent=2, default=str)
        self.gt_dir = gt_dir or os.path.join(os.path.dirname(os.path.abspath(data_root)),
                                             "ground_truth_pose")
        self.train_list = list(train_list)
        self.val_list = list(val_list)
        self.seed = seed
        self.start_epoch = 0  # advanced by restore()

        self.dataset = OdometryDataset(data_root, num_points=model_cfg.sensor.num_points,
                                       gt_pose_dir=self.gt_dir,
                                       cache_scans=train_cfg.cache_decoded_scans)
        with torch.random.fork_rng(devices=[]):  # the network's init, from the seed
            torch.manual_seed(seed)
            model = PWCLONet(model_cfg)
        self.state = create_train_state(model, train_cfg, device=self.device)
        self.ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
        self.host_projection = train_cfg.resolved_host_projection()
        self.mesh = None
        if use_mesh and process_count() > 1:
            self.mesh = make_mesh(device_type=self.device.type)
            self.state = replicate_state(self.state, self.mesh)
            self.train_step = make_sharded_train_step(model_cfg, train_cfg, self.mesh,
                                                      host_projected=self.host_projection)
        else:
            self.train_step = make_train_step(model_cfg, train_cfg,
                                              host_projected=self.host_projection)
        self.eval_step = make_eval_step(model_cfg)
        self.stream_eval_fns = make_streaming_eval_fns(model_cfg)

    def restore(self, step: Optional[int] = None, path: Optional[str] = None) -> None:
        """Restore the state and resume at the epoch after the saved one;
        ``path`` is another run's checkpoint directory (a warm start)."""
        mgr = self.ckpt if path is None else CheckpointManager(os.path.abspath(path))
        self.state = mgr.restore(self.state, step)
        if self.mesh is not None:
            self.state = replicate_state(self.state, self.mesh)
        saved_epoch = mgr.metadata(step).get("epoch")
        if saved_epoch is not None:
            self.start_epoch = int(saved_epoch) + 1
        self.logger.log(f"restored checkpoint at step {self.state.step} "
                        f"(resuming at epoch {self.start_epoch})")

    def load_pretrained(self, path: str) -> dict:
        """Load a weight artifact (``pretrained/*.msgpack``) into the network:
        its weights and batch-norm statistics replace the network's; the
        optimizer state, ``step``, ``w_x`` and ``w_q`` keep their values (an
        artifact carries no training state; ``restore`` resumes exactly).
        Returns the artifact's metadata."""
        variables, meta = load_pretrained(path)
        self.state.model.load_state_dict(variables_to_state_dict(variables), strict=True)
        self.logger.log(f"loaded pretrained artifact {path} "
                        f"(epochs={meta.get('trained_epochs')}, params={meta.get('param_count')})")
        return meta

    def _host_batch(self, batch: dict) -> dict:
        """The loader workers' last step: this process's rows of the global
        batch on a mesh; int16 clouds (or, host-projected, images) with
        ``quantized_transfer``; pinned tensors for a CUDA device."""
        if self.mesh is not None:
            batch = shard_batch(self.mesh, batch)
        if self.train_cfg.quantized_transfer:
            keys = ("p1", "p2") if self.host_projection else ("pc1", "pc2")
            batch = dict(batch, **{k: quantize_points(batch[k]) for k in keys})
        return pin_batch(batch) if self.device.type == "cuda" else batch

    def train_one_epoch(self, epoch: int, limit_batches: Optional[int] = None) -> float:
        """Train on the epoch's batches (the first ``limit_batches``).
        Returns the mean of the losses logged, one every ``LOG_EVERY``
        batches."""
        loader = PrefetchLoader(self.dataset, train_indices_for(self.train_list),
                                self.train_cfg.batch_size, training=True, seed=self.seed,
                                transform=self._host_batch,
                                host_projection_sensor=(self.model_cfg.sensor
                                                        if self.host_projection else None))
        lr_at = lr_schedule(self.train_cfg)
        bn_at = bn_momentum_schedule(self.train_cfg)
        epoch_seed = np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0]
        generator = torch.Generator(self.device).manual_seed(int(epoch_seed))
        losses = []
        t_epoch = time.time()
        batches = device_prefetch(loader.epoch(epoch), lambda b: to_device(b, self.device))
        for bi, batch in enumerate(batches):
            if limit_batches is not None and bi >= limit_batches:
                break
            self.state, metrics = self.train_step(self.state, batch, generator)
            if bi % LOG_EVERY == 0:
                loss = metrics["loss"].item()
                losses.append(loss)
                step = self.state.step
                self.logger.log(f"epoch {epoch} batch {bi}/{len(loader)} loss {loss:.4f}")
                self.logger.scalar("loss", loss, step)
                for name in ("l0_loss", "l1_loss", "l2_loss", "l3_loss"):
                    self.logger.scalar(name, metrics[name].item(), step)
                self.logger.scalar("learning_rate", lr_at(step), step)
                self.logger.scalar("bn_decay", bn_at(step), step)
        batches.close()  # abandons the loader's epoch when limit_batches cut it
        mean = float(np.mean(losses)) if losses else float("nan")
        self.logger.log(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s "
                        f"mean-sampled-loss {mean:.4f}")
        return mean

    def validate(self) -> float:
        """Mean t_rel (%) over the validation sequences, by streaming eval;
        in a multi-process run each process scores its share of the
        sequences and every process returns the aggregate."""
        results = evaluate_sequences(
            self.eval_step, self.state.model, self.dataset,
            shard_sequences_by_host(self.val_list), gt_dir=self.gt_dir,
            result_dir=os.path.join(self.log_dir, "val"), batch_size=self.train_cfg.batch_size,
            log=self.logger.log, stream_fns=self.stream_eval_fns)
        if process_count() > 1:
            return aggregate_mean_t_rel(results)
        return mean_t_rel(results)

    def fit(self, max_epoch: Optional[int] = None) -> None:
        """Train from ``start_epoch``; validate every 20 epochs up to epoch
        100 and every 2 after, then save, and mark best on improvement."""
        max_epoch = max_epoch or self.train_cfg.max_epoch
        for epoch in range(self.start_epoch, max_epoch):
            self.logger.log(f"**** EPOCH {epoch:03d} ****")
            self.train_one_epoch(epoch)
            if (epoch % 20 == 0 and epoch <= 100) or (epoch % 2 == 0 and epoch > 100):
                val = self.validate()
                self.logger.log(f"epoch {epoch} val t_rel {val:.4f}")
                is_best = np.isfinite(val) and val < self.ckpt.best_error()
                step = self.ckpt.save(self.state, metrics={"val_t_rel": val}, epoch=epoch)
                if is_best:
                    self.ckpt.mark_best(step, val, state=self.state)
                    self.logger.log(f"new best model saved (val t_rel {val:.4f})")
