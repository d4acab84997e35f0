"""Batches of dataset pairs: the threaded prefetching loader, the
host-to-device step and int16 point transfer.

The port's copy of ``efficientlo_net_tpu/data/loader.py``: worker threads
read scans and draw the augmentation (and, for host-projected training,
crop, perturb and project each pair with the native projector) while the
device computes, into a bounded queue, and batches come out in order.  The
native calls release the GIL, so the workers project in parallel.  Every batch
draws from its own generator, ``default_rng([seed, epoch, batch])``, and the
epoch's shuffle from ``default_rng([seed, epoch])``, so a seed gives the JAX
package's batches exactly.  ``to_device`` is the port's host-to-device step;
``pin_batch``, run in the workers through ``PrefetchLoader(transform=...)``,
stages a batch in pinned memory before the consumer copies it.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from .augmentation import augmentation_batch, mirror_batch
from .host_preprocess import augment_project_batch
from .kitti import OdometryDataset

POINT_QUANT_SCALE = 800.0  # 1.25 mm steps, range ±40.9 m


def quantize_points(x: np.ndarray) -> np.ndarray:
    """Point coordinates to int16 at 1/``POINT_QUANT_SCALE`` m
    (``TrainConfig.quantized_transfer`` and the eval inputs); the steps
    dequantize by dtype (``training.step``)."""
    return np.clip(np.rint(x * POINT_QUANT_SCALE), -32767, 32767).astype(np.int16)


def make_batch(dataset: OdometryDataset, indices: Sequence[int], rng: np.random.Generator,
               training: bool, mirror_clouds: bool = True) -> dict:
    """The pairs at ``indices`` stacked, with their augmentation fields; in
    training, about half of them mirrored (``mirror_batch``).  With
    ``mirror_clouds=False`` the clouds stay unmirrored and the batch carries
    ``mirror_sign`` for the host projector."""
    pc1, pc2, T_gt = zip(*(dataset[int(i)] for i in indices))
    T_trans, T_trans_inv, aug_frame = augmentation_batch(rng, len(indices), training)
    batch = {
        "pc1": np.stack(pc1),
        "pc2": np.stack(pc2),
        "T_gt": np.stack(T_gt),
        "T_trans": T_trans,
        "T_trans_inv": T_trans_inv,
        "aug_frame": aug_frame,
    }
    if training:
        batch = mirror_batch(batch, rng, clouds=mirror_clouds)
    return batch


def pin_batch(batch: dict) -> dict:
    """Host arrays to CPU tensors in pinned (page-locked) memory, so that
    ``to_device`` copies them to the card with no staging copy of its own."""
    return {key: torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
            for key, value in batch.items()}


def to_device(batch: dict, device) -> dict:
    """Host arrays (or CPU tensors) to tensors on ``device``.  For a CUDA
    device each is staged in pinned host memory, unless it is pinned
    already (``pin_batch``), and copied with ``non_blocking=True``, so the
    copy runs as a DMA behind the work already queued on the stream; for
    the CPU, a plain ``.to(device)``."""
    dev = torch.device(device)
    out = {}
    for key, value in batch.items():
        x = value if torch.is_tensor(value) else torch.from_numpy(np.ascontiguousarray(value))
        if dev.type == "cuda":
            out[key] = (x if x.is_pinned() else x.pin_memory()).to(dev, non_blocking=True)
        else:
            out[key] = x.to(dev)
    return out


def device_prefetch(iterator, prepare, depth: int = 2):
    """Yield ``prepare(batch)`` for each batch, preparing ``depth`` batches
    ahead, so that a batch's host-to-device copy is issued while the device
    still runs the previous step."""
    buf = collections.deque()
    for batch in iterator:
        buf.append(prepare(batch))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class PrefetchLoader:
    """Batches of dataset indices, made by worker threads into a bounded
    queue and yielded in order.  Deterministic given ``seed``.  With
    ``host_projection_sensor`` (a ``SensorConfig``) the workers emit
    host-projected batches (``host_preprocess.augment_project_batch``:
    images ``p1`` / ``p2`` in place of the clouds).  ``transform``, when
    given, then maps each batch in the worker that made it (the trainer's
    int16 quantization and pinned staging), off the consumer's thread."""

    def __init__(self, dataset: OdometryDataset, indices: Sequence[int], batch_size: int,
                 training: bool, seed: int = 0, num_workers: int = 4, prefetch: int = 8,
                 drop_last: bool = True, transform: Optional[Callable[[dict], dict]] = None,
                 host_projection_sensor=None):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.training = training
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.transform = transform
        self.host_projection_sensor = host_projection_sensor

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng([self.seed, epoch])
        order = self.indices.copy()
        if self.training:
            rng.shuffle(order)
        nb = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        task_q: "queue.Queue" = queue.Queue()
        for bi in range(nb):
            task_q.put((bi, order[bi * self.batch_size:(bi + 1) * self.batch_size]))

        results = {}
        lock = threading.Lock()
        stop = threading.Event()  # set when the consumer abandons the epoch

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = task_q.get_nowait()
                except queue.Empty:
                    return
                brng = np.random.default_rng([self.seed, epoch, bi])
                host_proj = self.host_projection_sensor is not None
                try:
                    batch = make_batch(self.dataset, idxs, brng, self.training,
                                       mirror_clouds=not host_proj)
                    if host_proj:
                        batch = augment_project_batch(batch, self.host_projection_sensor)
                    if self.transform is not None:
                        batch = self.transform(batch)
                except Exception as exc:  # raised by the consumer, in order
                    batch = exc
                with lock:
                    results[bi] = batch
                # a bounded put must not hold a worker after abandonment
                while not stop.is_set():
                    try:
                        out_q.put(bi, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        next_emit = 0
        try:
            while next_emit < nb:
                out_q.get()
                ready = []
                with lock:
                    while next_emit in results:
                        ready.append(results.pop(next_emit))
                        next_emit += 1
                for batch in ready:
                    if isinstance(batch, Exception):
                        raise batch
                    yield batch
        finally:
            stop.set()
            try:
                while True:  # unblock any worker mid-put
                    out_q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=2.0)
