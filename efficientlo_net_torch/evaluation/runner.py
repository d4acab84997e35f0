"""Sequence evaluation: the network over a KITTI sequence, the trajectory,
and its RPE metrics, in one process.

The port's copy of ``efficientlo_net_tpu/evaluation/runner.py``.  The eval
steps take the model (a ``PWCLONet`` on its device) in place of the JAX
package's parameters and batch statistics.  Scans go to the device as int16
(``quantize_points``, 1.25 mm), as the JAX runner sends them, and the steps
dequantize.  The last partial batch is padded with repeats of its last row;
frame 0 pairs with itself.

Spans of the streaming prediction (``utils.profiling``): ``eval.batch`` (its
id the batch's first frame) with ``eval.wait_scans``, ``eval.to_device``,
``eval.splice`` and ``eval.poses_to_host`` around the steps' own, and
``eval.read_block`` (its id the block's first frame) in the reader thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.kitti import SEQ_LENGTH_TABLE, SEQ_NAMES, OdometryDataset, load_tr
from ..data.loader import PrefetchLoader, quantize_points, to_device
from ..utils.profiling import span
from .kitti_metrics import (SequenceResult, evaluate_sequence, load_poses, poses_from_rows,
                            save_sequence_errors)
from .odometry import integrate_sequence, save_kitti_trajectory
from .plots import write_all_plots


def sequence_indices(seq: int) -> np.ndarray:
    return np.arange(SEQ_LENGTH_TABLE[seq], SEQ_LENGTH_TABLE[seq + 1])


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def predict_sequence(eval_step, model, dataset: OdometryDataset, seq: int, batch_size: int = 8,
                     num_workers: int = 4, progress=None) -> tuple:
    """``eval_step(model, batch)`` (``training.step.make_eval_step``) over
    every frame pair of a sequence, each pair projected and encoded on its
    own.  Returns (quats (N, 4), trans (N, 3)) numpy arrays."""
    idxs = sequence_indices(seq)
    n = len(idxs)
    device = _device_of(model)
    loader = PrefetchLoader(dataset, idxs, batch_size, training=False,
                            num_workers=num_workers, drop_last=False)
    quats, trans = [], []
    for bi, batch in enumerate(loader.epoch(0)):
        if progress is not None and bi % 40 == 0:
            progress(f"seq {seq} eval batch {bi}")
        bsz = batch["pc1"].shape[0]
        if bsz < batch_size:  # pad to the batch shape
            batch = {k: np.concatenate([v, np.repeat(v[-1:], batch_size - bsz, axis=0)])
                     for k, v in batch.items()}
        batch = dict(batch, pc1=quantize_points(batch["pc1"]), pc2=quantize_points(batch["pc2"]))
        out = eval_step(model, to_device(batch, device))
        quats.append(out["q"][:bsz].cpu().numpy())
        trans.append(out["t"][:bsz].cpu().numpy())
    return np.concatenate(quats)[:n], np.concatenate(trans)[:n]


def _map_pyramid(fn, *pyramids):
    """``fn`` over the tensors of pyramids (lists of per-level tuples)."""
    return [tuple(fn(*ts) for ts in zip(*levels)) for levels in zip(*pyramids)]


def predict_sequence_streaming(encode_step, correlate_step, model, dataset: OdometryDataset,
                               seq: int, batch_size: int = 8, num_workers: int = 4,
                               progress=None) -> tuple:
    """Pyramid-cached prediction (``training.step.make_streaming_eval_fns``):
    each scan is read, projected and encoded once, and consecutive pyramids
    are correlated in batches shifted by one frame, with the previous
    batch's last pyramid spliced in.  The same poses as ``predict_sequence``
    for about half its work."""
    n = len(sequence_indices(seq))
    device = _device_of(model)
    quats, trans = [], []
    prev_tail = None  # the last real frame's pyramid of the previous batch

    with ThreadPoolExecutor(max_workers=num_workers) as pool, \
            ThreadPoolExecutor(max_workers=1) as reader:

        def read_block(s):
            with span("eval.read_block", id=s):
                frames = list(range(s, min(s + batch_size, n)))
                scans = list(pool.map(lambda f: dataset.read_scan(seq, f), frames))
                bsz = len(scans)
                scans += [scans[-1]] * (batch_size - bsz)  # pad to the batch shape
                return quantize_points(np.stack(scans)), bsz

        def transfer(block):
            # passed straight to the encode step: the block's device copy is
            # freed as the encode returns, not held through the correlation
            with span("eval.to_device"):
                return to_device({"points": block}, device)["points"]

        # double buffer: the next block's disk reads overlap the device's work
        pending = reader.submit(read_block, 0)
        for s in range(0, n, batch_size):
            if progress is not None and (s // batch_size) % 40 == 0:
                progress(f"seq {seq} eval frame {s}/{n}")
            with span("eval.batch", id=s):
                with span("eval.wait_scans"):
                    block, bsz = pending.result()
                if s + batch_size < n:
                    pending = reader.submit(read_block, s + batch_size)
                pyr = encode_step(model, transfer(block))
                with span("eval.splice"):
                    if prev_tail is None:  # frame 0 pairs with itself
                        prev_tail = _map_pyramid(lambda a: a[:1], pyr)
                    # frame s+i pairs with s+i-1
                    pyr_prev = _map_pyramid(lambda tail, cur: torch.cat([tail, cur[:-1]], dim=0),
                                            prev_tail, pyr)
                out = correlate_step(model, pyr, pyr_prev)
                with span("eval.poses_to_host"):
                    quats.append(out["q"][:bsz].cpu().numpy())
                    trans.append(out["t"][:bsz].cpu().numpy())
                prev_tail = _map_pyramid(lambda a: a[bsz - 1:bsz], pyr)
    return np.concatenate(quats)[:n], np.concatenate(trans)[:n]


def evaluate_sequences(eval_step, model, dataset: OdometryDataset, sequences: Sequence[int],
                       gt_dir: str, result_dir: Optional[str] = None, batch_size: int = 8,
                       log=print, make_plots: bool = False,
                       stream_fns=None) -> Dict[int, SequenceResult]:
    """Predict, integrate and score each sequence; returns the results of the
    sequences that have ground truth.  With ``result_dir``, writes each
    trajectory (``XX_pred.txt``, KITTI rows) and its segment errors
    (``XX_errors.txt``), and with ``make_plots`` its plots
    (``XX_eval/``, ``plots.write_all_plots``).  ``stream_fns``
    (``make_streaming_eval_fns``) predicts with cached pyramids in place of
    the pairwise ``eval_step``."""
    results = {}
    for seq in sequences:
        name = SEQ_NAMES[seq]
        tr, _ = load_tr(os.path.join(dataset.root, name, "calib.txt"))
        if stream_fns is not None:
            q, t = predict_sequence_streaming(stream_fns[0], stream_fns[1], model, dataset, seq,
                                              batch_size, progress=log)
        else:
            q, t = predict_sequence(eval_step, model, dataset, seq, batch_size, progress=log)
        rows = integrate_sequence(q, t, tr)
        if result_dir is not None:
            os.makedirs(result_dir, exist_ok=True)
            save_kitti_trajectory(os.path.join(result_dir, f"{name}_pred.txt"), rows)
        gt_path = os.path.join(gt_dir, f"{name}.txt")
        poses_res = poses_from_rows(rows)
        plot_dir = (os.path.join(result_dir, f"{name}_eval")
                    if make_plots and result_dir is not None else None)
        if not os.path.exists(gt_path):
            log(f"seq{name}: no ground truth, skipping metrics")
            if plot_dir is not None:
                write_all_plots(name, None, poses_res, [], plot_dir)
            continue
        poses_gt = load_poses(gt_path)
        res = evaluate_sequence(poses_gt, poses_res, seq=name)
        results[seq] = res
        log(res.summary())
        if result_dir is not None:
            save_sequence_errors(res.errors, os.path.join(result_dir, f"{name}_errors.txt"))
        if plot_dir is not None:
            write_all_plots(name, poses_gt, poses_res, res.errors, plot_dir)
    return results


def mean_t_rel(results: Dict[int, SequenceResult]) -> float:
    """The validation scalar that picks the best checkpoint."""
    if not results:
        return float("nan")
    return float(np.mean([r.t_rel for r in results.values()]))
