"""Host-side crop, augmentation and projection for host-projected training.

The port's copy of ``efficientlo_net_tpu/data/host_preprocess.py``.  The
input projections carry no gradient, so the loader's worker threads can
crop, perturb and project each pair on the CPU (the native projector,
``data/native_io.py``) while the device computes; the step then takes
dense (B, H, W, 3) images ``p1`` / ``p2`` and derives the ground truth on
the device (``models.preprocess.gt_quat``).

The host projector is exact (nearest point per pixel, the ``sort`` image);
the device path projects with ``packed`` (7.3 mm range steps).  Points that
close in one pixel are the same surface, so both are valid training inputs.
"""

from __future__ import annotations

import numpy as np

from ..config import SensorConfig
from . import native_io

_PASS_THROUGH = ("T_gt", "T_trans", "T_trans_inv", "aug_frame")


def crop_and_augment(pc_f1, pc_f2, T_trans, aug_frame, max_planar_radius=35.0):
    """Numpy twin of the point half of ``models.preprocess.preprocess``: the
    validity mask, the planar crop and the perturbation of frame
    ``aug_frame``.  (B, N, 3) float32 clouds, (B, 4, 4) perturbations, (B,)
    ints; returns (pc1_aug, pc2_aug) with invalid or cropped points at
    exactly (0, 0, 0)."""
    valid1 = np.any(pc_f1 != 0.0, axis=-1)
    valid2 = np.any(pc_f2 != 0.0, axis=-1)
    keep1 = valid1 & (np.linalg.norm(pc_f1[..., :2], axis=-1) <= max_planar_radius)
    keep2 = valid2 & (np.linalg.norm(pc_f2[..., :2], axis=-1) <= max_planar_radius)
    pc1 = pc_f1 * keep1[..., None]
    pc2 = pc_f2 * keep2[..., None]

    rot = T_trans[:, :3, :3]
    trans = T_trans[:, :3, 3]
    # the transform maps padded zeros to the translation: re-zero by the mask
    pc1_t = (np.einsum("bij,bnj->bni", rot, pc1) + trans[:, None, :]) * keep1[..., None]
    pc2_t = (np.einsum("bij,bnj->bni", rot, pc2) + trans[:, None, :]) * keep2[..., None]

    aug1 = (aug_frame == 1)[:, None, None]
    pc1_aug = np.where(aug1, pc1_t, pc1).astype(np.float32)
    pc2_aug = np.where(aug1, pc2, pc2_t).astype(np.float32)
    return pc1_aug, pc2_aug


def augment_project_batch(batch: dict, sensor: SensorConfig, num_threads: int = 2) -> dict:
    """A raw loader batch (``make_batch``: clouds ``pc1`` / ``pc2`` and the
    ground-truth and augmentation fields) to a host-projected one: ``p1`` /
    ``p2`` (B, H, W, 3) float32 images and the other fields unchanged.  An
    optional ``mirror_sign`` (``mirror_batch(clouds=False)``) reflects y of
    both clouds first and is dropped from the output.

    With the ABI-3 library, one fused native pass per cloud
    (``native_io.augment_project_batch_native``); otherwise the two-pass
    path, ``crop_and_augment`` then ``native_io.project_batch``."""
    h, w = sensor.height, sensor.width
    sign = batch.get("mirror_sign")
    if native_io.fused_available():
        # aug_frame 1 perturbs frame 1, 2 frame 2: crop_and_augment
        # transforms pc2 exactly when aug_frame != 1
        aug = np.asarray(batch["aug_frame"])
        p1, p2 = (native_io.augment_project_batch_native(
            batch[key], batch["T_trans"], apply, h, w, sensor, ysign=sign,
            num_threads=2 * num_threads) for key, apply in (("pc1", aug == 1), ("pc2", aug != 1)))
    else:
        pc1_raw, pc2_raw = batch["pc1"], batch["pc2"]
        if sign is not None:
            pc1_raw, pc2_raw = pc1_raw.copy(), pc2_raw.copy()
            pc1_raw[..., 1] *= sign[:, None]
            pc2_raw[..., 1] *= sign[:, None]
        pc1, pc2 = crop_and_augment(pc1_raw, pc2_raw, batch["T_trans"], batch["aug_frame"],
                                    max_planar_radius=sensor.max_planar_radius)
        p1 = native_io.project_batch(pc1, h, w, sensor, num_threads=num_threads)
        p2 = native_io.project_batch(pc2, h, w, sensor, num_threads=num_threads)
    return {"p1": p1, "p2": p2, **{k: batch[k] for k in _PASS_THROUGH}}
