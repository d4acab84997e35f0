"""Standalone trajectory scorer.

The port's copy of ``efficientlo_net_tpu/evaluation/evaluate_cli.py``, with
the same flags and summary lines: scores existing KITTI trajectory txt files
against ground truth with no model and no device in the loop, writes each
sequence's segment errors and, with ``--plots``, its plots.

    python -m efficientlo_net_torch.evaluation.evaluate_cli \
        --result_dir result --gt_dir ground_truth_pose --eva_seqs 07 08 09 10
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .kitti_metrics import (
    evaluate_sequence,
    load_poses,
    save_sequence_errors,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Score KITTI trajectory files")
    p.add_argument("--result_dir", required=True,
                   help="dir with <seq>_pred.txt trajectory files")
    p.add_argument("--gt_dir", required=True,
                   help="dir with <seq>.txt ground-truth poses")
    p.add_argument("--eva_seqs", nargs="+", required=True,
                   help="sequence names, e.g. 07 08 (or 07_pred, as the "
                        "reference accepts)")
    p.add_argument("--toCameraCoord", action="store_true",
                   help="convert result poses from LiDAR to camera coords "
                        "before scoring (reference --toCameraCoord)")
    p.add_argument("--plots", action="store_true",
                   help="write path/xyz/rpy/error plots per sequence")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_errs, r_errs = [], []
    for name in args.eva_seqs:
        seq = name.removesuffix("_pred")
        pred_path = os.path.join(args.result_dir, f"{seq}_pred.txt")
        gt_path = os.path.join(args.gt_dir, f"{seq}.txt")
        poses_res = load_poses(pred_path, to_camera=args.toCameraCoord)
        poses_gt = load_poses(gt_path)
        res = evaluate_sequence(poses_gt, poses_res, seq=seq)
        print(res.summary())
        t_errs.append(res.t_rel)
        r_errs.append(res.r_rel)
        save_sequence_errors(
            res.errors, os.path.join(args.result_dir, f"{seq}_errors.txt")
        )
        if args.plots:
            from .plots import write_all_plots

            write_all_plots(seq, poses_gt, poses_res, res.errors,
                            os.path.join(args.result_dir, f"{seq}_eval"))
    if t_errs:
        print(f"mean Average_t_error {np.mean(t_errs):.2f} "
              f"Average_r_error {np.mean(r_errs):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
