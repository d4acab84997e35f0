"""Readings that the limits of ``limits/<workload>.json`` are set from, on
the card, at the cell's own size, in one process:

* the program against the reference, on each of ``--seeds`` (the lower
  readings);
* the control against the reference on each of ``--control-seeds``: the
  reference put in the program's place with its matrix products in TF32,
  the precision below the float32 the configurations state (the upper
  readings);
* each fault the cell can have, planted in the program, on each of
  ``--fault-seeds``.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 1,2,3

Training cells read the first steps of set-up and need no window; eval
cells run the program once over the whole sequence at the cell's batch, as
a window does, and compare the sampled frames.  One JSON line a reading.
The benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def train_readings(cell, args, device):
    import gc

    import torch

    from benchmark import compare, faults
    from benchmark.drivers import train_step as T

    def program(seed, fault=None):
        with faults.planted("train", fault) if fault else contextlib.nullcontext():
            state, step, gen, batches, prog = T.program_setup(cell, seed, device)
        del state, step, gen
        gc.collect()
        torch.cuda.empty_cache()
        return batches, prog

    for seed in args.seeds:
        batches, prog = program(seed)
        ref = T.reference_readings(cell, seed, batches, device)
        steps = cell.traffic["reference_steps"]
        yield {"kind": "program", "seed": seed, **T.checks(prog, ref),
               "loss_gap_steps": compare.loss_gap(prog["losses"], ref["losses"], steps)}
        if seed in args.control_seeds:
            ctl = T.reference_readings(cell, seed, batches, device, tf32=True)
            yield {"kind": "control", "seed": seed, **T.checks(ctl, ref),
                   "loss_gap_steps": compare.loss_gap(ctl["losses"], ref["losses"], steps)}
        if seed in args.fault_seeds:
            _, bad = program(seed, "half_batch")
            yield {"kind": "fault half_batch", "seed": seed, **T.checks(bad, ref)}


def eval_readings(cell, args, device):
    import numpy as np
    import torch
    from efficientlo_net_torch.evaluation import runner
    from efficientlo_net_torch.training.step import make_streaming_eval_fns

    from benchmark import compare, faults, program
    from benchmark.drivers import seq_eval as E

    b, n = cell.traffic["batch_size"], cell.traffic["frames"]
    model = program.load_model(cell.config, device)
    enc, cor = make_streaming_eval_fns(program.model_config(cell.config))
    for seed in args.seeds:
        drive = E.make_drive(cell, seed, device)
        frames = E.check_frames(cell, seed)
        outs = []

        def correlate(m, new, prev):
            out = cor(m, new, prev)
            outs.append(out)
            return out

        runner.predict_sequence_streaming(enc, correlate, model, drive, cell.traffic["seq"],
                                          batch_size=b, num_workers=cell.traffic["readers"])
        ref = E.reference_poses(cell, drive, frames, device)

        def gaps(fault=None):
            poses = []
            for k, out in enumerate(outs):
                o = faults.poses(out, fault) if fault else out
                real = min(b, n - k * b)
                poses.append(np.concatenate([o["q"][:real].cpu().numpy(),
                                             o["t"][:real].cpu().numpy()], axis=1))
            return compare.pose_gaps(*E.program_rows(poses, frames, ref, b, n))

        yield {"kind": "program", "seed": seed, **gaps()}
        if seed in args.control_seeds:
            ctl = E.reference_poses(cell, drive, frames, device, tf32=True)
            yield {"kind": "control", "seed": seed, **compare.pose_gaps(ctl, ref)}
        if seed in args.fault_seeds:
            for fault in faults.EVAL:
                yield {"kind": f"fault {fault}", "seed": seed, **gaps(fault)}
        del outs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--fault-seeds", type=ints, default=[])
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve_cell(args.workload)
    device = torch.device("cuda", 0)
    readings = train_readings if cell.driver == "train_step" else eval_readings
    t0 = time.perf_counter()
    for r in readings(cell, args, device):
        print(json.dumps(dict(r, workload=cell.name, s=round(time.perf_counter() - t0, 1))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
