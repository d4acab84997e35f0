"""The port's command-line entry point.

The port's copy of ``efficientlo_net_tpu/cli.py``, with the same flags and
defaults: mode train/test, data_root, checkpoint_path, log_dir, result_dir,
sequence lists, num_points, H/W, max_epoch, batch_size, learning_rate,
optimizer, decay schedule, sensor preset, compute dtype, host projection,
quantized transfer and pretrained weights.  ``--device`` (default ``cuda``)
names the device, in place of the JAX package's ``JAX_PLATFORMS``; there is
no fallback to the CPU.  ``--coordinator`` ("host:port" of rank 0) joins a
multi-process run, one process per device (``parallel/distributed.py``:
NCCL on the card, gloo on the CPU); under ``torchrun`` the rendezvous it
sets in the environment serves as well (a ``--coordinator`` must then name
another port than its ``MASTER_PORT``).  The trainer then trains
data-parallel over every process unless ``--no_mesh``.

    python -m efficientlo_net_torch.cli --mode test --pretrained W.msgpack \\
        --data_root dataset --test_list 4
    torchrun --nproc_per_node=4 -m efficientlo_net_torch.cli --data_root dataset
"""

from __future__ import annotations

import argparse
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EfficientLO on PyTorch / CUDA")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--data_root", default="../", help="KITTI odometry dataset dir")
    p.add_argument("--gt_dir", default=None, help="ground-truth pose dir")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--result_dir", default="result")
    p.add_argument("--train_list", nargs="+", type=int, default=list(range(7)))
    p.add_argument("--val_list", nargs="+", type=int, default=list(range(7, 11)))
    p.add_argument("--test_list", nargs="+", type=int, default=list(range(11)))
    p.add_argument("--num_points", type=int, default=150000)
    p.add_argument("--num_H_input", type=int, default=64)
    p.add_argument("--num_W_input", type=int, default=1800)
    p.add_argument("--max_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--sensor", default=None,
        help="sensor preset name (hdl64/hdl32e/vlp16/os1_64); overrides "
             "num_points/num_H_input/num_W_input",
    )
    p.add_argument(
        "--compute_dtype", default="float32", choices=["float32", "bfloat16"],
        help="MLP compute dtype (pose heads / BN stats stay f32); PERF.md "
             "records the trade-off measured on the card",
    )
    p.add_argument(
        "--host_projection", action="store_true", default=None,
        help="project range images on the host (native C++ projector) inside "
             "the loader workers; the train step takes dense images. "
             "Default: auto — on when the native projector is available",
    )
    p.add_argument(
        "--no_host_projection", dest="host_projection", action="store_false",
        help="force the on-device input projections even when the native "
             "host projector is available",
    )
    p.add_argument(
        "--quantized_transfer", action="store_true",
        help="ship batches host->device as int16 (1.25 mm LSB, far below "
             "sensor noise): halves the transfer bandwidth",
    )
    p.add_argument(
        "--pretrained", default=None,
        help="portable weight artifact (efficientlo_net_torch.pretrained) to "
             "load into the model — weights-only alternative to "
             "--checkpoint_path (which restores full training state)",
    )
    p.add_argument("--no_mesh", action="store_true", help="disable multi-device DP")
    p.add_argument(
        "--coordinator", default=None,
        help="multi-process: torch.distributed rendezvous host:port of rank 0 "
             "(or set MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK as torchrun does)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fallback")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from .config import ModelConfig, SensorConfig, TrainConfig, sensor_preset
    from .parallel.distributed import broadcast_object, initialize_distributed, process_count
    from .training.trainer import Trainer

    initialize_distributed(args.coordinator, device=args.device)

    if args.sensor is not None:
        sensor = sensor_preset(args.sensor)
    else:
        sensor = SensorConfig(
            height=args.num_H_input, width=args.num_W_input,
            num_points=args.num_points,
        )
    model_cfg = ModelConfig(sensor=sensor, compute_dtype=args.compute_dtype)
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        base_learning_rate=args.learning_rate,
        lr_decay_step=args.decay_step,
        lr_decay_rate=args.decay_rate,
        optimizer=args.optimizer,
        momentum=args.momentum,
        max_epoch=args.max_epoch,
        host_projection=args.host_projection,
        quantized_transfer=args.quantized_transfer,
    )

    stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    if process_count() > 1:
        stamp = broadcast_object(stamp)  # one log directory for every process
    log_dir = args.log_dir + stamp
    trainer = Trainer(
        model_cfg,
        train_cfg,
        data_root=args.data_root,
        log_dir=log_dir,
        gt_dir=args.gt_dir,
        train_list=args.train_list,
        val_list=args.val_list if args.mode == "train" else args.test_list,
        seed=args.seed,
        device=args.device,
        use_mesh=not args.no_mesh,
    )

    if args.checkpoint_path:
        # restores state AND epoch metadata, so warm-started training
        # resumes at the right epoch instead of epoch 0
        trainer.restore(path=args.checkpoint_path)
    if args.pretrained:
        trainer.load_pretrained(args.pretrained)

    if args.mode == "train":
        trainer.fit()
    else:
        if not (args.checkpoint_path or args.pretrained):
            trainer.logger.log("warning: testing with random weights "
                               "(no --checkpoint_path / --pretrained)")
        from .evaluation.runner import evaluate_sequences

        evaluate_sequences(
            trainer.eval_step,
            trainer.state.model,
            trainer.dataset,
            args.test_list,
            gt_dir=trainer.gt_dir,
            result_dir=args.result_dir,
            batch_size=args.batch_size,
            log=trainer.logger.log,
            stream_fns=trainer.stream_eval_fns,
        )


if __name__ == "__main__":
    main()
