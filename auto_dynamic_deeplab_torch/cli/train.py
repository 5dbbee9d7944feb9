"""Stage-2 driver: train the decoded multi-exit network (cli/train.py of
the JAX package; the reference's train.py), with the JAX CLI's flags: on
the GPU by default, the CPU with --device cpu; one process per device
under torchrun, data-parallel (see cli/common.py).

    python -m auto_dynamic_deeplab_torch.cli.train --epochs 1 \\
        --synthetic-crop 769 769 --synthetic-length 16 [--bf16] [--remat]
    python -m auto_dynamic_deeplab_torch.cli.train --device cpu --F 4 \\
        --synthetic-crop 33 65 --synthetic-length 8 --batch-size 2 --epochs 2 --eval-interval 1
    python -m auto_dynamic_deeplab_torch.cli.train --dataset cityscapes \\
        --data-root /data/cityscapes [--device-augment] [--bf16]

--data-root (default $CITYSCAPES_ROOT or $PASCAL_ROOT) holds the dataset;
--device-augment ships decode-only uint8 batches and flips, scales, crops
and normalizes them on the device (data/device_transforms.py).

    torchrun --nproc_per_node 2 -m auto_dynamic_deeplab_torch.cli.train --sync-bn \
        --device cpu --F 4 --synthetic-crop 33 65 --synthetic-length 8 --batch-size 4 --epochs 1

--sync-bn (cross-replica BN) needs a process group, with data
parallelism on. Checkpoints go to {--run-dir}/{--dataset}/{--checkname}/experiment_N,
written by rank 0.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from ..data import calculate_class_weights, make_data_loader
from ..models import ADD, BaselineModel
from ..ops.norm import set_bn_group
from ..parallel.distributed import session
from ..runtime import resolve_device
from ..train.trainer import TrainConfig, Trainer
from ..utils.initialize import init_params
from .common import add_common_args, resolve_arch


def build_parser():
    p = argparse.ArgumentParser(description="Train decoded ADD network")
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lr-scheduler", default="poly", choices=["poly", "cos", "step"])
    p.add_argument("--min-lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=4e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--no-nesterov", action="store_true")
    p.add_argument("--eval-interval", type=int, default=10)
    p.add_argument("--use-balanced-weights", action="store_true")
    p.add_argument("--network", default="ADD", choices=["ADD", "baseline"])
    p.add_argument("--genotype", default=None, help="path to genotype .npy")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--remat", action="store_true", help="checkpoint cells (memory for FLOPs)")
    p.add_argument("--resume", default=None,
                   help="'auto' (newest committed checkpoint for this checkname; "
                        "preemption recovery), a checkpoint file or its experiment dir")
    p.add_argument("--ft", action="store_true", help="fine-tune: load weights only, restart the schedule")
    p.add_argument("--device-augment", action="store_true",
                   help="on-device input pipeline: the loader ships decode-only uint8; flip, "
                        "scale, crop and normalize run on the device (data/device_transforms.py)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with session(args.device):
        return run(args)


def run(args) -> dict:
    if args.sync_bn and (not dist.is_initialized() or args.no_data_parallel):
        raise ValueError(
            "--sync-bn reduces BN statistics over the ranks of the data-parallel step: it needs a process "
            "group (torchrun, or COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) and no --no-data-parallel"
        )
    device = resolve_device(args.device)
    path, C_index, low_level_layer, genotype = resolve_arch(args, args.genotype)

    train_loader, val_loader, nclass = make_data_loader(
        args.dataset, args.batch_size, args.test_batch_size, root=args.data_root,
        num_workers=args.workers, seed=args.seed, crop_size=tuple(args.crop_size),
        synthetic_length=args.synthetic_length,
        synthetic_crop=tuple(args.synthetic_crop),
        raw_train=args.device_augment,
    )

    model_cls = ADD if args.network == "ADD" else BaselineModel
    model = model_cls(
        path, C_index, genotype, nclass, F=args.F, B=args.B, low_level_layer=low_level_layer,
        dtype=torch.bfloat16 if args.bf16 else None, remat=args.remat,
    )
    init_params(model, torch.Generator().manual_seed(args.seed))
    if args.sync_bn:
        set_bn_group(model, dist.group.WORLD)

    weight = None
    if args.use_balanced_weights:
        weight = calculate_class_weights(train_loader.dataset, nclass, max_items=64)

    cfg = TrainConfig(
        epochs=args.epochs,
        lr=args.lr,
        lr_scheduler=args.lr_scheduler,
        min_lr=args.min_lr,
        momentum=args.momentum,
        nesterov=not args.no_nesterov,
        weight_decay=args.weight_decay,
        eval_interval=args.eval_interval,
        use_balanced_weights=args.use_balanced_weights,
        run_dir=args.run_dir,
        dataset=args.dataset,
        checkname=args.checkname or f"{args.network}_C{args.C}_F{args.F}",
        resume=args.resume,
        ft=args.ft,
        device_augment=args.device_augment,
        crop_size=tuple(args.crop_size) if args.device_augment else None,
        data_parallel=not args.no_data_parallel,
    )
    trainer = Trainer(model, train_loader, val_loader, cfg, class_weight=weight, device=device, seed=args.seed)
    result = trainer.fit()
    result["experiment_dir"] = trainer.experiment_dir
    print(json.dumps({k: v for k, v in result.items() if k != "step_ms"}, default=float))
    return result


if __name__ == "__main__":
    main()
