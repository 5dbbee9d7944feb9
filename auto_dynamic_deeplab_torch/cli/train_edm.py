"""Stage-3 driver: train the EDM on the frozen backbone's first-exit
features (cli/train_edm.py of the JAX package; the reference's
train_edm.py), on the GPU by default, the CPU with --device cpu.

    python -m auto_dynamic_deeplab_torch.cli.train_edm \\
        --resume run/synthetic/ADD_C2_F20/experiment_0 \\
        --synthetic-crop 1025 2049 --synthetic-length 8

--resume is the stage-2 experiment directory (its ``checkpoint``), of
the port or of the JAX package (an orbax directory); the
EDM goes to {--run-dir}/{--dataset}/{--checkname or edm_C<C>}/
experiment_N/edm, with the feature and entropy caches beside it.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..data import make_data_loader
from ..models import ADD
from ..runtime import resolve_device
from ..train.edm_trainer import make_edm_dataset, train_edm
from ..utils.initialize import init_params
from ..bridge import load_checkpoint_weights
from ..utils.saver import Saver, checkpoint_path, restore_checkpoint
from .common import add_common_args, resolve_arch


def build_parser():
    p = argparse.ArgumentParser(description="Train the EDM regressor")
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--edm-batch-size", type=int, default=16)
    p.add_argument("--resume", default=None, help="experiment dir containing the stage-2 checkpoint (the port's or the JAX package's)")
    p.add_argument("--genotype", default=None)
    p.add_argument("--max-items", type=int, default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    path, C_index, low_level_layer, genotype = resolve_arch(args, args.genotype)

    # feature generation at batch 1 over the train images
    train_loader, _, nclass = make_data_loader(
        args.dataset, 1, root=args.data_root, edm=args.dataset.startswith("cityscapes"),
        num_workers=args.workers, seed=args.seed,
        synthetic_length=args.synthetic_length,
        synthetic_crop=tuple(args.synthetic_crop),
    )
    model = ADD(path, C_index, genotype, nclass, F=args.F, B=args.B, low_level_layer=low_level_layer)
    init_params(model, torch.Generator().manual_seed(args.seed))
    if args.resume:
        load_checkpoint_weights(model, restore_checkpoint(checkpoint_path(args.resume))[0])

    saver = Saver(args.run_dir, args.dataset, args.checkname or f"edm_C{args.C}")
    features, entropies = make_edm_dataset(
        model, train_loader, num_classes=nclass, cache_dir=saver.experiment_dir,
        max_items=args.max_items, device=device,
    )
    edm, loss = train_edm(
        features, entropies, epochs=args.epochs, batch_size=args.edm_batch_size, lr=args.lr,
        seed=args.seed, device=device,
    )
    saver.save_checkpoint({"model": edm.state_dict()}, is_best=True, epoch=args.epochs,
                          best_pred=-loss, filename="edm")
    print(json.dumps({"edm_l1": loss, "n_items": int(features.shape[0]),
                      "experiment_dir": saver.experiment_dir}))
    return loss


if __name__ == "__main__":
    main()
