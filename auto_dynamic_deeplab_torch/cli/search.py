"""Stage 1, NAS search (cli/search.py of the JAX package; the
reference's search.py), with the JAX CLI's flags: on the GPU by default,
the CPU with --device cpu. Under a process group (torchrun; see
cli/common.py) both bilevel steps are data-parallel with cross-replica BN
in the supernet, as the JAX CLI searches over its data mesh, unless
--no-dp; without one it searches on one device.

    --network supernet      cell+path search (Model_search)
    --network net_supernet  path-only search with fixed cells (Model_net_search)
    --network baseline_path path-only search on the non-dense trellis

    python -m auto_dynamic_deeplab_torch.cli.search --network net_supernet \\
        --F 20 --B 5 --batch-size 16 --synthetic-crop 321 321 --lr 0.05 \\
        --min-lr 0.003 --arch-lr 1e-3 --weight-decay 8e-4
    python -m auto_dynamic_deeplab_torch.cli.search --device cpu --num-layers 4 \\
        --exit-layers 2 --F 2 --B 2 --batch-size 4 --synthetic-crop 65 65 \\
        --synthetic-length 8 --epochs 2 --alpha-epoch 1 --eval-interval 1
    torchrun --nproc_per_node 2 -m auto_dynamic_deeplab_torch.cli.search --device cpu \
        --num-layers 4 --exit-layers 2 --F 2 --B 2 --batch-size 4 --synthetic-crop 65 65 \
        --synthetic-length 8 --epochs 1 --alpha-epoch 0

Checkpoints and the decoded architecture of every validation
(``arch_epoch_{e}/``) go to {--run-dir}/{--dataset}/{--checkname}/experiment_N.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import make_data_loader
from ..models import ModelBaselinePathSearch, ModelNetSearch, ModelSearch
from ..nas.genotypes import AUTODEEPLAB_GENOTYPE
from ..ops.norm import set_bn_group
from ..parallel.distributed import data_shard, session
from ..parallel.mesh import make_data_mesh
from ..runtime import resolve_device
from ..train.search_trainer import SearchConfig, SearchTrainer
from ..utils.initialize import init_params
from .common import add_common_args, search_c_index


def add_search_args(p: argparse.ArgumentParser):
    """The flags cli.search and cli.search_layer share."""
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--alpha-epoch", type=int, default=150)
    # argparse defaults mirror the reference's argparse (search.py:360-362);
    # the published recipe (lr 0.05 / wd 8e-4 / arch-lr 1e-3) is what
    # scripts/search_cityscapes.sh passes and what SearchConfig defaults to
    p.add_argument("--lr", type=float, default=0.025)
    p.add_argument("--min-lr", type=float, default=0.003)
    p.add_argument("--arch-lr", type=float, default=3e-3)
    p.add_argument("--weight-decay", type=float, default=3e-4)
    p.add_argument("--arch-weight-decay", type=float, default=1e-3)
    p.add_argument("--eval-interval", type=int, default=5)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--genotype", default=None, help="path to genotype .npy (default: the shipped cell)")
    p.add_argument("--no-remat", action="store_true", help="keep the cells' activations (no recomputation)")
    p.add_argument("--no-dp", action="store_true",
                   help="search on one device even under a process group (raises there with more than one rank)")
    return p


def build_parser():
    p = argparse.ArgumentParser(description="NAS supernet search (data-parallel under a process group)")
    add_search_args(p)
    p.add_argument("--network", default="net_supernet", choices=["supernet", "net_supernet", "baseline_path"])
    p.add_argument("--resume", default=None,
                   help="'auto' (newest committed checkpoint) or a checkpoint file or its experiment dir: "
                        "restores weights, arch, both optimizers and the epoch (search.py:104-116)")
    p.add_argument("--mixed-exec", default="edges", choices=["edges", "banked", "scan"],
                   help="accepted for the JAX CLI: the port runs a mixed cell edge by edge for all three "
                        "(the JAX package's forms give the same numbers and differ only in XLA's traced "
                        "graph; bridge.load_jax_variables takes their variables)")
    p.add_argument("--exit-layers", type=int, nargs="+", default=None,
                   help="override exit stations (default: C-derived)")
    return p


def build_model(args, nclass: int, network: str, exits):
    genotype = np.load(args.genotype) if args.genotype else AUTODEEPLAB_GENOTYPE
    kw = dict(num_layers=args.num_layers, F=args.F, B=args.B, remat=not args.no_remat)
    if network == "supernet":
        return ModelSearch(nclass, exit_layer=exits[0], **kw)
    if network == "baseline_path":
        return ModelBaselinePathSearch(nclass, genotype, exit_layer=exits[0], **kw)
    return ModelNetSearch(nclass, genotype, C_index=exits, **kw)


def run(args, network: str, exits, loss_reduce: str, checkname: str, resume=None) -> dict:
    """Build, initialize (seeded) and search, data-parallel under a process
    group unless ``--no-dp``; print the decoded path (and genotype) as the
    JAX CLI does. Returns the last validation's result with
    ``train_loss``, ``step_ms``, ``step_losses``, ``decoded`` and
    ``experiment_dir``."""
    with session(args.device):
        return _search(args, network, exits, loss_reduce, checkname, resume)


def _search(args, network, exits, loss_reduce, checkname, resume) -> dict:
    if args.no_dp and data_shard()[1] > 1:
        raise ValueError(f"--no-dp under a {data_shard()[1]}-rank process group: every rank would search alone")
    device = resolve_device(args.device)
    loader_a, loader_b, val_loader, nclass = make_data_loader(
        args.dataset, args.batch_size, args.test_batch_size, root=args.data_root, supernet=True,
        num_workers=args.workers, seed=args.seed,
        synthetic_length=args.synthetic_length, synthetic_crop=tuple(args.synthetic_crop),
    )
    model = init_params(build_model(args, nclass, network, exits), torch.Generator().manual_seed(args.seed))
    mesh = None if args.no_dp else make_data_mesh(args.batch_size)
    if mesh is not None:
        set_bn_group(model, mesh.group)  # JAX builds the supernet with axis_name=DATA_AXIS
    cfg = SearchConfig(
        epochs=args.epochs, alpha_epoch=args.alpha_epoch, lr=args.lr, min_lr=args.min_lr,
        arch_lr=args.arch_lr, weight_decay=args.weight_decay, arch_weight_decay=args.arch_weight_decay,
        eval_interval=args.eval_interval, loss_reduce=loss_reduce, run_dir=args.run_dir,
        dataset=args.dataset, checkname=args.checkname or checkname, resume=resume,
    )
    trainer = SearchTrainer(model, loader_a, loader_b, val_loader, cfg, device=device, mesh=mesh)
    result = trainer.fit()
    decoded = trainer.decode_and_save(cfg.epochs)
    print("decoded path:", decoded["path"].tolist(), flush=True)
    if decoded["genotype"] is not None:
        print("genotype:", decoded["genotype"].tolist(), flush=True)
    return {**result, "decoded": decoded, "experiment_dir": trainer.experiment_dir,
            "start_epoch": trainer.start_epoch}


def main(argv=None):
    args = build_parser().parse_args(argv)
    exits = tuple(args.exit_layers or search_c_index(args.C))
    return run(args, args.network, exits, "mean", f"search_{args.network}_F{args.F}", args.resume)


if __name__ == "__main__":
    main()
