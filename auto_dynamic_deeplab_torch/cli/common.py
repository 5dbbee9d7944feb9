"""Shared CLI plumbing (cli/common.py of the JAX package).

Every CLI joins a process group when the environment names one
(``parallel.distributed.initialize``: ``torchrun``, or the JAX package's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``): NCCL with
``--device cuda``, gloo with ``--device cpu``. Under a group ``cli.train``
is data-parallel (``--sync-bn`` adds cross-replica BN) unless
``--no-data-parallel``, and ``cli.search`` / ``cli.search_layer`` unless
``--no-dp``."""
from __future__ import annotations

import argparse

import numpy as np

from ..nas.genotypes import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH, SEARCH_C_INDEX


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="synthetic",
                   choices=["cityscapes", "cityscapes_edm", "pascal", "synthetic"])
    p.add_argument("--data-root", default=None,
                   help="the dataset's root (default: $CITYSCAPES_ROOT or $PASCAL_ROOT)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--test-batch-size", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--F", type=int, default=20)
    p.add_argument("--B", type=int, default=5)
    p.add_argument("--C", type=int, default=2, choices=[2, 3, 4])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", default="run")
    p.add_argument("--checkname", default=None)
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-replica BN: under a process group the BNs of cli.train take their training "
                        "statistics over every rank's rows (JAX: axis_name over the data mesh axis)")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="cli.train: the single-device step (raises under a process group of more than one rank)")
    p.add_argument("--crop-size", type=int, nargs=2, default=(769, 769),
                   help="train crop of Cityscapes; the synthetic set's images are --synthetic-crop")
    p.add_argument("--synthetic-crop", type=int, nargs=2, default=(65, 65))
    p.add_argument("--synthetic-length", type=int, default=64)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default; raises without one) or the CPU")
    return p


def resolve_arch(args, genotype_path: str | None = None):
    """The hardcoded decoded architecture for --C (train.py:75-100) and the
    cell genotype (the shipped autodeeplab genotype by default)."""
    cfg = NETWORK_ARCH[args.C]
    genotype = np.load(genotype_path) if genotype_path else AUTODEEPLAB_GENOTYPE
    return cfg["path"], cfg["C_index"], cfg["low_level_layer"], genotype


def search_c_index(C: int):
    """The exit stations cli.search takes for --C (search.py:81-88)."""
    return SEARCH_C_INDEX[C]
