"""Eval driver (eval.py parity): static per-exit mIoU, or --dynamic
early-exit inference with mIoU / latency / fps / exit rate / average
confidence, in the single-program mode as the JAX CLI runs it (on the
card, one CUDA graph a segment, replayed). Weights come from --seed, or
from the stage-2 experiment directory --resume (its ``checkpoint``) and
the stage-3 one --edm-resume (its ``edm``), as cli.train and
cli.train_edm write them, or as the JAX package's write them (orbax
directories, read by utils/orbax_reader.py and carried over by the bridge).

    python -m auto_dynamic_deeplab_torch.cli.evaluate --dynamic \\
        --confidence entropy --threshold 0.5 --synthetic-crop 1025 2049 \\
        [--cell-exec xla|packed|flat|flat-packed|dense-sep] [--flops] \\
        [--resume DIR] [--edm-resume DIR] [--pipeline-devices 2]

--cell-exec picks how the cells run in eval, as in the JAX CLI: plain ops
(xla), the wave-packed schedule with block-diagonal 1x1s (packed,
ops/packed.py), the hand-written cell kernels K3-K6 (flat), the flat DAG
fed by the packed dense-tap projections (flat-packed), or every SepConv as
two composed dense convs (dense-sep). --flops adds ``complexity``
({flops, params, bytes_accessed} of one forward, utils/flops.py).

--pipeline-devices N (>= 2) runs --dynamic as a pipeline over cuda:0..N-1
(parallel/pipeline.py: each stage holds only its segments' modules), the
segment loop in each stage; with --device cpu, N stages on the CPU.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..data import make_data_loader
from ..data.loader import peek_batch
from ..models import ADD, EDM, BaselineModel
from ..runtime import resolve_device
from ..train.evaluator import Evaluation
from ..utils.flops import model_complexity
from ..utils.initialize import init_params
from ..bridge import load_checkpoint_weights
from ..utils.saver import checkpoint_path, restore_checkpoint
from .common import add_common_args, resolve_arch


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate decoded network")
    add_common_args(p)
    p.add_argument("--network", default="ADD", choices=["ADD", "baseline"])
    p.add_argument("--dynamic", action="store_true")
    p.add_argument("--confidence", default="edm", choices=["edm", "entropy", "max"])
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--resume", default=None,
                   help="stage-2 experiment dir (or its checkpoint), of the port or of the JAX package")
    p.add_argument("--edm-resume", default=None,
                   help="stage-3 experiment dir (or its edm), of the port or of the JAX package")
    p.add_argument("--genotype", default=None)
    p.add_argument("--flops", action="store_true",
                   help="add complexity: flops, params and bytes of one forward")
    p.add_argument(
        "--pipeline-devices", type=int, default=0,
        help=">=2: pipeline the dynamic-inference segments across this many devices "
        "(per-stage module partitioning, parallel/pipeline.py); raises with fewer GPUs",
    )
    p.add_argument(
        "--cell-exec", default="xla", choices=list(CELL_EXEC),
        help="eval-path cell execution: plain ops (xla), the wave-packed schedule "
        "with block-diagonal 1x1s (packed, ops/packed.py), each cell's DAG through "
        "the hand-written cell kernels K3-K6 (flat; their plain versions on the "
        "CPU), both (flat DAG + packed dense-tap 1x1s), or the exact SepConv "
        "dense-form rewrite (dense-sep)",
    )
    return p


# --cell-exec -> the model's flags, as the JAX CLI maps them (cli/evaluate.py:65-70)
CELL_EXEC = {
    "xla": {},
    "packed": {"packed_eval": True},
    "flat": {"flat_eval": True},
    "flat-packed": {"flat_eval": True, "packed_eval": True},
    "dense-sep": {"dense_sep_eval": True},
}


def build(args):
    """(Evaluation, val loader) of parsed ``args``: the model, its seeded
    or restored weights and, for a dynamic EDM run, the EDM, on
    ``args.device``."""
    device = resolve_device(args.device)
    path, C_index, low_level_layer, genotype = resolve_arch(args, args.genotype)

    _, val_loader, nclass = make_data_loader(
        args.dataset, args.batch_size, args.test_batch_size, root=args.data_root,
        num_workers=args.workers, seed=args.seed,
        synthetic_length=args.synthetic_length,
        synthetic_crop=tuple(args.synthetic_crop),
    )

    model_cls = ADD if args.network == "ADD" else BaselineModel
    model = model_cls(path, C_index, genotype, nclass, F=args.F, B=args.B,
                      low_level_layer=low_level_layer, **CELL_EXEC[args.cell_exec])
    init_params(model, torch.Generator().manual_seed(args.seed))
    if args.resume:
        load_checkpoint_weights(model, restore_checkpoint(checkpoint_path(args.resume))[0])

    edm = None
    if args.confidence == "edm" and args.dynamic:
        edm = EDM(model.feature_channels(model.exit_layers[0]))
        init_params(edm, torch.Generator().manual_seed(0))
        if args.edm_resume:
            load_checkpoint_weights(edm, restore_checkpoint(checkpoint_path(args.edm_resume, "edm"))[0])

    return Evaluation(model, nclass, edm=edm, device=device), val_loader


def main(argv=None):
    args = build_parser().parse_args(argv)
    evaluation, val_loader = build(args)
    device = evaluation.device
    if args.dynamic:
        stats = evaluation.dynamic_inference(
            val_loader, threshold=args.threshold, confidence=args.confidence,
            pipeline_devices=args.pipeline_devices,
        )
    else:
        stats = evaluation.validate(val_loader)
    if args.flops:
        sample = peek_batch(val_loader)["image"]
        stats["complexity"] = model_complexity(evaluation.model, (1, *sample.shape[1:]))
    stats["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(stats, default=float))
    return stats


if __name__ == "__main__":
    main()
