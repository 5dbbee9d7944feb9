"""The fused engine's p50 for two or more trees of the port, in turns, in one
call: one process per run, each importing the port from its own tree.

    python scripts/torch_ab_engine.py --root build/ab/parent --root . \\
        --root . --root build/ab/parent [--dtype bf16] [--cell-exec xla]

Each run builds the flagship ADD (C=2, F=20, B=5, 19 classes, seeded
weights) of its tree, warms the engine up at 1025x2049, batch 1, and times
``infer_fused`` (the entropy gate) on 3 + N images at threshold 1.01 (early
exit) and 0 (full depth), keeping the last N; then a profiled window of 3
images gives the device ms per image. Prints one JSON line per run and the
card's name and power limit. Unpack a parent commit with ``git archive``
into a git-ignored directory (build/ab/) to compare it with the work tree.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _child(args):
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine
    from auto_dynamic_deeplab_torch.utils.initialize import init_params

    # cli.evaluate's CELL_EXEC, spelled out: a tree older than it has xla and flat only
    flags = {"xla": {}, "flat": {"flat_eval": True}, "packed": {"packed_eval": True},
             "flat-packed": {"flat_eval": True, "packed_eval": True},
             "dense-sep": {"dense_sep_eval": True}}[args.cell_exec]
    dev = resolve_device("cuda")
    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"],
                dtype=torch.bfloat16 if args.dtype == "bf16" else None, **flags)
    engine = DynamicInferenceEngine(init_params(model, torch.Generator().manual_seed(0)), num_classes=19)
    shape = (1, 1025, 2049, 3)
    engine.warmup(shape, "entropy", 0.0)
    g = torch.Generator(device=dev).manual_seed(3)
    row = {"root": args.root, "dtype": args.dtype, "cell_exec": args.cell_exec,
           "device": torch.cuda.get_device_name(0)}
    for name, thr in (("early_exit", 1.01), ("full_depth", 0.0)):
        times = []
        for _ in range(3 + args.images):
            times.append(engine.infer_fused(torch.randn(shape, generator=g, device=dev), thr, "entropy")[2] * 1e3)
        xs = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for x in xs:
                engine.infer_fused(x, thr, "entropy")
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        row[name] = {"p50_ms": statistics.median(times[3:]), "n": args.images,
                     "device_ms_per_image": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / len(xs)}
    print(json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append", required=True, help="a tree of the repo; repeat, in run order")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--cell-exec", default="xla", choices=["xla", "flat", "packed", "flat-packed", "dense-sep"])
    p.add_argument("--images", type=int, default=20)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        _child(argparse.Namespace(**{**vars(args), "root": args.root[0]}))
        return 0
    for root in args.root:
        t0 = time.perf_counter()
        cmd = [sys.executable, __file__, "--child", "--root", root, "--dtype", args.dtype,
               "--cell-exec", args.cell_exec, "--images", str(args.images)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"the run in {root} failed:\n{res.stderr[-4000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({**row, "run_s": time.perf_counter() - t0}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
