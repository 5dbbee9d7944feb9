#!/usr/bin/env python3
"""K2 (``entropy_argmax_triton``, normalized entropy + argmax over the
class logits) at the main path's shape, (1, 19, 1025, 2049) class-leading
logits, on one NVIDIA GPU: the launch configuration swept.

    python scripts/torch_bench_k2.py [--dtype fp32,bf16] [--layout nchw]
        [--configs all|default|128x4x8,...] [--root DIR]

For each dtype and layout (class-leading ``nchw``, the main path's;
``nhwc``; ``channels_last``) it prints one JSON line for the default
configuration (``K2_CONFIG``) and one for each (pixels a program takes at
a time, warps, programs per SM) of the sweep, set as ``K2_CONFIG`` in
turn, each checked against the plain
version (entropy |Δ| ≤ 1e-5 fp32, 1e-4 bf16, argmax exact), with the
wrapper's CUDA-event time, the device time of the kernels one call
launches (torch.profiler) and their count. ``--root`` imports the port
from another tree (e.g. a parent unpacked with ``git archive`` into
``build/ab/``) and times its wrapper alone, so that two versions can be
timed in one call. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SWEEP = [(bp, nw, ps) for bp in (128, 256, 512, 1024) for nw in (4, 8) for ps in (2, 4, 8)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--layout", default="nchw")
    p.add_argument("--configs", default="all")
    p.add_argument("--root", default=str(HERE))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_k2: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import FULL_HW, cuda_ms, device_ms, entropy_bound, kernels_per_call, nvidia_smi_line

    sys.path.insert(0, str(Path(args.root).resolve()))
    from auto_dynamic_deeplab_torch.kernels import confidence as k2

    smi = nvidia_smi_line()
    g = torch.Generator().manual_seed(1)
    if args.configs == "all":
        sweep = SWEEP
    elif args.configs == "default":
        sweep = []
    else:
        sweep = [tuple(int(v) for v in c.split("x")) for c in args.configs.split(",")]
    for dname in args.dtype.split(","):
        dtype, tol = {"fp32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 1e-4)}[dname]
        for layout in args.layout.split(","):
            x = (torch.randn(1, 19, *FULL_HW, generator=g) * 3).cuda()
            axis = 1
            if layout == "nhwc":
                x, axis = x.permute(0, 2, 3, 1).contiguous(), -1
            elif layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            x = x.to(dtype)
            ent_r, arg_r = k2.entropy_argmax_reference(x, 19, class_axis=axis)
            bound_ms, _ = entropy_bound(1, 19, *FULL_HW, torch.finfo(dtype).bits // 8)
            default = getattr(k2, "K2_CONFIG", None)
            configs = [None] + ([k2.K2Config(*c) for c in sweep] if default else [])
            for cfg in configs:
                if default:
                    k2.K2_CONFIG = cfg or default
                fn = lambda: k2.entropy_argmax_triton(x, 19, class_axis=axis)  # noqa: E731
                ent, arg = fn()
                torch.cuda.synchronize()
                err = (ent - ent_r).abs().max().item()
                if not (err <= tol and torch.equal(arg, arg_r)):
                    raise AssertionError(f"K2 {dname} {layout} {cfg}: entropy error {err}, "
                                         f"argmax equal {torch.equal(arg, arg_r)}")
                dev = device_ms(fn)
                print(json.dumps({
                    "dtype": dname, "layout": layout, "config": "default" if cfg is None else list(cfg),
                    "default_config": list(default or ()), "ms": cuda_ms(fn), "device_ms": dev,
                    "kernels_per_call": kernels_per_call(fn), "bound_ms": bound_ms,
                    "bound_share": bound_ms / dev if dev else None, "max_abs_err": err, "root": args.root,
                }), flush=True)
            if default:
                k2.K2_CONFIG = default
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
