"""Where the time goes in the port's early-exit engine on the GPU.

Builds the flagship ADD (C=2, F=20, B=5, 19 classes, seeded weights) of
auto_dynamic_deeplab_torch, warms the engine up at 1025x2049, then traces
one early-exit and one full-depth inference with torch.profiler. Prints one
JSON line per mode: host wall time, the sum and count of device kernels,
the device busy share (kernel time / wall time, kernels of one stream do
not overlap) and the kernels with the most device time.

    python scripts/torch_profile_engine.py --dtype bf16 [--cell-exec flat]

``--cell-exec flat`` runs every cell's DAG through the cell kernels K3-K6
(as ``cli.evaluate --cell-exec flat`` does); the default is the op-by-op
cells.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from auto_dynamic_deeplab_torch.models import ADD  # noqa: E402
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH  # noqa: E402
from auto_dynamic_deeplab_torch.runtime import resolve_device  # noqa: E402
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--hw", type=int, nargs=2, default=(1025, 2049))
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--cell-exec", default="xla", choices=["xla", "flat"])
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"], dtype=dtype,
                flat_eval=args.cell_exec == "flat")
    model = init_params(model, torch.Generator().manual_seed(0)).to(dev).eval()
    engine = DynamicInferenceEngine(model, num_classes=19)
    shape = (1, *args.hw, 3)
    engine.warmup(shape, "entropy", 0.0)
    x = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    for mode, thr in (("early_exit", 1.01), ("full_depth", 0.0)):
        for _ in range(3):
            engine.infer(x, threshold=thr, confidence="entropy")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, k, _, _ = engine.infer(x, threshold=thr, confidence="entropy")
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = defaultdict(lambda: [0.0, 0])
        for e in kernels:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
        device_ms = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
        print(json.dumps({
            "mode": mode, "exit_index": k, "dtype": args.dtype, "cell_exec": args.cell_exec,
            "hw": list(args.hw),
            "wall_ms_profiled": wall_ms, "device_kernel_ms": device_ms,
            "kernel_launches": len(kernels),
            "device_busy_share": device_ms / wall_ms if wall_ms > 0 else None,
            "top_kernels": [{"name": n[:90], "ms": v[0], "count": v[1]} for n, v in top],
            "device": torch.cuda.get_device_name(0),
        }), flush=True)


if __name__ == "__main__":
    main()
