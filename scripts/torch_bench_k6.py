#!/usr/bin/env python3
"""K6 (``dense_stage``, the tensor-core DilConv) under every plan that fits,
at the flagship's DAG widths, on one NVIDIA GPU.

    python scripts/torch_bench_k6.py [--dtype fp32,bf16] [--ops dil_conv_5x5]

For each (C, H, W) of the flagship at 1025x2049, op and dtype, it runs each
candidate plan (tile, N-slice, warp groups) once against the plain version
(relative 1e-4 fp32, 2e-2 bf16) and prints one JSON line with its device
time by torch.profiler, the plan ``plan_dense_stage`` picks, and cuDNN's
device time for the same function (ReLU + ``F.conv2d``, TF32 off) as a
yardstick. The last lines are the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import CELL_SHAPES, _edge_flops, device_ms, nvidia_smi_line  # noqa: E402

from auto_dynamic_deeplab_torch.kernels import cell_ops as co  # noqa: E402
from auto_dynamic_deeplab_torch.ops.primitives import OPS  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn  # noqa: E402

DTYPES = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}


def candidates(name, c, dtype):
    o8 = -(-c // 8) * 8
    for th, tw in ((8, 8), (4, 8)):
        for ns in range(min(o8, co.DENSE_NS_MAX), 0, -8):
            smem = co._dense_smem(name, c, dtype, th, tw, ns)
            if o8 % ns or smem > co.SMEM_LIMIT:
                continue
            for ng in (1, 2) if ns > 8 else (1,):
                yield co.Plan((th, tw), smem, ns, ng)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--ops", default="dil_conv_3x3,dil_conv_5x5")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_k6: no GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    for dname in args.dtype.split(","):
        dtype, tol = DTYPES[dname]
        for c, h, w in CELL_SHAPES:
            g = torch.Generator().manual_seed(c)
            x = torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2)
            for name in args.ops.split(","):
                op = randomize_bn(init_params(OPS[name](c, 1), g), g).cuda().eval()
                wts = co.edge_weights(op, name, dtype)
                k = int(name[-1])
                qd = wts.q[:, :, :c].reshape(k, k, c, c).permute(3, 2, 0, 1).contiguous()
                bd = wts.bias[:c].to(dtype)
                flops = h * w * sum(_edge_flops(name, c))
                with torch.inference_mode():
                    ref = co.dense_stage_reference(x, wts).float()
                    lib_ms = device_ms(lambda: F.conv2d(F.relu(x), qd, bd, dilation=2, padding=2 * (k // 2)))
                    chosen = co.plan_dense_stage(name, c, dtype, (h, w), 1)
                    for plan in candidates(name, c, dtype):
                        out = torch.empty_like(x, memory_format=torch.channels_last)
                        run = lambda: co._launch("dense_stage", x, [(x, name, wts)], plan, out)  # noqa: E731
                        run()
                        torch.cuda.synchronize()
                        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                        if not rel <= tol:
                            raise AssertionError(f"{dname} C={c} {name} {plan}: relative error {rel} > {tol}")
                        ms = device_ms(run)
                        print(json.dumps({
                            "dtype": dname, "shape": [c, h, w], "op": name, "tile": list(plan.tile),
                            "ns": plan.ns, "ng": plan.ng, "smem": plan.smem, "chosen": plan == chosen,
                            "blocks": co.dense_blocks(plan, c, 1, h, w), "device_ms": ms,
                            "tflops": flops / ms / 1e9 if ms else None, "library_device_ms": lib_ms, "max_rel_err": rel,
                        }), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
