#!/usr/bin/env python3
"""K3 (``block_stage``, one cell-DAG block on the tensor cores) under every
plan that fits, for the flagship's five blocks at its DAG widths, on one
NVIDIA GPU.

    python scripts/torch_bench_k3.py [--dtype fp32,bf16] [--levels 1,2,3]

For each dtype, level (C, H, W) of the flagship at 1025x2049 and block, it
runs each candidate plan (N-slice, warp groups) once against the plain
version (relative 1e-4 fp32, 2e-2 bf16) and prints one JSON line with its
grid and device time by torch.profiler, marking the plan ``plan_block``
picks; then, per dtype and level, the sum over the blocks of the picked
plans' times beside the sum of the fastest. The last line is the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import CELL_BLOCKS, CELL_SHAPES, _block_flops, device_ms, nvidia_smi_line  # noqa: E402

from auto_dynamic_deeplab_torch.kernels import cell_ops as co  # noqa: E402
from auto_dynamic_deeplab_torch.ops.primitives import OPS  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn  # noqa: E402

DTYPES = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}


def candidates(names, c, dtype):
    for th, tw in co.BLOCK_TILES:
        for ns in co._slices(c):
            for ng in (2, 1):
                smem = co._mma_smem(names, c, dtype, th, tw, ns, ng)
                if smem <= co.SMEM_LIMIT:
                    yield co.Plan((th, tw), smem, ns, ng)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--levels", default="1,2,3")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_k3: no GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    for dname in args.dtype.split(","):
        dtype, tol = DTYPES[dname]
        for level in (int(v) for v in args.levels.split(",")):
            c, h, w = CELL_SHAPES[level - 1]
            g = torch.Generator().manual_seed(c)
            xs = [torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2) for _ in range(2)]
            picked = best = 0.0
            for names in CELL_BLOCKS[:5]:
                chosen = co.plan_block(names, c, dtype, (h, w), 1)
                if chosen is None:
                    continue
                edges = [(x, nm, co.edge_weights(randomize_bn(init_params(OPS[nm](c, 1), g), g).cuda().eval(),
                                                 nm, dtype)) for x, nm in zip(xs, names)]
                gflop = h * w * sum(_block_flops(names, c)) / 1e9
                times = {}
                with torch.inference_mode():
                    ref = co.block_stage_reference(edges).float()
                    for plan in candidates(names, c, dtype):
                        out = torch.empty_like(xs[0], memory_format=torch.channels_last)
                        run = lambda: co._launch("block", xs[0], edges, plan, out)  # noqa: E731
                        run()
                        torch.cuda.synchronize()
                        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                        if not rel <= tol:
                            raise AssertionError(f"{dname} C={c} {names} {plan}: relative error {rel} > {tol}")
                        times[plan] = ms = device_ms(run)
                        print(json.dumps({
                            "dtype": dname, "shape": [c, h, w], "edges": list(names), "ns": plan.ns,
                            "ng": plan.ng, "smem": plan.smem, "chosen": plan == chosen,
                            "blocks": co.dense_blocks(plan, c, 1, h, w), "device_ms": ms,
                            "tflops": gflop / ms if ms else None, "max_rel_err": rel,
                        }), flush=True)
                measured = [t for t in times.values() if t is not None]
                picked += times[chosen] if times[chosen] is not None else float("nan")
                best += min(measured) if measured else float("nan")
            print(json.dumps({"dtype": dname, "shape": [c, h, w], "cell_device_ms_picked": picked,
                              "cell_device_ms_best": best}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
