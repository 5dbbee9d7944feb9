#!/usr/bin/env python3
"""K5 (``sep_stage``, one dw -> pw -> BN stage of a SepConv) at the
flagship's DAG widths, on one NVIDIA GPU: the wrapper at the plan its
model picks, and (with ``--plans``) every plan that fits.

    python scripts/torch_bench_k5.py [--dtype fp32,bf16] [--plans] [--root DIR]

For each (C, H, W) of the flagship at 1025x2049, op (sep3, sep5) and dtype
it runs stage 1 (ReLU on input and output) against the plain version
(relative 1e-4 fp32, 2e-2 bf16) and prints one JSON line with the
wrapper's CUDA-event time, its device time by torch.profiler, the plain
version's time and the plan. ``--plans`` adds one line for each tile
(8x8, and 4x8, which the plan no longer takes), N-slice and warp-group
count, launched directly. ``--root`` imports the port from another
tree (e.g. a parent unpacked with ``git archive`` into ``build/ab/``), so
that two versions of K5 can be timed in one call. The last lines are
ptxas's report for the K5 kernels and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--plans", action="store_true")
    p.add_argument("--root", default=str(HERE))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_k5: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import CELL_SHAPES, cuda_ms, device_ms, nvidia_smi_line

    sys.path.insert(0, str(Path(args.root).resolve()))
    for mod in [m for m in sys.modules if m.startswith("auto_dynamic_deeplab_torch")]:
        del sys.modules[mod]
    from auto_dynamic_deeplab_torch.kernels import _build
    from auto_dynamic_deeplab_torch.kernels import cell_ops as co
    from auto_dynamic_deeplab_torch.ops.primitives import OPS
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    dtypes = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}
    for dname in args.dtype.split(","):
        dtype, tol = dtypes[dname]
        for c, h, w in CELL_SHAPES:
            g = torch.Generator().manual_seed(c)
            x = torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2)
            for name in ("sep_conv_3x3", "sep_conv_5x5"):
                op = randomize_bn(init_params(OPS[name](c, 1), g), g).cuda().eval()
                wts = co.edge_weights(op, name, dtype)[0]
                k = int(name[-1])
                flops = h * w * 2 * c * (k * k + c)
                with torch.inference_mode():
                    ref = co.sep_stage_reference(x, wts, True, True).float()

                    def check(out, what):
                        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                        if not rel <= tol:
                            raise AssertionError(f"{dname} C={c} {name} {what}: relative error {rel} > {tol}")
                        return rel

                    fn = lambda: co.sep_stage(x, name, wts, True, True)  # noqa: E731
                    rel = check(fn(), "wrapper")
                    dev = device_ms(fn)
                    row = {"dtype": dname, "shape": [c, h, w], "op": name, "ms": cuda_ms(fn), "device_ms": dev,
                           "plain_ms": cuda_ms(lambda: co.sep_stage_reference(x, wts, True, True)),
                           "tflops": flops / dev / 1e9 if dev else None, "max_rel_err": rel}
                    if hasattr(co, "SEP_STAGE_TILES"):
                        plan = co.plan_sep_stage(name, c, dtype, (h, w), 1)
                        row.update(tile=list(plan.tile), ns=plan.ns, ng=plan.ng, smem=plan.smem,
                                   blocks=co.dense_blocks(plan, c, 1, h, w))
                    print(json.dumps({"k5": "wrapper", **row, "root": args.root}), flush=True)
                    if not (args.plans and hasattr(co, "SEP_STAGE_TILES")):
                        continue
                    for tile in ((8, 8), (4, 8)):
                        for ns in co._slices(c):
                            for ng in (1, 2) if ns >= 16 else (1,):
                                plan = co.Plan(tile, co._stage_smem(name, *tile, ns), ns, ng)
                                out = torch.empty_like(x, memory_format=torch.channels_last)
                                run = lambda: co._launch("sep_stage", x, [(x, name, (wts,))], plan, out,  # noqa: E731
                                                         True, True)
                                run()
                                torch.cuda.synchronize()
                                rel = check(out, plan)
                                dev = device_ms(run)
                                print(json.dumps({
                                    "k5": "plan", "dtype": dname, "shape": [c, h, w], "op": name,
                                    "tile": list(tile), "ns": ns, "ng": ng, "smem": plan.smem,
                                    "chosen": plan == co.plan_sep_stage(name, c, dtype, (h, w), 1),
                                    "blocks": co.dense_blocks(plan, c, 1, h, w), "device_ms": dev,
                                    "tflops": flops / dev / 1e9 if dev else None, "max_rel_err": rel,
                                }), flush=True)
    log = _build.library_path("cell_ops").with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    for i, ln in enumerate(lines):
        if "sep_stage_kernel" in ln and "Compiling" in ln:
            print(json.dumps({"ptxas": [s.strip() for s in lines[i:i + 4]]}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
