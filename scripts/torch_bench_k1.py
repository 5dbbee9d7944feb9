#!/usr/bin/env python3
"""K1 (``fused_stems``, the stems on the tensor cores) at 1025x2049 on one
NVIDIA GPU: every tile of ``STEM_TILES``, then device-code variants.

    python scripts/torch_bench_k1.py [--dtype fp32,bf16] [--variants whole,stride2,...]

Tiles: each runs once against the plain version (relative 1e-4 fp32,
2e-2 bf16) and prints one JSON line with its device time by
torch.profiler and whether ``plan_stems`` picks it. Variants: copies of
csrc/stems.cu and its header built into build/k1_probe/ (git-ignored),
each changed by text substitution, timed at the picked tile:
  whole     the kernel as it is
  stride2   stem2's A rows at stride 2 in a ReLU(s0) window kept in column
            order, instead of its columns split by parity
  lb1       the bf16 instance without the two-blocks-an-SM launch bound
  nomma     no tensor-core products (fragments are still loaded)
  nostem1   no stem1 products (no weight stream, taps or barriers)
  nostem2   no stem2 products
  noim2col  no image reads (stem0's im2col left as it is)
  nos0      no s0 stores
The first three compute right values and are checked; the rest are timed
only. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FULL_HW, device_ms, nvidia_smi_line, stems_products  # noqa: E402

from auto_dynamic_deeplab_torch.kernels import _build  # noqa: E402
from auto_dynamic_deeplab_torch.kernels import stems as k1  # noqa: E402
from auto_dynamic_deeplab_torch.models.decoded import _Stems  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn  # noqa: E402

OUT = ROOT / "build" / "k1_probe"
DTYPES = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}
VARIANTS = {
    "whole": [],
    "stride2": [("constexpr bool P_HALVES = true;", "constexpr bool P_HALVES = false;")],
    "lb1": [("__launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)", "__launch_bounds__(THREADS, 1)")],
    "nomma": [("mma_step<T>(fa[s & 1], fb[s & 1], acc, acc_lo);", "")],
    "nostem1": [("tap_stream<T>(9, pk1,", "if (false) tap_stream<T>(9, pk1,")],
    "nostem2": [("tap_stream<T>(9, pk2,", "if (false) tap_stream<T>(9, pk2,")],
    "noim2col": [("for (int p = threadIdx.x; p < m0; p += THREADS) {",
                  "if (false) for (int p = threadIdx.x; p < m0; p += THREADS) {")],
    "nos0": [("if (own) store2(o + co, y0, y1);", "")],
}
RIGHT = ("whole", "stride2", "lb1")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_k1: no GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in args.variants.split(","):
        so, log = _build.build_variant("stems", VARIANTS[name], OUT, name)
        libs[name] = k1.bind(ctypes.CDLL(str(so)))
        print(json.dumps({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                     if "registers" in ln or "spill" in ln]}), flush=True)
    gflop = stems_products(1, *FULL_HW) / 1e9
    for dname in args.dtype.split(","):
        dtype, tol = DTYPES[dname]
        g = torch.Generator().manual_seed(0)
        stems = randomize_bn(init_params(_Stems(dtype), g), g).cuda().eval()
        x = torch.randn(1, *FULL_HW, 3, generator=g).cuda().permute(0, 3, 1, 2)
        weights = k1.stem_weights(stems, dtype)
        chosen = k1.plan_stems(dtype, FULL_HW, 1)
        with torch.inference_mode():
            refs = [r.float() for r in k1.stems_reference(stems, x)]

            def check(outs, what):
                torch.cuda.synchronize()
                rel = max(((o.float() - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, refs))
                if not rel <= tol:
                    raise AssertionError(f"K1 {dname} {what}: relative error {rel} > {tol}")
                return rel

            for tile in k1.STEM_TILES:
                plan = k1.StemPlan(tile, k1.stem_smem(*tile, dtype), 0)
                run = lambda: k1.fused_stems(x, weights, dtype, plan)  # noqa: E731
                rel = check(run(), f"tile {tile}")
                ms = device_ms(run)
                print(json.dumps({"dtype": dname, "tile": list(tile), "smem": plan.smem,
                                  "blocks": k1.stem_blocks(tile, 1, *FULL_HW), "chosen": tile == chosen.tile,
                                  "device_ms": ms, "tflops": gflop / ms if ms else None,
                                  "max_rel_err": rel}), flush=True)
            for name, lib in libs.items():
                run = lambda: k1._launch(lib, x, weights, dtype, chosen)  # noqa: E731
                rel = check(run(), name) if name in RIGHT else None
                ms = device_ms(run)
                print(json.dumps({"dtype": dname, "variant": name, "tile": list(chosen.tile), "device_ms": ms,
                                  "tflops": gflop / ms if ms else None, "max_rel_err": rel}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
