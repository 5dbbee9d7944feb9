#!/usr/bin/env python3
"""Where K6's time goes: the kernel with one part switched off at a time.

    python scripts/torch_probe_k6_parts.py

Builds copies of csrc/cell_ops.cu and its header into build/k6_probe/ (git-ignored), each
with one part of ``dense_stage_kernel`` removed by text substitution:
  nomma    no tensor-core products (fragments are still loaded)
  noldsm   no fragment loads inside the depth loop (products on stale registers)
  nowload  no per-tap weight copies after the first tap
  nosync   no per-tap cp.async wait and barriers after the first tap
  nowin    no window copy
  lb3, lb4 the bf16 instance bounded to 3 or 4 blocks of 256 threads an
           SM (at most 85 or 64 registers a thread; the others compute right)
The variants compute wrong values; only their device times (torch.profiler)
mean something, set beside the whole kernel's at the plan
``plan_dense_stage`` picks, on dil5 at the flagship's level-1 and level-3
widths, fp32 and bf16. One JSON line a shape, then the card's name and
power limit. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, nvidia_smi_line  # noqa: E402

from auto_dynamic_deeplab_torch.kernels import _build  # noqa: E402
from auto_dynamic_deeplab_torch.kernels import cell_ops as co  # noqa: E402
from auto_dynamic_deeplab_torch.ops.primitives import OPS  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn  # noqa: E402

OUT = ROOT / "build" / "k6_probe"
K6_DECL = "__global__ void __launch_bounds__(MMA_MWARPS * MMA_GROUPS * 32) dense_stage_kernel(const Args a) {"
VARIANTS = {
    "whole": [],
    "nomma": [("dense_mma<T, RELU>(f0, nf, acc, acc_lo);", ""), ("dense_mma<T, RELU>(f1, nf, acc, acc_lo);", "")],
    "noldsm": [("dense_load(ap + (s + 1) * 32, bp + (s + 1) * 32, pb, nf, f1);", "(void)0;"),
               ("dense_load(ap + (s + 2) * 32, bp + (s + 2) * 32, pb, nf, f0);", "(void)0;")],
    "nowload": [("load_tap(tap + 1, (tap + 1) & 1);", "(void)0;")],
    "nosync": [("    cp_async_wait<1>();  // the window and this tap's weights have landed\n"
                "    __syncthreads();\n",
                "    if (tap == 0) {\n      cp_async_wait<1>();\n      __syncthreads();\n    }\n"),
               ("__syncthreads();  // the stage is refilled by the next iteration", "")],
    "lb3": [(K6_DECL, K6_DECL.replace("MMA_GROUPS * 32)", "MMA_GROUPS * 32, sizeof(T) == 2 ? 3 : 1)"))],
    "lb4": [(K6_DECL, K6_DECL.replace("MMA_GROUPS * 32)", "MMA_GROUPS * 32, sizeof(T) == 2 ? 4 : 1)"))],
    "nowin": [("if (vec) {", "if (false) {"),
              ("} else {\n    const T* s = reinterpret_cast", "} else if (false) {\n    const T* s = reinterpret_cast")],
}


def build(name: str) -> ctypes.CDLL:
    so, log = _build.build_variant("cell_ops", VARIANTS[name], OUT, name)
    print(json.dumps({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                 if "registers" in ln or "spill" in ln]}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.add_cell_dense_stage.argtypes = [ctypes.POINTER(co._Args), ctypes.c_void_p]
    lib.add_cell_dense_stage.restype = ctypes.c_int
    lib.add_cell_error_string.argtypes = [ctypes.c_int]
    lib.add_cell_error_string.restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        print("torch_probe_k6_parts: no GPU", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    name = "dil_conv_5x5"
    for dtype in (torch.float32, torch.bfloat16):
        for c, h, w in ((40, 129, 257), (160, 33, 65)):
            g = torch.Generator().manual_seed(c)
            x = torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2)
            wts = co.edge_weights(randomize_bn(init_params(OPS[name](c, 1), g), g).cuda().eval(), name, dtype)
            plan = co.plan_dense_stage(name, c, dtype, (h, w), 1)
            out = torch.empty_like(x, memory_format=torch.channels_last)
            row = {"dtype": str(dtype).split(".")[-1], "shape": [c, h, w], "op": name,
                   "tile": list(plan.tile), "ns": plan.ns, "ng": plan.ng}
            for variant, lib in libs.items():
                co.library = lambda lib=lib: lib  # _launch looks the library up here
                row[f"{variant}_ms"] = device_ms(lambda: co._launch("dense_stage", x, [(x, name, wts)], plan, out))
            print(json.dumps(row), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
