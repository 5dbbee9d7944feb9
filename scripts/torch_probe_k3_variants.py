#!/usr/bin/env python3
"""Where K3's time goes, and what a change to its device code would buy:
``block_kernel`` built in variants, timed on the flagship's blocks.

    python scripts/torch_probe_k3_variants.py [--variants whole,lb2,...]

Builds copies of csrc/cell_ops.cu and its header into build/k3_probe/ (git-ignored), each
changed by text substitution:
  whole    the kernel as it is
  lb2      two warp groups' instance bounded to two blocks an SM (at
           most 128 registers a thread; the one-group instance as it is)
  nodw     no depthwise passes (the products read stale shared memory)
  nopw1    no stage-1 pointwise products (the mid is the bias alone)
  nowin    no window copies
The last three compute wrong values and are timed only. For each dtype,
level (C, H, W) of the flagship at 1025x2049, block, and plan (the widest
N-slice that fits, one and two warp groups) it prints one JSON line with
each variant's device time by torch.profiler; the right-valued variants
are checked against the plain version first (relative 1e-4 fp32, 2e-2
bf16). Then per dtype, level, variant and warp-group count, the sum over
the five blocks (one cell). The last line is the card's name and power
limit. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import CELL_BLOCKS, CELL_SHAPES, device_ms, nvidia_smi_line  # noqa: E402

from auto_dynamic_deeplab_torch.kernels import _build  # noqa: E402
from auto_dynamic_deeplab_torch.kernels import cell_ops as co  # noqa: E402
from auto_dynamic_deeplab_torch.ops.primitives import OPS  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn  # noqa: E402

OUT = ROOT / "build" / "k3_probe"
DTYPES = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}
KERNEL = "__launch_bounds__(MMA_MWARPS * 32 * NG, NG == 1 ? 3 : 1) block_kernel"
VARIANTS = {
    "whole": [],
    "lb2": [(KERNEL, "__launch_bounds__(MMA_MWARPS * 32 * NG, NG == 1 ? 3 : 2) block_kernel")],
    "nodw": [("depthwise_k<T, true>(k, X, xw, C, cpad, pb, e.dwk1, D, eh, ew);", ""),
             ("depthwise_k<T, false>(k, X, ew, C, cpad, pb, e.dwk2, D, th, tw);", "")],
    "nopw1": [("warp_product<T, false>(D + (size_t)p * pb + (w.lane >> 4) * 16, bp, pb, w.nf, ksteps, m, m_lo);",
               "")],
    "nowin": [("if (vec) {", "if (false) {"),
              ("} else {\n    const T* s = reinterpret_cast", "} else if (false) {\n    const T* s = reinterpret_cast")],
}
RIGHT = ("whole", "lb2")


def build(name: str) -> ctypes.CDLL:
    so, log = _build.build_variant("cell_ops", VARIANTS[name], OUT, name)
    print(json.dumps({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                 if "registers" in ln or "spill" in ln]}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.add_cell_block.argtypes = [ctypes.POINTER(co._Args), ctypes.c_void_p]
    lib.add_cell_block.restype = ctypes.c_int
    lib.add_cell_error_string.argtypes = [ctypes.c_int]
    lib.add_cell_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_probe_k3_variants: no GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    names = args.variants.split(",")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    cells = defaultdict(float)
    for dname, (dtype, tol) in DTYPES.items():
        for c, h, w in CELL_SHAPES:
            g = torch.Generator().manual_seed(c)
            xs = [torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2) for _ in range(2)]
            for block in CELL_BLOCKS[:5]:
                first = co.plan_block(block, c, dtype)
                if first is None:
                    continue
                edges = [(x, nm, co.edge_weights(randomize_bn(init_params(OPS[nm](c, 1), g), g).cuda().eval(),
                                                 nm, dtype)) for x, nm in zip(xs, block)]
                with torch.inference_mode():
                    ref = co.block_stage_reference(edges).float()
                    for ng in (1, 2):
                        plan = first._replace(ng=ng, smem=co._mma_smem(block, c, dtype, *first.tile, first.ns, ng))
                        if plan.smem > co.SMEM_LIMIT:
                            continue
                        out = torch.empty_like(xs[0], memory_format=torch.channels_last)
                        row = {"dtype": dname, "shape": [c, h, w], "edges": list(block), "ns": plan.ns, "ng": ng}
                        for variant, lib in libs.items():
                            co.library = lambda lib=lib: lib  # _launch looks the library up here
                            run = lambda: co._launch("block", xs[0], edges, plan, out)  # noqa: E731
                            if variant in RIGHT:
                                run()
                                torch.cuda.synchronize()
                                rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                                if not rel <= tol:
                                    raise AssertionError(f"{variant} {dname} C={c} {block} {plan}: {rel} > {tol}")
                            row[variant] = device_ms(run)
                            cells[(dname, c, variant, ng)] += row[variant] or float("nan")
                        print(json.dumps(row), flush=True)
    for (dname, c, variant, ng), ms in cells.items():
        print(json.dumps({"cell": dname, "C": c, "variant": variant, "ng": ng, "device_ms": ms}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
