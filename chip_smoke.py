#!/usr/bin/env python3
"""Drive the PyTorch port (auto_dynamic_deeplab_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 1,2,3  # a subset (device, K1, K2)

Phases, each printing one JSON line and raising on failure:
  1. device: the card, its power limit and the kernels' build time;
  2. K1 (stems, CUDA C++) against its plain version at the main path's
     shapes, fp32 (TF32 off) and bf16, with CUDA-event timings;
  3. K2 (entropy + argmax, Triton) against its plain version;
  4. the flagship ADD (C=2, F=20, B=5, 19 classes, seeded weights and BN
     statistics, fp32) per-exit logits on the card against the same model
     on the CPU at 129x257;
  5. the main path through its entry point, cli.evaluate.main, on
     1025x2049 synthetic images: static, --dynamic entropy at thresholds 0
     and 1.01, --dynamic edm; the kernels' launch counts are read around
     this phase;
  6. the flagship bf16 engine as bench.py builds it: p50 early-exit and
     full-depth latency at 1025x2049, batch 1;
  7. the kernels summary line.
The last lines are the kernels summary, the card's name and power limit
from nvidia-smi, and {"ok": true, "device": {...}}. Without a GPU, or
without the port beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
FULL_HW = (1025, 2049)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _conv_out(n: int) -> int:
    return (n - 1) // 2 + 1


def stems_bound(n, h, w, in_bytes, out_bytes, dtype):
    h0, w0 = _conv_out(h), _conv_out(w)
    h1, w1 = _conv_out(h0), _conv_out(w0)
    flops = 2 * n * ((27 * 64 + 576 * 64) * h0 * w0 + 576 * 128 * h1 * w1)
    weights = 4 * (27 * 64 + 576 * 64 + 576 * 128 + 2 * (64 + 64 + 128))
    nbytes = n * (h * w * 3 * in_bytes + (h0 * w0 * 64 + h1 * w1 * 128) * out_bytes) + weights
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    return bound(flops, nbytes, peak)


def entropy_bound(n, c, h, w, in_bytes):
    # per pixel and class: subtract, exp, add, multiply-add; log + divide per pixel
    flops = n * h * w * (5 * c + 4)
    nbytes = n * h * w * (c * in_bytes + 4)
    return bound(flops, nbytes, H100_FP32_FLOPS)


# ------------------------------------------------------------------ phases


def phase_device(ctx):
    from auto_dynamic_deeplab_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
    ctx["smi"] = nvidia_smi_line()
    emit({
        "phase": "device", "nvidia_smi": ctx["smi"],
        "torch_device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_build_s": build_s, "ptxas": ptxas,
    })


def phase_k1(ctx):
    from auto_dynamic_deeplab_torch.kernels.stems import fused_stems, stems_reference
    from auto_dynamic_deeplab_torch.models.decoded import _Stems
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator().manual_seed(0)
        stems = randomize_bn(init_params(_Stems(dtype), g), g).cuda().eval()
        for hw, n in ((FULL_HW, 1), ((65, 97), 1), ((66, 98), 1), ((257, 513), 2)):
            x = torch.randn(n, *hw, 3, generator=g).cuda().permute(0, 3, 1, 2)
            with torch.inference_mode():
                outs = stems(x)
                refs = stems_reference(stems, x)
                torch.cuda.synchronize()
                abs_err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
                rel = max(
                    ((o.float() - r.float()).abs().max() / r.float().abs().max()).item()
                    for o, r in zip(outs, refs)
                )
                if not rel <= tol:
                    raise AssertionError(f"K1 {dtype} {hw} n={n}: relative error {rel} > {tol}")
                row = {"dtype": str(dtype).split(".")[-1], "hw": list(hw), "n": n,
                       "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": tol}
                if hw == FULL_HW:
                    args = []
                    for i in range(3):
                        args += [getattr(stems, f"stem{i}_conv").kernel,
                                 *getattr(stems, f"stem{i}_bn").folded()]
                    row["ms"] = cuda_ms(lambda: fused_stems(x, *args, out_dtype=dtype))
                    row["plain_ms"] = cuda_ms(lambda: stems_reference(stems, x))
                    row["bound_ms"], row["bound_by"] = stems_bound(
                        n, *hw, 4, torch.finfo(dtype).bits // 8, dtype
                    )
                    ctx.setdefault("k1", {})[row["dtype"]] = row
            rows.append(row)
    emit({"phase": "k1_stems", "checks": rows})


def phase_k2(ctx):
    from auto_dynamic_deeplab_torch.kernels.confidence import (
        entropy_argmax_reference,
        entropy_argmax_triton,
    )

    rows = []
    g = torch.Generator().manual_seed(1)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        cases = [
            ("channels_last", (1, 19, *FULL_HW)), ("nchw", (1, 19, *FULL_HW)),
            ("nhwc", (1, 19, *FULL_HW)), ("nchw", (3, 19, 65, 97)),
        ]
        for layout, shape in cases:
            x = (torch.randn(*shape, generator=g) * 3).cuda()
            axis = 1
            if layout == "nhwc":
                x, axis = x.permute(0, 2, 3, 1).contiguous(), -1
            elif layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            x = x.to(dtype)
            ent, arg = entropy_argmax_triton(x, 19, class_axis=axis)
            ent_r, arg_r = entropy_argmax_reference(x, 19, class_axis=axis)
            torch.cuda.synchronize()
            err = (ent - ent_r).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"K2 {dtype} {layout} {shape}: entropy error {err} > {tol}")
            if not torch.equal(arg, arg_r):
                raise AssertionError(f"K2 {dtype} {layout} {shape}: argmax differs")
            row = {"dtype": str(dtype).split(".")[-1], "layout": layout, "shape": list(shape),
                   "max_abs_err": err, "tol": tol, "argmax_equal": True}
            if shape[0] == 1:
                row["ms"] = cuda_ms(lambda: entropy_argmax_triton(x, 19, class_axis=axis))
                row["plain_ms"] = cuda_ms(lambda: entropy_argmax_reference(x, 19, class_axis=axis))
                row["bound_ms"], row["bound_by"] = entropy_bound(
                    1, 19, *FULL_HW, torch.finfo(dtype).bits // 8
                )
                # the decoder hands K2 (N, C, H, W)-contiguous logits
                if layout == "nchw":
                    ctx.setdefault("k2", {})[row["dtype"]] = row
            rows.append(row)
    emit({"phase": "k2_entropy_argmax", "checks": rows})


def _flagship(dtype=None, seed=0):
    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"], dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    return randomize_bn(init_params(model, g), g).eval()


def phase_model(ctx):
    import copy

    from auto_dynamic_deeplab_torch.runtime import resolve_device

    dev = resolve_device("cuda")  # TF32 off (runtime.ALLOW_TF32)
    cpu_model = _flagship()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    x = torch.randn(1, 129, 257, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        refs = cpu_model(x, class_leading=True)
        outs = gpu_model(x.to(dev), class_leading=True)
    rows = []
    for o, r in zip(outs, refs):
        o = o.float().cpu()
        err = (o - r).abs().max().item()
        tol = 1e-3 * r.abs().max().item()
        if not (torch.isfinite(o).all() and err <= tol):
            raise AssertionError(f"flagship logits on the card differ from the CPU: {err} > {tol}")
        rows.append({"shape": list(o.shape), "max_abs_err": err, "tol": tol})
    if not outs[0].is_contiguous():
        raise AssertionError("class-leading logits should be (N, C, H, W)-contiguous for K2")
    emit({"phase": "flagship_fp32_card_vs_cpu", "hw": [129, 257], "exits": rows})


def phase_main_path(ctx):
    from auto_dynamic_deeplab_torch.cli import evaluate
    from auto_dynamic_deeplab_torch.kernels.confidence import entropy_argmax_triton
    from auto_dynamic_deeplab_torch.kernels.stems import fused_stems

    base = ["--dataset", "synthetic", "--synthetic-crop", str(FULL_HW[0]), str(FULL_HW[1]),
            "--synthetic-length", "32", "--workers", "4"]
    runs = [
        ("static", []),
        ("dynamic_entropy_thr0", ["--dynamic", "--confidence", "entropy", "--threshold", "0"]),
        ("dynamic_entropy_thr1.01", ["--dynamic", "--confidence", "entropy", "--threshold", "1.01"]),
        ("dynamic_edm", ["--dynamic", "--confidence", "edm"]),
    ]
    fused_stems.launches = 0
    entropy_argmax_triton.launches = 0
    total = {"fused_stems": 0, "entropy_argmax_triton": 0}
    for name, extra in runs:
        k1_0, k2_0 = fused_stems.launches, entropy_argmax_triton.launches
        stats = evaluate.main(base + extra)
        k1 = fused_stems.launches - k1_0
        k2 = entropy_argmax_triton.launches - k2_0
        n_img = stats.get("n_images", 8)
        if k1 < n_img:
            raise AssertionError(f"{name}: K1 launched {k1} times for {n_img} images")
        if name == "static":
            if k2 < 2 * n_img:
                raise AssertionError(f"static: K2 launched {k2} times, want >= {2 * n_img}")
            if not all(0.0 <= m <= 1.0 for m in stats["miou"]):
                raise AssertionError(f"static mIoU out of range: {stats['miou']}")
        else:
            if not (0.0 <= stats["miou"] <= 1.0 and stats["mean_latency_s"] > 0):
                raise AssertionError(f"{name}: bad stats {stats}")
            if name.startswith("dynamic_entropy") and k2 < n_img:
                raise AssertionError(f"{name}: K2 launched {k2} times for {n_img} images")
            want = {"dynamic_entropy_thr0": [0, n_img], "dynamic_entropy_thr1.01": [n_img, 0]}
            if name in want and stats["exit_histogram"] != want[name]:
                raise AssertionError(f"{name}: exit histogram {stats['exit_histogram']}")
        emit({"phase": "main_path", "run": name, "stats": stats,
              "launches": {"fused_stems": k1, "entropy_argmax_triton": k2}})
        total["fused_stems"] += k1
        total["entropy_argmax_triton"] += k2
    if fused_stems.launches == 0 or entropy_argmax_triton.launches == 0:
        raise AssertionError(f"a kernel of the main path never launched: {total}")
    ctx["launches"] = total


def phase_bench(ctx):
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    dev = resolve_device("cuda")
    model = _flagship(torch.bfloat16).to(dev)
    engine = DynamicInferenceEngine(model, num_classes=19)
    shape = (1, *FULL_HW, 3)
    engine.warmup(shape, "entropy", 0.0)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name, thr, want_exit in (("early_exit", 1.01, 0), ("full_depth", 0.0, 1)):
        lat = []
        for _ in range(3 + 20):
            x = torch.randn(shape, generator=g, device=dev)
            logits, k, dt, _ = engine.infer(x, threshold=thr, confidence="entropy")
            if k != want_exit or not torch.isfinite(logits).all():
                raise AssertionError(f"{name}: exit {k}, finite={bool(torch.isfinite(logits).all())}")
            lat.append(dt * 1e3)
        lat = lat[3:]
        out[name] = {"p50_ms": statistics.median(lat), "mean_ms": statistics.fmean(lat),
                     "min_ms": min(lat), "max_ms": max(lat), "n": len(lat)}
    torch.cuda.synchronize()
    emit({"phase": "bench_bf16_engine", "hw": list(FULL_HW), "batch": 1, "confidence": "entropy",
          "latency": out, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": ctx["smi"]})


def phase_kernels(ctx):
    k1, k2 = ctx["k1"], ctx["k2"]
    launches = ctx.get("launches", {})

    def entry(name, route, source, replaces, main, other):
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "dtype": main["dtype"],
            "bf16_ms": other["ms"], "bf16_plain_ms": other["plain_ms"],
            "bf16_bound_ms": other["bound_ms"], "bf16_max_abs_err": other["max_abs_err"],
        }

    # the main path (cli.evaluate) runs the fp32 policy; bf16 is bench.py's
    print(json.dumps({"kernels": [
        entry("fused_stems", "cuda", "auto_dynamic_deeplab_torch/csrc/stems.cu",
              "auto_dynamic_deeplab_tpu/kernels/stems.py:266", k1["float32"], k1["bfloat16"]),
        entry("entropy_argmax_triton", "triton",
              "auto_dynamic_deeplab_torch/kernels/_entropy_argmax_triton.py",
              "auto_dynamic_deeplab_tpu/kernels/confidence.py:47", k2["float32"], k2["bfloat16"]),
    ]}), flush=True)


PHASES = {
    1: phase_device, 2: phase_k1, 3: phase_k2, 4: phase_model,
    5: phase_main_path, 6: phase_bench, 7: phase_kernels,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU", file=sys.stderr)
        return 2
    phases = [int(v) for v in args.phases.split(",")]
    ctx = {}
    t0 = time.perf_counter()
    for k in phases:
        if k == 7:
            emit({"phase": "elapsed", "seconds": time.perf_counter() - t0})
        PHASES[k](ctx)
    print(ctx.get("smi") or nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
