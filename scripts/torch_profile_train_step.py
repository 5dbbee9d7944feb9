"""Where the time goes in one training step of the port on the GPU.

Builds the flagship ADD (C=2, F=20, B=5, 19 classes, seeded weights) of
auto_dynamic_deeplab_torch and trains it with ``TrainStep`` (SGD with
Nesterov momentum, the multi-exit loss) on one synthetic batch at the
reference's train crop. For each policy it prints one JSON line: the step
time (host clock over ``--steps`` steps ending in a synchronize, after 3
warm-up steps), the images a second, the peak memory, and from
torch.profiler over 3 more steps the device kernel time, the device
kernels and host launch calls a step, the device busy share (kernel time
over the profiled wall time; the profiler's own host work is in that wall
time) and the kernels with the most device time.

    python scripts/torch_profile_train_step.py [--dtype fp32 bf16] [--remat]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from auto_dynamic_deeplab_torch.data import SyntheticSegmentation  # noqa: E402
from auto_dynamic_deeplab_torch.models import ADD  # noqa: E402
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH  # noqa: E402
from auto_dynamic_deeplab_torch.runtime import resolve_device  # noqa: E402
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule  # noqa: E402
from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params  # noqa: E402

# the host calls that put work on the card, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile(dtype_name: str, hw, batch: int, steps: int, remat: bool, top: int) -> dict:
    dev = resolve_device("cuda")
    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"],
                dtype=torch.bfloat16 if dtype_name == "bf16" else None, remat=remat)
    model = init_params(model, torch.Generator().manual_seed(0)).to(dev)
    step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule("poly", 0.05, 1, 1000))
    items = [SyntheticSegmentation(batch, hw)[i] for i in range(batch)]
    image = torch.stack([torch.from_numpy(s["image"]) for s in items]).to(dev)
    label = torch.stack([torch.from_numpy(s["label"]) for s in items]).to(dev)
    for _ in range(3):
        step(image, label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(image, label)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    n_prof = 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step(image, label)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    launches = sum(1 for e in prof.events() if e.name in HOST_LAUNCH_CALLS)
    return {
        "dtype": dtype_name, "remat": remat, "hw": list(hw), "batch": batch, "steps": steps,
        "step_ms": step_ms, "images_per_s": batch * 1e3 / step_ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_wall_ms_per_step": wall_ms / n_prof, "device_ms_per_step": device_ms / n_prof,
        "device_busy": device_ms / wall_ms, "device_kernels_per_step": len(kernels) / n_prof,
        "host_launches_per_step": launches / n_prof,
        "top_kernels_ms_per_step": sorted(((k[:90], v / n_prof) for k, v in by_name.items()),
                                          key=lambda kv: -kv[1])[:top],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", nargs="+", default=["fp32", "bf16"], choices=["fp32", "bf16"])
    p.add_argument("--hw", type=int, nargs=2, default=(769, 769))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--top", type=int, default=8)
    args = p.parse_args(argv)
    for dtype_name in args.dtype:
        print(json.dumps(profile(dtype_name, tuple(args.hw), args.batch, args.steps, args.remat, args.top)),
              flush=True)


if __name__ == "__main__":
    main()
