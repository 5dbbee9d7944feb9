#!/usr/bin/env python3
"""Peak device memory and step times of one bilevel NAS search iteration
(auto_dynamic_deeplab_torch.train.step.SearchSteps) on one NVIDIA GPU.

    python scripts/torch_search_memory.py [--out search_memory.jsonl]

Configurations, fp32 (TF32 off), 19 classes, 321x321 synthetic images,
weights from a seed, the published recipe's optimizers (SGD lr 0.05 with
momentum 0.9 and decay 8e-4; Adam lr 1e-3, L2 1e-3):
  * the published net_supernet (ModelNetSearch, 12 layers, F=20, B=5, the
    shipped cell, exits at layer 5 and 11), batch 16, with per-cell remat
    (cli.search's default) and without (--no-remat);
  * the mixed cell+path supernet (ModelSearch, 12 layers, F=20, B=5, exits
    at 5 and 11) with remat at batch 1, 2 and 4, stopping at the first
    out-of-memory, which is reported as a row.
Each configuration: one warm-up iteration on a fixed batch, then one timed
(host clock around each step, ending in a synchronize) with the peak of
``max_memory_allocated`` over it; the net_supernet rows then profile one
more iteration with torch.profiler for the device time (the sum of its
device kernels), the count of device kernels, the busy share (device
time / step time) and the kernels that take the most device time. One
JSON line a row, then the card's name and power limit from nvidia-smi.
Without a GPU it exits non-zero.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from auto_dynamic_deeplab_torch.data import SyntheticSegmentation  # noqa: E402
from auto_dynamic_deeplab_torch.models import ModelNetSearch, ModelSearch  # noqa: E402
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE  # noqa: E402
from auto_dynamic_deeplab_torch.runtime import resolve_device  # noqa: E402
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule  # noqa: E402
from auto_dynamic_deeplab_torch.train.step import SearchSteps, make_arch_optimizer, make_optimizer  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params  # noqa: E402

HW = (321, 321)


def batch(n: int):
    items = [SyntheticSegmentation(n, HW)[i] for i in range(n)]
    image = torch.from_numpy(np.stack([s["image"] for s in items])).cuda()
    label = torch.from_numpy(np.stack([s["label"] for s in items])).cuda()
    return image, label


def steps_for(model):
    return SearchSteps(model, make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=8e-4),
                       make_arch_optimizer(model.arch_parameters(), 1e-3), lr_schedule("cos", 0.05, 10, 10, min_lr=0.003))


def iteration(steps, image, label):
    """(weight ms, arch ms), each on the host clock ending in a synchronize."""
    out = []
    for fn in (steps.weight_step, steps.arch_step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn(image, label)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss.item()}")
    return out


def profiled(steps, image, label, top=8):
    """Device ms, device kernels and the ``top`` kernels by device ms
    (name, ms, count) of one iteration by torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        iteration(steps, image, label)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels),
            [[name[:90], ms, n] for name, (ms, n) in ranked])


def measure(name, model, n, profile=False):
    row = {"config": name, "batch": n, "remat": model.remat}
    steps = steps_for(model)
    try:
        image, label = batch(n)
        iteration(steps, image, label)  # warm-up: cuDNN's first calls
        torch.cuda.reset_peak_memory_stats()
        w_ms, a_ms = iteration(steps, image, label)
        row.update(weight_ms=w_ms, arch_ms=a_ms, images_per_s=n * 1e3 / (w_ms + a_ms),
                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        if profile:
            dev_ms, kernels, top = profiled(steps, image, label)
            row.update(device_ms=dev_ms, device_kernels=kernels, busy=dev_ms / (w_ms + a_ms), top_kernels=top)
    except torch.cuda.OutOfMemoryError as exc:
        row.update(oom=True, error=str(exc).splitlines()[0][:300])
    finally:
        steps.w_optimizer.state.clear()
        steps.a_optimizer.state.clear()
        for p in model.parameters():
            p.grad = None
        del steps
        gc.collect()
        torch.cuda.empty_cache()
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the rows here (JSON lines)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_search_memory: no GPU", file=sys.stderr)
        return 2
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rows = []

    def emit(row):
        row["nvidia_smi"] = smi
        rows.append(row)
        print(json.dumps(row), flush=True)

    g = torch.Generator().manual_seed(0)
    net = init_params(ModelNetSearch(19, AUTODEEPLAB_GENOTYPE, 12, 20, 5, C_index=(5,)), g).cuda()
    n_params = sum(p.numel() for p in net.weight_parameters())
    for remat in (True, False):
        net.remat = remat
        emit({**measure("net_supernet", net, 16, profile=True), "weight_params": n_params})
    del net
    gc.collect()
    torch.cuda.empty_cache()

    mixed = init_params(ModelSearch(19, 12, 20, 5, exit_layer=5), g).cuda()
    n_params = sum(p.numel() for p in mixed.weight_parameters())
    for n in (1, 2, 4):
        row = measure("supernet (mixed)", mixed, n)
        emit({**row, "weight_params": n_params})
        if row.get("oom"):
            break
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
