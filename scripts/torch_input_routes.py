"""Where cli.train's step loses time against a step on one resident batch:
the flagship ADD (C=2, F=20, B=5, 19 classes, seeded weights) trained
through ``Trainer`` at batch 4 and 769x769 on a seeded Cityscapes-layout
tree (16 1024x2048 train frames over two cities, written with Pillow into
a temporary directory), by five routes:

  host      the host loader's augmented batches (native engine, 4 threads)
  device    the host loader's decode-only uint8 batches, augmented on the card
  cache     a RawArrayCache of the decoded frames through the host loader,
            augmented on the card
  resident  the cache's batches uploaded to the card beforehand, augmented there
  fixed     one augmented batch on the card, fed at every step (no loader,
            no upload, no augment: scripts/torch_profile_train_step.py's step)

Each dtype runs its routes in turns, in the order above and then reversed.
A run trains ``--epochs`` epochs; its steps are the CUDA-event step times
(``Trainer.step_ms``) of every epoch after the first, less each epoch's
first step (which waits for the loader's first batch). One more epoch runs
under torch.profiler: the device kernel ms a step and the device busy
share (kernel time over the epoch's wall time; the profiler's own host
work is in that wall time). Each run records the host's load average as it
starts. Then the host loader alone, over ``--loader-epochs`` passes of the
train frames (native engine, PIL, decode only; 4 threads, batch 4): the ms
a batch of the first pass and the median of the later ones.

One JSON line a run, then one summary line a dtype (each route's median
step ms over its runs, its median device ms a step and busy share), then
the loader line and the card's name and power limit.

    python scripts/torch_input_routes.py [--dtype fp32 bf16] [--routes host device cache resident fixed] \\
        [--epochs 4] [--loader-epochs 5]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time

import torch

_REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))

from chip_smoke import TRAIN_HW, _city_frames, _flagship, _write_city_tree, nvidia_smi_line  # noqa: E402
from auto_dynamic_deeplab_torch.data import CityscapesSegmentation, DataLoader, RawArrayCache, peek_batch  # noqa: E402
from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

ROUTES = ("host", "device", "cache", "resident", "fixed")
BATCH, WORKERS = 4, 4


class _OnCard:
    """Batches already on the card, served as a train loader."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def _loaders(root: str, cache_dir: str) -> dict:
    """Each route's train loader and whether it feeds raw uint8 batches."""
    host = DataLoader(CityscapesSegmentation(root, "train", crop_size=TRAIN_HW), BATCH, num_workers=WORKERS)
    raw = DataLoader(CityscapesSegmentation(root, "train", raw=True), BATCH, num_workers=WORKERS)
    cache = RawArrayCache.build(CityscapesSegmentation(root, "train", raw=True), cache_dir)
    cached = DataLoader(cache, BATCH, num_workers=WORKERS)
    resident = _OnCard([{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in cached])
    one = peek_batch(host)
    fixed = _OnCard([{k: torch.as_tensor(v).cuda() for k, v in one.items()}] * len(host))
    return {"host": (host, False), "device": (raw, True), "cache": (cached, True),
            "resident": (resident, True), "fixed": (fixed, False)}


def _profiled_epoch(trainer: Trainer, epoch: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.training(epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = len(trainer.step_ms)
    return {"device_ms_per_step": device_ms / steps, "profiled_wall_ms_per_step": wall_ms / steps,
            "device_busy": device_ms / wall_ms}


def run_route(route: str, loader, raw: bool, dtype_name: str, epochs: int, tmp: str, turn: int) -> dict:
    model = _flagship(torch.bfloat16 if dtype_name == "bf16" else None, seed=5)
    cfg = TrainConfig(epochs=epochs + 1, eval_interval=0, run_dir=tmp, checkname=f"{dtype_name}_{route}_{turn}",
                      device_augment=raw, crop_size=TRAIN_HW if raw else None)
    load = os.getloadavg()[0]
    trainer = Trainer(model, loader, None, cfg, device="cuda")
    steps = []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        trainer.training(epoch)
        if epoch:
            steps.extend(trainer.step_ms[1:])
    wall = time.perf_counter() - t0
    row = {"route": route, "dtype": dtype_name, "turn": turn, "loadavg_1min": load, "wall_s": wall,
           "step_ms": steps, "step_ms_median": statistics.median(steps)}
    row.update(_profiled_epoch(trainer, epochs))
    return row


def loader_alone(root: str, passes: int) -> dict:
    out = {}
    for name, env, kw in (("native", "1", {"crop_size": TRAIN_HW}), ("pil", "0", {"crop_size": TRAIN_HW}),
                          ("decode_only", "1", {"raw": True})):
        os.environ["ADD_TPU_NATIVE"] = env
        try:
            loader = DataLoader(CityscapesSegmentation(root, "train", **kw), BATCH, num_workers=WORKERS)
            per_pass = []
            for epoch in range(passes):
                loader.set_epoch(epoch)
                t0 = time.perf_counter()
                n = sum(len(b[next(iter(b))]) for b in loader)
                per_pass.append((time.perf_counter() - t0) * 1e3 * BATCH / n)
        finally:
            os.environ.pop("ADD_TPU_NATIVE")
        warm = statistics.median(per_pass[1:])
        out[name] = {"ms_per_batch_by_pass": per_pass, "ms_per_batch_first": per_pass[0],
                     "ms_per_batch_warm_median": warm, "images_per_s_warm": BATCH * 1e3 / warm}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", nargs="+", default=["fp32", "bf16"], choices=["fp32", "bf16"])
    p.add_argument("--epochs", type=int, default=4, help="epochs a run; the first is not counted")
    p.add_argument("--routes", nargs="+", default=list(ROUTES), choices=ROUTES)
    p.add_argument("--loader-epochs", type=int, default=5)
    args = p.parse_args(argv)
    routes = tuple(r for r in ROUTES if r in args.routes)
    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cityscapes")
        _write_city_tree(pathlib.Path(root), [f for f in _city_frames() if f[0] == "train"])
        loaders = _loaders(root, os.path.join(tmp, "cache"))
        for dtype_name in args.dtype:
            rows = []
            for turn, route in enumerate(routes + routes[::-1]):
                loader, raw = loaders[route]
                row = run_route(route, loader, raw, dtype_name, args.epochs, tmp, turn)
                print(json.dumps({**row, "nvidia_smi": smi}), flush=True)
                rows.append(row)
            summary = {}
            for route in routes:
                mine = [r for r in rows if r["route"] == route]
                summary[route] = {
                    "step_ms_median": statistics.median([s for r in mine for s in r["step_ms"]]),
                    "device_ms_per_step": statistics.median([r["device_ms_per_step"] for r in mine]),
                    "device_busy": statistics.median([r["device_busy"] for r in mine]),
                    "steps": sum(len(r["step_ms"]) for r in mine),
                }
            print(json.dumps({"summary": dtype_name, "routes": summary, "nvidia_smi": smi}), flush=True)
        print(json.dumps({"loader_alone": loader_alone(root, args.loader_epochs), "batch": BATCH,
                          "workers": WORKERS, "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
