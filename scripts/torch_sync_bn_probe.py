"""Where the data-parallel train step's time goes on one GPU: the flagship
ADD (C=2, F=20, B=5, 19 classes) at 769x769, batch 4, one fixed batch,
under a world-1 NCCL process group, in three modes taken in turns
(single, dp, sync, sync, dp, single):

- ``single``: the single-device ``TrainStep`` (no mesh);
- ``dp``: the data-parallel step (``mesh``: one flat all-reduce of the
  gradients and the loss), BN on each rank's own rows;
- ``sync``: the data-parallel step with cross-replica BN (``--sync-bn``:
  ``ops.norm.set_bn_group``).

Each mode: 3 warm-up steps, 10 timed ones (host clock ending in a
synchronize; the median), then 2 profiled by torch.profiler: device ms,
device kernels and host launches a step, the NCCL kernels' share, and
the host ops with the most self CPU time (ms and calls a step).
Prints one JSON line per mode and run, then a summary line.

    python scripts/torch_sync_bn_probe.py [--dtype fp32|bf16] [--steps 10] \
        [--modes single,sync] [--no-all-reduce]

``--no-all-reduce`` skips every all-reduce (at world 1 the identity), to
part the collectives' cost from the rest of the cross-replica BN; the
NCCL environment (``TORCH_NCCL_*``) is printed with each row.
"""
import argparse
import json
import os
import socket
import statistics
import sys
import time
from collections import Counter

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flagship(dtype):
    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.utils.initialize import init_params

    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"], dtype=dtype)
    return init_params(model, torch.Generator().manual_seed(0))


def run_mode(mode, dtype, image, label, steps):
    from auto_dynamic_deeplab_torch.ops.norm import set_bn_group
    from auto_dynamic_deeplab_torch.parallel import make_data_mesh
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer

    model = flagship(dtype).cuda()
    mesh = None if mode == "single" else make_data_mesh(image.shape[0])
    if mode == "sync":
        set_bn_group(model, mesh.group)
    step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule("poly", 0.01, 1, 1000), mesh=mesh)
    for _ in range(3):
        step(image, label)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(image, label)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(image, label)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / 2
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3 / 2
    host_ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]
    return {"mode": mode, "step_ms_median": statistics.median(times), "step_ms_all": times,
            "loss": float(loss), "device_ms": device_ms, "profiled_step_ms": wall,
            "busy": device_ms / wall, "device_kernels": len(kernels) / 2,
            "host_launches": sum(e.name in HOST_LAUNCHES for e in events) / 2,
            "nccl_kernels": len(nccl) / 2, "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3 / 2,
            "top_kernels_ms": dict(by_name.most_common(8)),
            "top_host_ops": [[a.key[:60], a.self_cpu_time_total / 1e3 / 2, a.count / 2] for a in host_ops],
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--modes", default="single,dp,sync,sync,dp,single", help="the modes, in order")
    p.add_argument("--no-all-reduce", action="store_true",
                   help="measurement variant: every all-reduce is skipped (the identity at world 1)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_sync_bn_probe: needs a GPU")
    from auto_dynamic_deeplab_torch.parallel import destroy, initialize
    from auto_dynamic_deeplab_torch.runtime import resolve_device

    initialize(f"localhost:{free_port()}", 1, 0, device="cuda")
    resolve_device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    if args.no_all_reduce:  # the identity at world 1
        torch.distributed.all_reduce = lambda *a, **k: None
    g = torch.Generator().manual_seed(1)
    image = torch.randn(4, 769, 769, 3, generator=g).cuda()
    label = torch.randint(0, 19, (4, 769, 769), generator=g).cuda()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    rows = {}
    try:
        for mode in args.modes.split(","):
            row = run_mode(mode, dtype, image, label, args.steps)
            row.update(dtype=args.dtype, nvidia_smi=smi, no_all_reduce=args.no_all_reduce,
                       nccl_env={k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")})
            print(json.dumps(row), flush=True)
            rows.setdefault(mode, []).append(row)
            torch.cuda.empty_cache()
    finally:
        destroy()
    summary = {m: {"step_ms": [r["step_ms_median"] for r in rs], "device_ms": [r["device_ms"] for r in rs],
                   "host_launches": rs[0]["host_launches"], "nccl_kernels": rs[0]["nccl_kernels"]}
               for m, rs in rows.items()}
    print(json.dumps({"summary": summary, "dtype": args.dtype, "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
