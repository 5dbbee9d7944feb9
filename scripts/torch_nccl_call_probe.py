"""What one small NCCL all-reduce costs the host under a world-1 process
group, as the cross-replica BN calls it (a (2, C) fp32 tensor on the
card): the host ms a call in a loop of calls alone, and whether a call
waits for the device's queued work (a call made behind ~50 ms of queued
matmuls returns at once, or only when they are done).

    python scripts/torch_nccl_call_probe.py [--calls 500]

Prints one JSON line with the card's name and power limit.
"""
import argparse
import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def queued_matmuls(a, ms_target=50.0):
    """Enough 4096² matmuls on ``a`` to keep the card busy ~ms_target."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        a @ a
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) * 1e3 / 10
    return max(1, int(ms_target / per)), per


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=500)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_nccl_call_probe: needs a GPU")
    from auto_dynamic_deeplab_torch.parallel import destroy, initialize

    initialize(f"localhost:{free_port()}", 1, 0, device="cuda")
    row = {"nvidia_smi": os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip(),
           "torch": torch.__version__, "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        x = torch.randn(2, 160, device="cuda")
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            dist.all_reduce(x)
        host = (time.perf_counter() - t0) * 1e3 / args.calls
        torch.cuda.synchronize()
        row["all_reduce_host_ms_per_call"] = host
        row["all_reduce_ms_per_call_synced"] = (time.perf_counter() - t0) * 1e3 / args.calls
        t0 = time.perf_counter()
        for _ in range(args.calls):
            x.add_(1.0)
        row["add_host_ms_per_call"] = (time.perf_counter() - t0) * 1e3 / args.calls
        torch.cuda.synchronize()

        a = torch.randn(4096, 4096, device="cuda")
        n, per = queued_matmuls(a)
        for name, fn in (("all_reduce", lambda: dist.all_reduce(x)), ("add", lambda: x.add_(1.0)),
                         ("item", lambda: x[0, 0].item())):
            for _ in range(n):
                a @ a
            t0 = time.perf_counter()
            fn()
            row[f"{name}_behind_{n * per:.0f}ms_of_queued_work_host_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
    finally:
        destroy()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
