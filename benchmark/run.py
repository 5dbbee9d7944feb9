"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload add_c2.xla.exit70 --seed 7 --seconds 10 --trace 0

from the root of a checkout that holds the program (``auto_dynamic_deeplab_torch``).
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics
(host clock); with ``--trace 1`` its per-layer metrics (the profiler's trace
of the window's first blocks, the engine's counters), with the device's
busy and window seconds and a breakdown. Either way the run ends by
comparing a seeded sample of the window's answers with the plain reference
(``correctness``) and prints each number compared beside its limit, as its
last lines on standard error and under ``checks``, the last key of the
result.

It exits non-zero, printing no result, without enough CUDA devices for the
cell, and when a module of JAX or of the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the program's kernel caches stay inside the checkout, at fixed paths (nvcc's
# libraries go to build/torch_kernels/ by the program's own rule)
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ.setdefault("USE_FLAX", "0")

# top-level module names that may not be loaded: JAX, its libraries and the
# JAX package this program is a port of (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "auto_dynamic_deeplab_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN})


def _finite(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


def result_line(cell: dict, record: dict, trace: bool, device_kind: str, device_count: int) -> dict:
    """The result object a run prints last, for its ``record``."""
    from . import spec, tracing

    metrics = spec.read_metrics(cell["per_layer"] if trace else cell["end_to_end"], record)
    device = {"platform": "gpu", "kind": device_kind, "count": device_count,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": bool(record["correct"]), "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device}
    if trace:
        tr = record["trace"]
        device["busy_s"] = tracing.busy_s(tr)
        device["window_s"] = tr["window"][1] - tr["window"][0]
        out["breakdown"] = {"device_ops": tracing.device_ops(tr), "idle_gaps": tracing.idle_gaps(tr)}
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in record["checks"].items()}
    return out


def trace_notes(record: dict) -> list:
    """Lines that say where the traced kernels differ from what the traced
    images need: one K1 (the stems) an image."""
    from . import tracing

    k1 = sum(1 for name, _, _ in record["trace"]["device"] if "stems_kernel" in name)
    n = len(record["traced_exits"])
    kernels = sum(1 for name, _, _ in record["trace"]["device"] if tracing.is_kernel(name))
    notes = [f"trace: {n} images, {kernels} kernels, {k1} K1 launches"]
    if k1 != n:
        notes.append(f"trace: K1 ran {k1} times for {n} images: the profiler lost or added kernels")
    return notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    print(f"set-up: python and torch imported {time.perf_counter() - T_START:.2f} s", file=sys.stderr, flush=True)
    from . import correctness, spec

    cell = spec.cell(args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    runner = importlib.import_module(f".runners.{cell['traffic']['runner']}", __package__)
    record = runner.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    if args.trace:
        for line in trace_notes(record):
            print(line, file=sys.stderr, flush=True)
    out = result_line(cell, record, bool(args.trace), torch.cuda.get_device_name(0), chips)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stderr.write("".join(line + "\n" for line in correctness.lines(record["checks"])))
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
