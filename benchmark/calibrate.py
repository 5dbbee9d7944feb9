"""The readings that a cell's limits are set from: the program's numbers
compared, over many seeds, and its lower-precision controls' (the
program's TF32 path, ``runtime.ALLOW_TF32``, the nearest precision below
the configuration's float32 with TF32 off; and its bf16 path), each at the
cell's own size and load, in one process so that set-up is paid once a run
and not once a process. The benchmark's own runs never run the controls.

    python3 -m benchmark.calibrate --workload add_c2.xla.exit70 \\
        --seeds 101-112 --control-seeds 201-203 --seconds 2

prints one JSON line a run and a summary: the largest reading of the sound
runs (the lower reading) and the smallest of each control (the upper).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control-seeds", default="201-203")
    p.add_argument("--controls", default="tf32,bf16")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from . import spec
    from .runners import early_exit

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    runs = [(None, s) for s in _seeds(args.seeds)]
    runs += [(v, s) for v in args.controls.split(",") if v for s in _seeds(args.control_seeds)]
    readings = {}
    for variant, seed in runs:
        rec = early_exit.run(cell, seed, args.seconds, False, time.perf_counter(), variant=variant)
        values = {k: c["value"] for k, c in rec["checks"].items()}
        readings.setdefault(variant or "program", []).append(values)
        print(json.dumps({"workload": args.workload, "variant": variant or "program", "seed": seed,
                          "correct": rec["correct"], "completed": rec["completed"],
                          "setup_s": rec["setup_s"], "values": values}), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}
    for name, rows in readings.items():
        pick = max if name == "program" else min
        summary[name] = {k: pick(r[k] for r in rows) for k in rows[0]}
        summary[name]["runs"] = len(rows)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
