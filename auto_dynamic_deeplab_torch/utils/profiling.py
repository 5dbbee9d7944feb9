"""Tracing and device-time measurement (utils/profiling.py of the JAX
package; the reference's cuda.synchronize + perf_counter brackets,
ADD.py:380-437, and ptflops probes).

- ``trace(logdir)``: a ``torch.profiler`` run (CPU, and CUDA when a
  GPU is present) whose Chrome trace is written to ``logdir/trace.json``.
- ``device_time(fn, *args)``: median seconds per call, each call fenced by
  ``torch.cuda.synchronize()`` when CUDA is in use.
- ``flops_of(fn, *args)``: the FLOPs of the PyTorch ops ``fn`` dispatches
  (utils/flops.py).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from .flops import cost_analysis

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler. Writes
    ``logdir/trace.json`` (chrome://tracing, Perfetto) on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _fence():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_time(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of ``fn(*args)`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    _fence()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _fence()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def flops_of(fn: Callable, *args) -> float:
    return cost_analysis(fn, *args)["flops"]
