"""The traced window's record, reduced from a ``torch.profiler`` session: the
device's operations, the union of their intervals, and what the host was
doing in each gap between them.

Times are seconds from the start of the window, which the harness marks on
the host with ``record_function(WINDOW)``; the profiler puts host and device
events on one clock.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "benchmark.window"
# host calls that can stand between two device operations, as the profiler
# names them; a gap is put down to the innermost one running at its middle
HOST_CALLS = (
    "aten::copy_", "aten::to", "aten::_to_copy", "aten::clone", "aten::_local_scalar_dense",
    "aten::fill_", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaStreamSynchronize",
    "cudaDeviceSynchronize", "cudaStreamWaitEvent", "cudaEventRecord", "cudaLaunchKernel",
)

Interval = Tuple[float, float]


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a memset."""
    return not name.startswith(("Memcpy", "Memset"))


def reduce_profile(events) -> dict:
    """{"window": (0, length), "device": [(name, start, end)], "host":
    [(name, start, end)]} from a profiler's ``events()``, in seconds from
    the window's start, only what falls inside the window. Raises when the
    window's mark is missing."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window marks, want 1")
    t0, t1 = marks[0].time_range.start, marks[0].time_range.end

    def clip(e):
        a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
        return (e.name, (a - t0) * 1e-6, (b - t0) * 1e-6) if b > a else None

    device, host = [], []
    for e in events:
        if e.name == WINDOW or getattr(e, "is_user_annotation", False):
            continue  # the window's own mark, which the profiler shows on the device too
        if e.device_type == DeviceType.CUDA:
            iv = clip(e)
            if iv:
                device.append(iv)
        elif e.name in HOST_CALLS:
            iv = clip(e)
            if iv:
                host.append(iv)
    device.sort(key=lambda v: v[1])
    return {"window": (0.0, (t1 - t0) * 1e-6), "device": device, "host": host}


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def kernel_union(trace: dict) -> List[Interval]:
    return union([(a, b) for name, a, b in trace["device"] if is_kernel(name)])


def busy_s(trace: dict) -> float:
    """Seconds of the window in which a kernel ran on the device."""
    return sum(b - a for a, b in kernel_union(trace))


def gaps(trace: dict) -> List[Interval]:
    """The window's stretches with no kernel running."""
    out, t = [], trace["window"][0]
    for a, b in kernel_union(trace):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace["window"][1] > t:
        out.append((t, trace["window"][1]))
    return out


def device_ops(trace: dict, top: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds], ...]."""
    total: Dict[str, float] = defaultdict(float)
    for name, a, b in trace["device"]:
        total[name] += b - a
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: dict, top: int = 10) -> List[list]:
    """The idle time by what the host was doing: [[host call, seconds], ...],
    each gap put down to the innermost of ``HOST_CALLS`` running at its
    middle ("host: python" when none was)."""
    total: Dict[str, float] = defaultdict(float)
    host = sorted(trace["host"], key=lambda v: v[1])
    active: list = []
    nxt = 0
    for a, b in gaps(trace):  # in time order: one sweep over the host calls
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][1] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[2] >= mid]
        running = [(e - s, n) for n, s, e in active]
        total[min(running)[1] if running else "host: python"] += b - a
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
