"""Device kernels per traced image, counted from the profiler's trace
(graph replays included; copies and memsets left out)."""
from benchmark.tracing import is_kernel


def read(record):
    tr, n = record.get("trace"), len(record.get("traced_exits") or ())
    if not tr or not n:
        return None
    kernels = sum(1 for name, _, _ in tr["device"] if is_kernel(name))
    return kernels / n if kernels else None
