"""Milliseconds a kernel ran on the device per traced image (the union of
the kernels' intervals over the traced images): the device's share of a
request, steady where the host's upload and launches make the host-clock
metrics spread."""
from benchmark.tracing import busy_s


def read(record):
    tr, n = record.get("trace"), len(record.get("traced_exits") or ())
    if not tr or not n:
        return None
    busy = busy_s(tr)
    return 1e3 * busy / n if busy > 0 else None
