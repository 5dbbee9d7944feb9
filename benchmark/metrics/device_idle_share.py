"""Share of the traced window in which no kernel ran on the device (%):
the window's wall time less the union of the kernels' intervals."""
from benchmark.tracing import busy_s


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    window = tr["window"][1] - tr["window"][0]
    busy = busy_s(tr)
    return 100.0 * (window - busy) / window if busy > 0 else None
