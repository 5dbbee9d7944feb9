"""The cell kernels' (K3-K6) share of their roofline (%): the least time of
the DAG blocks of the cells the traced images ran (``counts.cells``, published
peaks) over the device time of ``block_kernel``, ``sep_stage_kernel`` and
``dense_stage_kernel`` in the trace. Nothing to read where they did not run."""
import re

from benchmark.counts import cells

KERNELS = re.compile(r"(?<![\w])(block_kernel|sep_stage_kernel|dense_stage_kernel)(?![\w])")


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    device = sum(b - a for name, a, b in tr["device"] if KERNELS.search(name))
    if device <= 0:
        return None
    arch, hw, dtype = record["arch"], record["image_hw"], record["cell"]["config"]["dtype"]
    bound = sum(cells.cells_bound_s(arch, range(arch.exits[k] + 1), hw, dtype) for k in record["traced_exits"])
    return 100.0 * bound / device
