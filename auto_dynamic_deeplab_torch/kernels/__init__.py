"""Hand-written Hopper kernels of the port, each beside its plain version:
K1 ``stems.fused_stems`` (CUDA C++, csrc/stems.cu), K2
``confidence.entropy_argmax_triton`` (Triton), and the cell kernels of the
``--cell-exec flat`` path (CUDA C++, csrc/cell_ops.cu): K3
``cell_ops.block_stage``, K4 ``cell_ops.sep_fused``, K5
``cell_ops.sep_stage`` and K6 ``cell_ops.dense_stage``.

``DEVICE_KERNELS`` names the device kernel each wrapper launches, as
torch.profiler shows it; a CUDA graph's replay calls no wrapper, so its
launches are counted from the profiler's kernel names
(``count_device_kernels``). K3 and K4 launch the same kernel."""
import re
from collections import Counter
from typing import Dict, Iterable

from .cell_ops import block_stage, dense_stage, run_dag, sep_fused, sep_stage
from .confidence import entropy_argmax, entropy_argmax_reference, entropy_argmax_triton
from .stems import fused_stems, stems_reference

DEVICE_KERNELS = {
    "fused_stems": "stems_kernel",
    "entropy_argmax_triton": "entropy_argmax_kernel",
    "block_stage": "block_kernel",
    "sep_fused": "block_kernel",
    "sep_stage": "sep_stage_kernel",
    "dense_stage": "dense_stage_kernel",
}
_DEVICE_NAME = re.compile(r"(?<![\w])(%s)(?![\w])" % "|".join(sorted(set(DEVICE_KERNELS.values()))))


def count_device_kernels(names: Iterable[str]) -> Dict[str, int]:
    """How many of ``names`` (device kernels, as a profiler lists them,
    e.g. ``void block_kernel<float, 1>(Args)``) are each of the port's
    kernels, by the values of ``DEVICE_KERNELS``."""
    counts = Counter()
    for name in names:
        m = _DEVICE_NAME.search(name)
        if m:
            counts[m.group(1)] += 1
    return {k: counts.get(k, 0) for k in sorted(set(DEVICE_KERNELS.values()))}


__all__ = [
    "DEVICE_KERNELS",
    "count_device_kernels",
    "block_stage",
    "dense_stage",
    "entropy_argmax",
    "entropy_argmax_reference",
    "entropy_argmax_triton",
    "fused_stems",
    "run_dag",
    "sep_fused",
    "sep_stage",
    "stems_reference",
]
