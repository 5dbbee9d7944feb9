"""Hand-written Hopper kernels of the port, each beside its plain version:
K1 ``stems.fused_stems`` (CUDA C++, csrc/stems.cu), K2
``confidence.entropy_argmax_triton`` (Triton), and the cell kernels of the
``--cell-exec flat`` path (CUDA C++, csrc/cell_ops.cu): K3
``cell_ops.block_stage``, K4 ``cell_ops.sep_fused``, K5
``cell_ops.sep_stage`` and K6 ``cell_ops.dense_stage``."""
from .cell_ops import block_stage, dense_stage, run_dag, sep_fused, sep_stage
from .confidence import entropy_argmax, entropy_argmax_reference, entropy_argmax_triton
from .stems import fused_stems, stems_reference

__all__ = [
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
