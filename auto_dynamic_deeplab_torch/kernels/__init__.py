"""Hand-written Hopper kernels of the port, each beside its plain version:
K1 ``stems.fused_stems`` (CUDA C++, csrc/stems.cu) and K2
``confidence.entropy_argmax_triton`` (Triton)."""
from .confidence import entropy_argmax, entropy_argmax_reference, entropy_argmax_triton
from .stems import fused_stems, stems_reference

__all__ = [
    "entropy_argmax",
    "entropy_argmax_reference",
    "entropy_argmax_triton",
    "fused_stems",
    "stems_reference",
]
