"""The cells' DAG work that the cell kernels (K3-K6) do: per block, the
depthwise taps and pools on the CUDA cores, the pointwise and dense
products on the tensor cores, each distinct source read once and the
block's output written once (a frozen copy of the port's
``chip_smoke.py::_edge_flops``, ``_block_flops`` and ``cell_bound``,
against published peaks). The cells' 1x1 preprocess (cuDNN) is not in it.
"""
from __future__ import annotations

from typing import Sequence

from ..reference.add import FM, scale_dimension
from . import peaks


def edge_flops(name: str, c: int):
    """(CUDA-core FLOP, product FLOP) a pixel of one primitive at C in =
    C out, a multiply-add counting 2."""
    if name.startswith("sep_conv"):
        k = int(name[-1])
        return 2 * 2 * k * k * c, 2 * 2 * c * c
    if name.startswith("dil_conv"):
        k = int(name[-1])
        return 0, 2 * k * k * c * c
    return (9 * c if name.endswith("pool_3x3") else 0), 0


def block_flops(names: Sequence[str], c: int):
    """(CUDA-core, product) FLOP a pixel of one block: its edges, and one
    add a value for each edge past the first."""
    cuda = sum(edge_flops(n, c)[0] for n in names) + c * (len(names) - 1)
    return cuda, sum(edge_flops(n, c)[1] for n in names)


def block_bound_s(names: Sequence[str], n_sources: int, c: int, h: int, w: int, dtype: str = "float32") -> float:
    """The least time of one block: the CUDA cores' time or the tensor
    cores' (the two may run at once), or the bytes', whichever is larger."""
    elem = 4 if dtype == "float32" else 2
    cuda, product = block_flops(names, c)
    t_ops = max(h * w * cuda / peaks.FP32_FLOPS, h * w * product / peaks.TENSOR_FLOPS[dtype])
    return max(t_ops, (n_sources + 1) * h * w * c * elem / peaks.BYTES_PER_S)


def cells_bound_s(arch, cells: Sequence[int], image_hw, dtype: str = "float32") -> float:
    """Σ of ``block_bound_s`` over the blocks of ``cells`` (indices on the
    path of ``arch``, a ``reference.add.Arch``) whose DAG does any work."""
    total = 0.0
    for i in cells:
        level = arch.path[i]
        s = 2.0 ** -(level + 2)
        h, w = scale_dimension(image_hw[0], s), scale_dimension(image_hw[1], s)
        c = arch.F * FM[level]
        for rows in arch.blocks():
            names = [n for _, _, n in rows if n != "none"]
            if any(n.startswith(("sep_conv", "dil_conv")) or n.endswith("pool_3x3") for n in names):
                total += block_bound_s(names, len({j for j, _, _ in rows}), c, h, w, dtype)
    return total
