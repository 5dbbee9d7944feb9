"""Bilinear resize with the reference's two conventions (ops/resize.py of the
JAX package): ``align_corners=False`` (F.interpolate's default: the decoder
and the cells) and ``align_corners=True`` (nn.Upsample in the ASPP pool
branch). Tensors are NCHW; the interpolation accumulates in fp32 and keeps
the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinearly resize NCHW ``x`` to spatial ``size`` = (H_out, W_out)."""
    h_out, w_out = int(size[0]), int(size[1])
    if tuple(x.shape[2:]) == (h_out, w_out):
        return x
    return F.interpolate(
        x, size=(h_out, w_out), mode="bilinear", align_corners=align_corners
    )


def resize_bilinear_cl(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """NHWC ``x`` in, class-leading (N, C, H_out, W_out) out: the contract of
    the JAX package's ``resize_bilinear_cl``."""
    return resize_bilinear(x.permute(0, 3, 1, 2), size, align_corners)


def scale_dimension(dim: int, scale: float) -> int:
    """The reference's odd-size scaling rule (modeling/ADD.py:65-66)."""
    return int((float(dim) - 1.0) * scale + 1.0)


def scale_dimension_search(dim: int, scale: float) -> int:
    """Search-cell variant (cell_level_search.py:80-82): even dims use dim*scale."""
    return int((float(dim) - 1.0) * scale + 1.0) if dim % 2 else int(dim * scale)
