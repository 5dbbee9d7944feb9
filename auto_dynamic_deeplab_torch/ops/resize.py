"""Bilinear resize with the reference's two conventions (ops/resize.py of the
JAX package): ``align_corners=False`` (F.interpolate's default: the decoder
and the cells) and ``align_corners=True`` (nn.Upsample in the ASPP pool
branch). Tensors are NCHW; the interpolation accumulates in fp32 and keeps
the input dtype.

A lower-precision tensor (bf16) is resized one axis at a time and rounded
to its dtype after each axis, as the JAX package does (its gather path,
H then W, and its banded-matmul path for large upscales, the cheaper axis
first); one ``F.interpolate`` over both axes would round once. Where a bf16
path ends in cells that upsample (path [..., 3, 2]), rounding once put the
port's logits 2.4x as far from the fp32 ones as JAX bf16's. fp32 is
resized in one call: the two orders agree to fp32 rounding. JAX's banded
path also rounds its interpolation weights to bf16; the port keeps them
fp32.

A row band (``band.RowBand``, spatial sharding) is resized by
``band.resize_bilinear``: W by ``F.interpolate`` on the band's rows, H on
global source rows by PyTorch's own formula, in the same axis order and
rounding as below.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import band

# JAX's banded-matmul threshold (output elements) for an upscale
_BANDED_MIN_OUT_ELEMS = 1 << 21


def _interpolate(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def resize_bilinear(
    x: torch.Tensor, size, align_corners: bool = False, cheaper_axis_first: bool = False
) -> torch.Tensor:
    """Bilinearly resize NCHW ``x`` to spatial ``size`` = (H_out, W_out).

    ``cheaper_axis_first`` takes the order of the JAX package's
    ``resize_bilinear_cl`` for every upscale (its NHWC ``resize_bilinear``
    does so only above the banded threshold); it matters only below fp32.
    """
    h_out, w_out = int(size[0]), int(size[1])
    n, c, h_in, w_in = band.shape(x)
    if (h_in, w_in) == (h_out, w_out):
        return x
    banded = band.is_band(x)
    if not banded and (x.dtype in (torch.float32, torch.float64) or h_in == h_out or w_in == w_out):
        return _interpolate(x, (h_out, w_out), align_corners)
    up = h_out >= h_in and w_out >= w_in
    w_first = (
        up
        and (cheaper_axis_first or n * c * h_out * w_out >= _BANDED_MIN_OUT_ELEMS)
        and h_out * w_in > w_out * h_in
    )
    if banded:
        return band.resize_bilinear(x, h_out, w_out, align_corners, w_first)
    mid = (h_in, w_out) if w_first else (h_out, w_in)
    return _interpolate(_interpolate(x, mid, align_corners), (h_out, w_out), align_corners)


def resize_bilinear_cl(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """NHWC ``x`` in, class-leading (N, C, H_out, W_out) out: the contract of
    the JAX package's ``resize_bilinear_cl``."""
    return resize_bilinear(x.permute(0, 3, 1, 2), size, align_corners, cheaper_axis_first=True)


def scale_dimension(dim: int, scale: float) -> int:
    """The reference's odd-size scaling rule (modeling/ADD.py:65-66)."""
    return int((float(dim) - 1.0) * scale + 1.0)


def scale_dimension_search(dim: int, scale: float) -> int:
    """Search-cell variant (cell_level_search.py:80-82): even dims use dim*scale."""
    return int((float(dim) - 1.0) * scale + 1.0) if dim % 2 else int(dim * scale)
