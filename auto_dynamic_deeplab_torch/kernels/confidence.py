"""K2: fused softmax-entropy + argmax over class logits, in Triton.

Replaces auto_dynamic_deeplab_tpu/kernels/confidence.py::entropy_argmax_pallas.
One pass over the logits returns the per-image normalized Shannon entropy
(the mean over pixels of -Σ p log p, divided by log C) and the per-pixel
argmax (first maximal index on ties, as torch.argmax and jnp.argmax).

Bound on an H100 SXM at (1, 19, 1025, 2049): the pass is memory-bound —
80 MB of bf16 logits (160 MB fp32) read once plus 8 MB of int32 argmax
written: 26 us in bf16, 50 us in fp32 at 3.35 TB/s. The arithmetic
(a max, 19 exps, a log and a few sums per pixel) is far below the card's
rate.

Design: each program reads a block of pixels of one image with all C
classes padded to a power of two (padded classes load as -inf, so they add
0 to Z and never win the argmax), computes the max m, Z = Σ exp(x - m) and
the entropy as log Z - Σ e·(x - m) / Z, writes the argmax, and writes one
partial entropy sum. The wrapper reduces the partials with one
deterministic torch.sum (no atomics) and divides by H·W and log(num_classes).
It takes class-leading (N, C, H, W) and NHWC logits of any memory format
whose pixels are evenly strided (both contiguous layouts and channels_last),
at any N, in fp32 or bf16. Triton is imported only when the kernel launches.
"""
from __future__ import annotations

import math

import torch

from ..ops.confidence import normalized_shannon_entropy

BLOCK_P = 256  # pixels per program


def entropy_argmax_reference(
    logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1
):
    """Plain version: (normalized entropy (N,) fp32, argmax (N, H, W) int32)."""
    return (
        normalized_shannon_entropy(logits, num_classes, class_axis),
        logits.argmax(dim=class_axis).to(torch.int32),
    )


def entropy_argmax_triton(
    logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1
):
    """Launch K2 on CUDA ``logits``; same contract as the plain version."""
    if logits.device.type != "cuda":
        raise ValueError(f"entropy_argmax_triton needs a CUDA tensor, got {logits.device}")
    if logits.dim() != 4:
        raise ValueError(f"expected 4-D logits, got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported logits dtype {logits.dtype}")
    if class_axis not in (1, -1, 3):
        raise ValueError(f"class_axis must be 1 or -1, got {class_axis}")
    # (N, C, H, W) or (N, H, W, C) sizes and strides, as (n, c, h, w)
    order = (0, 1, 2, 3) if class_axis == 1 else (0, 3, 1, 2)
    n, c, h, w = (logits.shape[d] for d in order)
    sn, sc, sh, sw = (logits.stride(d) for d in order)
    if sh != w * sw:  # pixels not evenly strided: make them so
        logits = logits.contiguous()
        sn, sc, sh, sw = (logits.stride(d) for d in order)

    import triton

    from ._entropy_argmax_triton import entropy_argmax_kernel

    grid = (triton.cdiv(h * w, BLOCK_P), n)
    partials = torch.empty(grid[::-1], dtype=torch.float32, device=logits.device)
    arg = torch.empty((n, h, w), dtype=torch.int32, device=logits.device)
    entropy_argmax_kernel[grid](
        logits, partials, arg, h * w, c, sn, sw, sc,
        BLOCK_P=BLOCK_P, BLOCK_C=triton.next_power_of_2(c), num_warps=4,
    )
    entropy_argmax_triton.launches += 1
    ent = partials.sum(dim=1) / (h * w) / math.log(num_classes)
    return ent, arg


entropy_argmax_triton.launches = 0


def entropy_argmax(logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1):
    """K2 for CUDA logits, the plain version for CPU logits."""
    if logits.device.type == "cuda":
        return entropy_argmax_triton(logits, num_classes, class_axis)
    if logits.device.type == "cpu":
        return entropy_argmax_reference(logits, num_classes, class_axis)
    raise ValueError(f"unsupported device {logits.device}")
