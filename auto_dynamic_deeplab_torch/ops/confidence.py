"""Exit-confidence signals (ops/confidence.py of the JAX package). Both
return per-image (N,) fp32 device tensors; the engine reads back one
scalar per decision."""
from __future__ import annotations

import math
from typing import Union

import torch


def normalized_shannon_entropy(
    logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1
) -> torch.Tensor:
    """Mean per-pixel Shannon entropy of softmax(logits), normalized by
    log(num_classes). (N, H, W, C), or (N, C, H, W) with class_axis=1,
    → (N,). Low = confident."""
    logp = torch.log_softmax(logits.float(), dim=class_axis)
    ent = -(logp.exp() * logp).sum(dim=class_axis)  # (N, H, W)
    return ent.mean(dim=(1, 2)) / math.log(num_classes)


def confidence_max(
    logits: torch.Tensor, threshold: Union[float, torch.Tensor], class_axis: int = -1
) -> torch.Tensor:
    """Fraction of pixels whose max softmax probability exceeds threshold.
    High = confident. ``threshold`` is a float or a 0-d fp32 tensor on the
    logits' device (a CUDA graph's static input); either compares in fp32."""
    p = torch.softmax(logits.float(), dim=class_axis)
    max_map = p.amax(dim=class_axis)
    return (max_map > threshold).float().mean(dim=(1, 2))
