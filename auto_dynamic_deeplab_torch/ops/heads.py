"""DeepLabV3+ decoder head (modeling/decoder.py) and the low-level skip conv
(ops/heads.py of the JAX package)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import band
from .norm import BatchNorm
from .primitives import Conv2d
from .resize import resize_bilinear


class DecoderHead(nn.Module):
    """Upsample the ASPP output to the low-level size, concat (256+48), two
    3x3 ReLU-conv-BN refinements, an fp32 classifier with bias, then the
    final upsample to ``size``. All resizes are align_corners=False.

    Under a bf16 policy the eval logits are cast to bf16 before the final
    resize (ops/heads.py:63-64 of the JAX package) unless
    ``fp32_eval_logits``; training keeps them fp32 for the loss. Returns
    NHWC logits, or (N, C, H, W) with ``class_leading``.
    """

    def __init__(
        self, num_classes: int, in_features: int = 256, low_level_features: int = 48,
        dtype: Optional[torch.dtype] = None, fp32_eval_logits: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.fp32_eval_logits = fp32_eval_logits
        self.conv1 = Conv2d(in_features + low_level_features, 256, 3, padding=1, dtype=dtype)
        self.bn1 = BatchNorm(256, dtype=dtype)
        self.conv2 = Conv2d(256, 256, 3, padding=1, dtype=dtype)
        self.bn2 = BatchNorm(256, dtype=dtype)
        self.classifier = Conv2d(256, num_classes, 1, use_bias=True, dtype=torch.float32)

    def forward(
        self, x: torch.Tensor, low_level: torch.Tensor, size, class_leading: bool = False
    ) -> torch.Tensor:
        x = resize_bilinear(x, band.shape(low_level)[2:], align_corners=False)
        x = F.relu(torch.cat([x, low_level], dim=1))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        # class-leading contiguous from here on (cheap at head resolution):
        # the full-size logits then come out (N, C, H, W)-contiguous, the
        # layout K2 reads fastest (JAX: resize_bilinear_cl)
        x = self.classifier(x.float()).contiguous()
        if not self.training and self.dtype is not None and not self.fp32_eval_logits:
            x = x.to(self.dtype)
        # the JAX package's NHWC and class-leading resizes order the axes
        # by their own rules, which decide where bf16 rounds
        x = resize_bilinear(x, size, align_corners=False, cheaper_axis_first=class_leading)
        return x if class_leading else x.permute(0, 2, 3, 1)


class LowLevelConv(nn.Module):
    """ReLU → 1x1 conv to 48ch → BN skip projection (modeling/ADD.py:255-259)."""

    def __init__(self, in_features: int, features: int = 48, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_features, features, 1, dtype=dtype)
        self.bn = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(F.relu(x)))
