"""ASPP heads (ops/aspp.py of the JAX package): the 5-branch ``ASPPTrain``
of the decoded models (aspp_train.py:8-61 of the reference), the
3-branch ``ASPPSearch`` of the supernets' exits (operations.py:122-158)
and ``ASPPLite`` (aspp_train.py:64-85; no model of the port uses it).

The JAX package computes the large-dilation branches as one matmul plus
shifted adds (``_ShiftedDilatedConv3x3``) and the final 1x1 over a virtual
concat (``_BranchSum1x1``): TPU rewrites of a dilated 3x3 conv and of
concat → 1x1, with the same parameter names and shapes. Here they are the
plain convs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import band
from .norm import BatchNorm
from .primitives import Conv2d, ReLUConvBN
from .resize import resize_bilinear


class ASPPTrain(nn.Module):
    """Branches: 1x1; three 3x3 atrous convs at dilation {6,12,18}*mult;
    global average pool → 1x1 → upsample (align_corners=True). Concat → 1x1
    to ``out`` → BN. No trailing ReLU (the decoder applies it)."""

    def __init__(
        self, in_features: int, out: int = 256, depth: int = 256, mult: float = 1.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dils = {
            "aspp2": int(6 * mult), "aspp3": int(12 * mult), "aspp4": int(18 * mult),
        }
        self.aspp1_conv = Conv2d(in_features, depth, 1, dtype=dtype)
        self.aspp1_bn = BatchNorm(depth, dtype=dtype)
        for name, d in self.dils.items():
            self.add_module(
                f"{name}_conv",
                Conv2d(in_features, depth, 3, padding=d, dilation=d, dtype=dtype),
            )
            self.add_module(f"{name}_bn", BatchNorm(depth, dtype=dtype))
        self.aspp5_conv = Conv2d(in_features, depth, 1, dtype=dtype)
        self.aspp5_bn = BatchNorm(depth, dtype=dtype)
        self.conv1 = Conv2d(5 * depth, out, 1, dtype=dtype)
        self.bn1 = BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        branches = [F.relu(self.aspp1_bn(self.aspp1_conv(x)))]
        # The dilated branches read contiguous NCHW: on an H100 cuDNN's bf16
        # kernel for channels_last input takes 15-25 ms at dilation 12/18 on
        # the flagship's 65x129x400 map, against 0.6 ms for NCHW input; fp32
        # is no slower (scripts/torch_probe_dilated_conv.py).
        xd = x.contiguous()
        for name in self.dils:
            conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
            branches.append(F.relu(bn(conv(xd))))
        banded = band.is_band(x)  # a band pools every rank's rows and spreads the result over its own
        x5 = band.mean_hw(x) if banded else x.mean(dim=(2, 3), keepdim=True)
        x5 = F.relu(self.aspp5_bn(self.aspp5_conv(x5)))
        branches.append(band.broadcast_rows(x5, like=x) if banded else
                        resize_bilinear(x5, x.shape[2:], align_corners=True))
        return self.bn1(self.conv1(torch.cat(branches, dim=1)))


class ASPPSearch(nn.Module):
    """3-branch search-time ASPP head: 1x1, one 3x3 atrous conv, global
    pool (upsampled with align_corners=True); concat → 1x1 fuse → 1x1 to
    ``out`` classes (no BN). Every branch width is the input's."""

    def __init__(self, in_features: int, out: int, dilation: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = in_features
        self.conv11 = Conv2d(c, c, 1, dtype=dtype)
        self.bn11 = BatchNorm(c, dtype=dtype)
        self.conv33 = Conv2d(c, c, 3, padding=dilation, dilation=dilation, dtype=dtype)
        self.bn33 = BatchNorm(c, dtype=dtype)
        self.conv_p = Conv2d(c, c, 1, dtype=dtype)
        self.bn_p = BatchNorm(c, dtype=dtype)
        self.concate_conv = Conv2d(3 * c, c, 1, dtype=dtype)
        self.concate_bn = BatchNorm(c, dtype=dtype)
        self.final_conv = Conv2d(c, out, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        y1 = F.relu(self.bn11(self.conv11(x)))
        y2 = F.relu(self.bn33(self.conv33(x)))
        yp = F.relu(self.bn_p(self.conv_p(x.mean(dim=(2, 3), keepdim=True))))
        yp = resize_bilinear(yp, x.shape[2:], align_corners=True)
        y = F.relu(self.concate_bn(self.concate_conv(torch.cat([y1, y2, yp], dim=1))))
        return self.final_conv(y)


class ASPPLite(nn.Module):
    """ASPP_Lite (aspp_train.py:64-85), the lightweight attention-gated
    head: a 1x1 ReLUConvBN trunk gated by a sigmoid attention branch (49x49
    avg pool at stride (16, 20) → 1x1 conv → sigmoid → upsample), upsampled
    to ((h-1)*2+1, (w-1)*2+1) into a classifier 1x1, summed with a 1x1
    classifier of ``low_level`` (which must have that size)."""

    def __init__(self, in_features: int, low_level_features: int, mid_channels: int,
                 num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.tl = ReLUConvBN(in_features, mid_channels, 1, dtype=dtype)
        self.bl_conv = Conv2d(in_features, mid_channels, 1, use_bias=True, dtype=dtype)
        self.tr_conv = Conv2d(mid_channels, num_classes, 1, use_bias=True, dtype=dtype)
        self.br_conv = Conv2d(low_level_features, num_classes, 1, use_bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, low_level: torch.Tensor) -> torch.Tensor:
        t1 = self.tl(x)
        h, w = t1.shape[2:]
        # torch AvgPool2d(49, stride=[16, 20]): no padding
        t2 = torch.sigmoid(self.bl_conv(F.avg_pool2d(x, 49, (16, 20))))
        t3 = t1 * resize_bilinear(t2, (h, w), align_corners=False)
        t3 = resize_bilinear(t3, ((h - 1) * 2 + 1, (w - 1) * 2 + 1), align_corners=False)
        return self.tr_conv(t3) + self.br_conv(low_level)
