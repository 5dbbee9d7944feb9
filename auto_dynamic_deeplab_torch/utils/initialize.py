"""Seeded parameter initialization (no weights are ever downloaded).

The draws come from an explicit ``torch.Generator``; the distributions are
the reference's: kaiming-normal (fan_in, gain sqrt 2, untruncated) convs
(modeling/ADD.py:491-500), dense layers by flax's default ``lecun_normal``
(a normal truncated at ±2σ, σ widened by 1/0.87962566 so that the
variance stays 1/fan_in), zero biases, and BN at scale 1, bias 0, mean 0, var 1; a supernet's
architecture parameters (alphas, betas) 1e-3 * normal (model_search.py).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.norm import BatchNorm
from ..ops.primitives import Conv2d, Dense

# the standard deviation of a unit normal truncated at ±2 (flax's
# variance_scaling divides by it so that the draw keeps the asked variance)
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in module.modules():
        if isinstance(m, (Conv2d, Dense)):
            fan_in = m.kernel[0].numel()
            if isinstance(m, Conv2d):
                m.kernel.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            else:
                std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
                nn.init.trunc_normal_(m.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.mean.zero_()
            m.var.fill_(1.0)
            if m.affine:
                m.scale.fill_(1.0)
                m.bias.zero_()
    for p in getattr(module, "arch_parameters", list)():
        p.normal_(0.0, 1e-3, generator=generator)
    return module


@torch.no_grad()
def randomize_bn(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Non-trivial BN statistics and affine terms, so that BN folding and
    the eval normalization are really exercised."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mean.normal_(0.0, 0.5, generator=generator)
            m.var.uniform_(0.5, 2.0, generator=generator)
            if m.affine:
                m.scale.uniform_(0.5, 1.5, generator=generator)
                m.bias.normal_(0.0, 0.3, generator=generator)
    return module
