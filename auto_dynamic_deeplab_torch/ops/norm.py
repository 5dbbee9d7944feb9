"""Eval-mode batch normalization (ops/norm.py of the JAX package).

Parameters ``scale``/``bias`` and statistics ``mean``/``var`` keep the flax
names and stay fp32; the normalization runs in fp32 and the result is cast
to the policy dtype (or the input's dtype when there is no policy).
Training statistics belong to the trainer slice and are not ported here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(
        self,
        features: int,
        epsilon: float = 1e-5,
        affine: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.affine = affine
        self.dtype = dtype
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def folded(self):
        """(s, b) with BN(x) = x * s + b, both fp32 (C,)."""
        s = torch.rsqrt(self.var + self.epsilon)
        if not self.affine:
            return s, -self.mean * s
        s = self.scale * s
        return s, self.bias - self.mean * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one kernel; a bf16 input is normalized in fp32 with the fp32
        # statistics and rounded once, as (x - mean) * rsqrt(var + eps)
        # * scale + bias in fp32 followed by the cast
        y = F.batch_norm(
            x, self.mean, self.var,
            self.scale if self.affine else None, self.bias if self.affine else None,
            training=False, momentum=0.0, eps=self.epsilon,
        )
        return y.to(self.dtype or x.dtype)
