"""Batch normalization (ops/norm.py of the JAX package).

Parameters ``scale``/``bias`` and statistics ``mean``/``var`` keep the flax
names and stay fp32; the normalization runs in fp32 and the result is cast
to the policy dtype (or the input's dtype when there is no policy).

``nn.Module.training`` picks the mode. Eval normalizes with the running
statistics. Training normalizes with the batch statistics over (N, H, W),
taken in fp32 whatever the input dtype, with the biased variance, and
blends them into the running statistics as PyTorch and the JAX package do:
``running = (1 - m) * running + m * batch``, m = 0.1, with the unbiased
variance (factor n / max(n - 1, 1), n = N*H*W). Cross-replica statistics
(``--sync-bn``) are not ported yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# > 0 while a checkpointed (remat) segment recomputes its forward in
# backward: the recomputation normalizes with the same batch statistics but
# must not blend them into the running statistics a second time (flax's
# nn.remat keeps the forward's mutations only). A plain counter, not a
# thread-local: the recomputation runs in autograd's device threads.
_frozen_stats = 0


@contextlib.contextmanager
def frozen_running_stats():
    """Training-mode BN inside leaves its running statistics unchanged."""
    global _frozen_stats
    _frozen_stats += 1
    try:
        yield
    finally:
        _frozen_stats -= 1


class BatchNorm(nn.Module):
    def __init__(
        self,
        features: int,
        momentum: float = 0.1,
        epsilon: float = 1e-5,
        affine: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.momentum = momentum
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
        # one kernel; a bf16 input is normalized in fp32 with fp32
        # statistics and rounded once, as (x - mean) * rsqrt(var + eps)
        # * scale + bias in fp32 followed by the cast
        scale, bias = (self.scale, self.bias) if self.affine else (None, None)
        if not self.training:
            y = F.batch_norm(x, self.mean, self.var, scale, bias,
                             training=False, momentum=0.0, eps=self.epsilon)
            return y.to(self.dtype or x.dtype)
        # The kernel blends the batch statistics into copies of the running
        # ones (its backward keeps the tensors it was given), then the
        # buffers take them in place, which bumps their versions: the
        # kernels' folded-weight caches (kernels/stems.py,
        # kernels/cell_ops.py) key on them. At n = 1 PyTorch's unbiased
        # variance divides by 0, so there the statistics are blended here.
        multi = x.numel() > x.shape[1]
        mean, var = (self.mean.clone(), self.var.clone()) if multi else (None, None)
        y = torch.batch_norm(x, scale, bias, mean, var, True, self.momentum, self.epsilon,
                             torch.backends.cudnn.enabled)
        if not _frozen_stats:
            with torch.no_grad():
                if multi:
                    self.mean.copy_(mean)
                    self.var.copy_(var)
                else:  # batch mean x, variance 0
                    self.mean.lerp_(x.reshape(-1).float(), self.momentum)
                    self.var.mul_(1.0 - self.momentum)
        return y.to(self.dtype or x.dtype)
