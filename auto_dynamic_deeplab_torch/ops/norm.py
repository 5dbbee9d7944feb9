"""Batch normalization (ops/norm.py of the JAX package).

Parameters ``scale``/``bias`` and statistics ``mean``/``var`` keep the flax
names and stay fp32; the normalization runs in fp32 and the result is cast
to the policy dtype (or the input's dtype when there is no policy).

``nn.Module.training`` picks the mode. Eval normalizes with the running
statistics. Training normalizes with the batch statistics over (N, H, W),
taken in fp32 whatever the input dtype, with the biased variance, and
blends them into the running statistics as PyTorch and the JAX package do:
``running = (1 - m) * running + m * batch``, m = 0.1, with the unbiased
variance (factor n / max(n - 1, 1), n = N*H*W).

Cross-replica statistics (``--sync-bn``, the data-parallel search; JAX
``axis_name=DATA_AXIS``): ``set_bn_group(model, group)`` gives every
BatchNorm of a model a process group. In training mode each rank then
takes the fp32 mean and mean of squares of its own rows, averages both
over the group, normalizes with JAX's one-pass variance max(E[x²] −
E[x]², 0) of those averages and blends the running statistics with the
unbiased factor over the global count n = N*H*W·world; its backward
all-reduces the two per-channel sums of the input gradient
(``_CrossReplicaBatchNorm``). ``torch.nn.SyncBatchNorm`` is not used: it
refuses CPU tensors, on which the multi-process tests run.

Channel tensor parallelism (``parallel.tensor.shard_train_state``) gives
a BatchNorm a ``shard``: the module then holds one block of its channels'
parameters and statistics, gathers them whole where it normalizes (the
parameters' gradients flow back to the block) and keeps its block of the
blended statistics.
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
        self.group = None  # set_bn_group: statistics over this process group
        self.shard = None  # parallel.tensor: this module holds a block of its channels
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

    def _store(self, mean: torch.Tensor, var: torch.Tensor):
        """The running statistics take ``mean`` and ``var`` (all channels)
        in place, which bumps their versions: the kernels' folded-weight
        caches (kernels/stems.py, kernels/cell_ops.py) key on them."""
        if self.shard is not None:
            mean, var = self.shard.local(mean), self.shard.local(var)
        self.mean.copy_(mean)
        self.var.copy_(var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one kernel; a bf16 input is normalized in fp32 with fp32
        # statistics and rounded once, as (x - mean) * rsqrt(var + eps)
        # * scale + bias in fp32 followed by the cast
        scale, bias = (self.scale, self.bias) if self.affine else (None, None)
        mean, var = self.mean, self.var
        if self.shard is not None:
            scale, bias, mean, var = self.shard.gather_bn(scale, bias, mean, var)
        if not self.training:
            y = F.batch_norm(x, mean, var, scale, bias,
                             training=False, momentum=0.0, eps=self.epsilon)
            return y.to(self.dtype or x.dtype)
        if self.group is not None:
            return self._cross_replica(x, scale, bias, mean, var)
        # The kernel blends the batch statistics into copies of the running
        # ones (its backward keeps the tensors it was given), then the
        # buffers take them (``_store``). At n = 1 PyTorch's unbiased
        # variance divides by 0, so there the statistics are blended here.
        multi = x.numel() > x.shape[1]
        run_mean, run_var = (mean.clone(), var.clone()) if multi else (None, None)
        y = torch.batch_norm(x, scale, bias, run_mean, run_var, True, self.momentum, self.epsilon,
                             torch.backends.cudnn.enabled)
        if not _frozen_stats:
            with torch.no_grad():
                if multi:
                    self._store(run_mean, run_var)
                else:  # batch mean x, variance 0
                    self._store(mean.lerp(x.reshape(-1).float(), self.momentum), var * (1.0 - self.momentum))
        return y.to(self.dtype or x.dtype)

    def _cross_replica(self, x, scale, bias, mean, var) -> torch.Tensor:
        """Training mode over the group (JAX ops/norm.py:58-75); ``mean``
        and ``var`` are the running statistics of every channel."""
        if not self.affine:  # the backward reads the per-channel sums off the affine gradients
            scale, bias = torch.ones_like(mean), torch.zeros_like(mean)
        y = _CrossReplicaBatchNorm.apply(x, scale, bias, self, (mean, var))
        return y.to(self.dtype or x.dtype)


class _CrossReplicaBatchNorm(torch.autograd.Function):
    """BN over the rows of every rank of ``bn.group``, in few launches: each
    rank's fp32 mean and E[x²] (one reduction), one all-reduce of both, the
    one-pass variance, and the normalization as one eval-mode
    ``batch_norm`` with the global statistics. The backward takes the
    per-channel sums Σdy and Σdy·x̂ from one eval-mode
    ``native_batch_norm_backward`` (its affine gradients), all-reduces
    them, and adds the global terms as one more eval-mode ``batch_norm``:
    dx = k·dy − k·Σdy/n − x̂·k·Σ(dy·x̂)/n, k = scale·invstd, x̂ = (x −
    mean)·invstd, n the global count. The scale and bias gradients stay
    each rank's own (the step averages them)."""

    @staticmethod
    def forward(ctx, x, scale, bias, bn, running):
        if x.is_cuda:  # Welford mean and 1/sqrt(var + eps) in fp32, one kernel
            mean, invstd = torch.batch_norm_stats(x, bn.epsilon)
            var = invstd.pow(-2).sub_(bn.epsilon)
        else:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        moments = torch.stack([mean, torch.addcmul(var, mean, mean)])
        torch.distributed.all_reduce(moments, group=bn.group)
        mean, mean_sq = moments.div_(torch.distributed.get_world_size(bn.group))
        var = torch.addcmul(mean_sq, mean, mean, value=-1.0).clamp_(min=0.0)
        n = x.numel() // x.shape[1] * torch.distributed.get_world_size(bn.group)
        if not _frozen_stats:
            bn._store(running[0].lerp(mean, bn.momentum),
                      running[1].lerp(var * (n / max(n - 1.0, 1.0)), bn.momentum))
        ctx.save_for_backward(x, scale, mean, var)
        ctx.bn, ctx.n = bn, n
        return torch.batch_norm(x, scale, bias, mean, var, False, 0.0, bn.epsilon, torch.backends.cudnn.enabled)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, var = ctx.saved_tensors
        bn, n = ctx.bn, ctx.n
        invstd = torch.rsqrt(var + bn.epsilon)
        # eval mode: the global statistics are the running ones (the CUDA
        # kernel wants the saved ones defined too: the same)
        dx, d_scale, d_bias = torch.ops.aten.native_batch_norm_backward(
            dy, x, scale, mean, var, mean, invstd, False, bn.epsilon, [True, True, True])
        sums = torch.stack([d_bias, d_scale])  # Σdy, Σdy·x̂ of this rank
        torch.distributed.all_reduce(sums, group=bn.group)
        coef = sums.mul_(scale * invstd * (-1.0 / n))  # (−k·Σdy/n, −k·Σdy·x̂/n)
        # (x − mean)·invstd·w + b with w = −k·Σdy·x̂/n, b = −k·Σdy/n
        dx.add_(torch.batch_norm(x, coef[1], coef[0], mean, var, False, 0.0, bn.epsilon,
                                 torch.backends.cudnn.enabled))
        return dx, d_scale, d_bias, None, None


def set_bn_group(model: nn.Module, group) -> nn.Module:
    """Every BatchNorm of ``model`` takes its training statistics over
    ``group`` (None: its own batch again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model
