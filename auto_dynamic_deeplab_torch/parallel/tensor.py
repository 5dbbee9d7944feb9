"""Channel tensor parallelism (parallel/tensor.py of the JAX package).

The JAX package annotates every conv kernel and channel vector whose
trailing dim the 'model' mesh axis divides, jits the global program and
lets GSPMD insert the collectives, so its dp×tp step is numerically the
single-device step on the global batch. PyTorch's DTensor convolution
does not cover this model's convs (it wants stride 1 wherever a conv
pads), so here each sharded op takes its sharding by hand, Megatron's
way, over a ``make_mesh(n_data, n_model)`` mesh:

  * a conv whose weight is sharded computes only its own block of output
    channels, from the whole input (a grouped conv: from its groups'
    input channels), between an identity whose backward all-reduces the
    input gradient over the model group and an all-gather of the blocks
    whose backward keeps this rank's block of the gradient. Activations
    stay whole on every rank of the model group, so a channel concat is
    the global one;
  * a BatchNorm whose channels are sharded gathers its parameters and
    statistics where it normalizes (the gradients flow back to the
    block) and keeps its block of the blended statistics; its batch
    statistics run over the data group (the cross-replica BN,
    ``ops/norm.py``);
  * the loss is the global batch's: each exit's summed weighted NLL and
    summed weights over the data group (``train/loss.py::
    cross_entropy_terms``), not the mean of the ranks' losses; each
    rank's gradient is its shard's, summed over the data group.

``channel_spec`` is the JAX package's rule in the port's layouts: the
flax trailing dim is dim 0 of a conv weight (out, in/groups, kh, kw),
of a Linear weight (out, in) and of a channel vector.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norm import BatchNorm, set_bn_group
from ..ops.primitives import Conv2d
from ..train.loss import cross_entropy_terms
from ..train.schedules import Schedule
from .mesh import Mesh
from .spatial import all_gather_cat, all_reduce_sum


def channel_spec(t, n_model: int) -> Optional[int]:
    """The dim of ``t`` sharded over the model axis: 0 (flax's trailing
    dim in the port's layout) when it is at least ``n_model`` and
    ``n_model`` divides it; None for scalars and ragged tensors (the
    19-class classifier)."""
    shape = tuple(getattr(t, "shape", ()))
    if len(shape) >= 1 and shape[0] >= n_model and shape[0] % n_model == 0:
        return 0
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_sum(dy, ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """Every rank's block concatenated along ``dim``; the gradient's own
    block back (each rank of the model group holds the same whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, m):
        ctx.dim, ctx.m, ctx.size = dim, m, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        # a dense copy in dy's memory format (channels_last stays so)
        return dy.narrow(ctx.dim, ctx.m * ctx.size, ctx.size).clone(), None, None, None


class ModelShard:
    """A module's block of its channels on the model axis of ``mesh``."""

    def __init__(self, mesh: Mesh, names: List[str]):
        self.group, self.n, self.m = mesh.model_group, mesh.n_model, mesh.m
        self.names = tuple(names)  # the module's sharded tensors

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``'s dim 0."""
        per = t.shape[0] // self.n
        return t[self.m * per:(self.m + 1) * per]

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """Every block of ``t``'s dim 0 (no gradient)."""
        return all_gather_cat(t.detach(), 0, self.group)

    def conv2d(self, conv: Conv2d, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        """This block's output channels of ``conv`` on the whole ``x``,
        gathered."""
        x = _CopyToModel.apply(x, self.group)
        groups = conv.groups
        if groups > 1:  # a block of output channels reads its groups' input channels only
            per = x.shape[1] // self.n
            x, groups = x[:, self.m * per:(self.m + 1) * per], groups // self.n
        y = F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, groups)
        return _GatherChannels.apply(y, 1, self.group, self.m)

    def gather_bn(self, scale, bias, mean, var):
        """A BatchNorm's parameters (gradients to the blocks) and running
        statistics (detached), every channel, in one all-gather."""
        parts = [mean, var] + ([scale, bias] if scale is not None else [])
        whole = _GatherChannels.apply(torch.stack(parts), 1, self.group, self.m)
        mean, var = whole[0].detach().clone(), whole[1].detach().clone()
        if scale is None:
            return None, None, mean, var
        return whole[2], whole[3], mean, var


def _sharded(model: torch.nn.Module, n_model: int):
    """(module, shardable tensor names) of every module with a tensor
    ``channel_spec`` shards; raises for a module without a TP rule."""
    out = []
    for name, mod in model.named_modules():
        tensors = dict(mod.named_parameters(recurse=False), **dict(mod.named_buffers(recurse=False)))
        names = [k for k, t in tensors.items() if channel_spec(t, n_model) == 0]
        if not names:
            continue
        if isinstance(mod, Conv2d) and "kernel" in names:
            if mod.groups > 1 and mod.groups % n_model:
                raise ValueError(f"{name}: {mod.groups} groups do not split over {n_model} ranks")
        elif not isinstance(mod, BatchNorm):
            raise ValueError(f"{name or 'the model'} ({type(mod).__name__}): no tensor-parallel rule for "
                             f"{names}")
        out.append((name, mod, names))
    return out


def shard_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh) -> torch.nn.Module:
    """Each tensor ``channel_spec`` shards, in place: every conv's and
    BatchNorm's parameters and statistics become this rank's contiguous
    block of dim 0 over the model group, the SGD momentum beside them; the
    modules then compute as ``ModelShard`` says. ``gather_train_state``
    is the way back."""
    state = optimizer.state
    with torch.no_grad():
        for _, mod, names in _sharded(model, mesh.n_model):
            shard = ModelShard(mesh, names)
            for k in names:
                t = getattr(mod, k)
                t.data = shard.local(t.data).clone()
                buf = state.get(t, {}).get("momentum_buffer") if isinstance(t, torch.nn.Parameter) else None
                if buf is not None:
                    state[t]["momentum_buffer"] = shard.local(buf).clone()
            mod.shard = shard
    model.tp_mesh = mesh
    return model


def gather_train_state(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """The whole state of a sharded model, on every rank (a collective
    over the model group): {"model": a state dict of every parameter and
    statistic, whole; "momentum": {parameter name: whole SGD momentum}}.
    The model stays sharded."""
    params = dict(model.named_parameters())
    model_sd, momentum = {}, {}
    for name, t in model.state_dict(keep_vars=True).items():
        owner, _, leaf = name.rpartition(".")
        shard = getattr(model.get_submodule(owner), "shard", None)
        sharded = shard is not None and leaf in shard.names
        model_sd[name] = shard.whole(t) if sharded else t.detach().clone()
        if optimizer is not None and name in params:
            buf = optimizer.state.get(params[name], {}).get("momentum_buffer")
            if buf is not None:
                momentum[name] = shard.whole(buf) if sharded else buf.clone()
    return {"model": model_sd, "momentum": momentum}


class TPTrainStep:
    """One dp×tp step (the JAX package's ``make_tp_train_step``) of a model
    that ``shard_train_state`` sharded over ``mesh``: this rank's data
    rows of the global batch through the model in training mode, the
    global batch's multi-exit loss, backward, every gradient summed over
    the data group, and the optimizer's step at lr = ``schedule(step)``.
    Returns the global loss as a 0-d tensor."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, schedule: Schedule, mesh: Mesh,
                 class_weight: Optional[np.ndarray] = None):
        if getattr(model, "tp_mesh", None) is not mesh:
            raise ValueError("make_tp_train_step takes a model sharded over this mesh by shard_train_state")
        self.model, self.optimizer, self.schedule, self.mesh = model, optimizer, schedule, mesh
        self.class_weight = None if class_weight is None else torch.as_tensor(
            class_weight, dtype=torch.float32, device=next(model.parameters()).device)
        set_bn_group(model, mesh.data_group if mesh.n_data > 1 else None)
        self.step = 0

    def __call__(self, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """image (N, H, W, 3), label (N, H, W): the global batch, on the
        model's device; the data axis must divide N."""
        rows = self.mesh.rows(image.shape[0])
        image, label = image[rows], label[rows]
        self.model.train()
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        outs = self.model(image, class_leading=True)
        terms = [cross_entropy_terms(o, label, self.class_weight) for o in outs]
        dens = torch.stack([den for _, den in terms]).detach()
        if self.mesh.n_data > 1:
            dens = all_reduce_sum(dens, self.mesh.data_group)
        loss = sum(num / den.clamp_min(1e-12) for (num, _), den in zip(terms, dens)) / len(outs)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().float().reshape(1)])
        if self.mesh.n_data > 1:
            flat = all_reduce_sum(flat, self.mesh.data_group)
        at = 0
        for p, g in zip(params, grads):
            p.grad = flat[at:at + g.numel()].view_as(g).to(g.dtype)
            at += g.numel()
        self.optimizer.step()
        self.step += 1
        return flat[at]

    def state_dict(self) -> dict:
        """The whole state (``gather_train_state``) and the step."""
        return {**gather_train_state(self.model, self.optimizer), "step": self.step}


def make_tp_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, schedule: Schedule, mesh: Mesh,
                       class_weight: Optional[np.ndarray] = None) -> TPTrainStep:
    """The dp×tp train step of a model ``shard_train_state`` sharded over
    ``mesh`` (``TPTrainStep``)."""
    return TPTrainStep(model, optimizer, schedule, mesh, class_weight)

