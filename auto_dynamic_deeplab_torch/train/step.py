"""The training steps (train/step.py of the JAX package): the stage-2 step
(the reference's loop body, train.py:216-247: SGD with Nesterov momentum
and PyTorch's weight decay, a per-iteration learning rate, the joint
multi-exit cross entropy) and the bilevel NAS search steps
(search.py:190-224).

``torch.optim.SGD(momentum, nesterov, weight_decay)`` is the JAX package's
``optax.add_decayed_weights`` + ``optax.sgd(nesterov)`` chain: the decay is
added to the raw gradient before the momentum buffer's update.
``torch.optim.Adam(weight_decay)`` is its architecture optimizer's chain
(``add_decayed_weights`` + ``scale_by_adam`` + ``scale(-lr)``): L2 in the
gradient before the moments, not AdamW's decoupled decay. The bf16 policy
keeps fp32 parameters (the convs cast them) and, as in JAX, uses no loss
scaler.

Data parallel (JAX: the ``shard_map`` steps with ``lax.pmean``): given a
``DataMesh``, each rank runs the step on its own rows of the global batch,
then the step's gradients and loss are averaged over the ranks in one flat
all-reduce before the optimizer's step, so that every rank applies the
same update. The model's BatchNorms reduce their statistics over the group
when ``ops.norm.set_bn_group`` gave them one (``--sync-bn``). No
``DistributedDataParallel``: the search's two steps differentiate two
parameter sets of one model, and DDP's reducer is fixed at construction.
"""
from __future__ import annotations

import warnings
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..bridge import is_jax_tree, load_checkpoint_weights, load_jax_optimizer_state
from ..parallel.mesh import DataMesh
from .loss import multi_exit_cross_entropy
from .schedules import Schedule


def average_over_mesh(params: List[torch.nn.Parameter], loss: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every ``params`` gradient (a zero where the loss did not reach it,
    as under jax.grad) and ``loss`` set to their means over the mesh, in
    one all-reduce of one flat fp32 buffer; returns the averaged loss."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().float().reshape(1)])
    torch.distributed.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
    at = 0
    for p, g in zip(params, grads):
        p.grad = flat[at:at + g.numel()].view_as(g).to(g.dtype)
        at += g.numel()
    return flat[at]


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    momentum: float = 0.9,
    nesterov: bool = True,
    weight_decay: float = 4e-5,
) -> torch.optim.SGD:
    """SGD over ``params``; its learning rate is set by ``TrainStep``."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)


def make_arch_optimizer(
    params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 1e-3
) -> torch.optim.Adam:
    """Adam over the architecture parameters (search.py:99-102)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


class TrainStep:
    """One step of ``model`` on a batch: forward in training mode, the
    multi-exit loss on (N, C, H, W) logits, backward, the optimizer's step
    at lr = ``schedule(step)``, and ``step`` + 1. With ``mesh`` the batch
    is this rank's rows, and the gradients and the loss are averaged over
    the mesh before the update (JAX ``make_train_step``); without, one
    device (JAX ``make_single_device_train_step``).

    ``step`` counts the optimizer updates from 0 (the JAX TrainState's
    ``step``); ``__call__`` returns the loss as a 0-d device tensor, so a
    loop of steps reads nothing back."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        schedule: Schedule,
        class_weight: Optional[np.ndarray] = None,
        mesh: Optional[DataMesh] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.mesh = mesh
        self.class_weight = None if class_weight is None else torch.as_tensor(
            class_weight, dtype=torch.float32, device=next(model.parameters()).device)
        self.step = 0

    def __call__(self, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """image (N, H, W, 3) float, label (N, H, W) int, on the model's device."""
        self.model.train()
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        outs = self.model(image, class_leading=True)
        loss = multi_exit_cross_entropy(outs, label, self.class_weight)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            loss = average_over_mesh([p for g in self.optimizer.param_groups for p in g["params"]], loss, self.mesh)
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict, weights_only: bool = False):
        """Restore the model's parameters and BN statistics and, unless
        ``weights_only`` (fine-tuning: the schedule restarts), the optimizer
        and the step, from the port's state or from the JAX package's
        train state (``params``, ``batch_stats``, ``opt_state``, ``step``,
        through the bridge)."""
        load_checkpoint_weights(self.model, state)
        if is_jax_tree(state):
            if not weights_only:
                load_jax_optimizer_state(self.optimizer, self.model, state["opt_state"])
                self.step = int(np.asarray(state["step"]))
        elif not weights_only:
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])


class SearchSteps:
    """The bilevel search steps of a supernet (the JAX package's
    ``make_search_steps``; with ``mesh``, its data-parallel form, each
    step's gradients and loss averaged over the mesh): ``weight_step`` on a
    batch of the first half updates the weights with ``w_optimizer`` at lr
    = ``schedule(step)``; ``arch_step`` on a batch of the second half
    updates ``alphas`` / ``betas`` with ``a_optimizer``. Both run the
    supernet in training mode (its BN running statistics blend in either
    step) and take the multi-exit loss, ``loss_reduce`` 'mean'
    (search.py:190-194) or 'sum' (search_layer.py:187-196).

    Each step differentiates its own parameters only: the others have
    ``requires_grad`` off for its forward and backward, so no gradient is
    computed for them and their optimizer never sees one; a parameter of
    the step that the loss does not reach gets a zero gradient, as under
    jax.grad, so that the decay still reaches it. ``step`` counts the
    weight updates from 0. Each step returns its loss as a 0-d device
    tensor, so a loop of steps reads nothing back."""

    def __init__(
        self,
        model: torch.nn.Module,
        w_optimizer: torch.optim.Optimizer,
        a_optimizer: torch.optim.Optimizer,
        schedule: Schedule,
        class_weight: Optional[np.ndarray] = None,
        loss_reduce: str = "mean",
        mesh: Optional[DataMesh] = None,
    ):
        self.model = model
        self.mesh = mesh
        self.w_optimizer, self.a_optimizer = w_optimizer, a_optimizer
        self.schedule = schedule
        self.loss_reduce = loss_reduce
        self.class_weight = None if class_weight is None else torch.as_tensor(
            class_weight, dtype=torch.float32, device=next(model.parameters()).device)
        self.w_params: List[torch.nn.Parameter] = list(model.weight_parameters())
        self.a_params: List[torch.nn.Parameter] = list(model.arch_parameters())
        self.step = 0

    def _update(self, image, label, params, frozen, optimizer) -> torch.Tensor:
        self.model.train()
        for p in frozen:
            p.requires_grad_(False)
        try:
            outs = self.model(image, class_leading=True)
            loss = multi_exit_cross_entropy(outs, label, self.class_weight, reduce=self.loss_reduce)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        finally:
            for p in frozen:
                p.requires_grad_(True)
        if self.mesh is not None:
            loss = average_over_mesh(params, loss, self.mesh)
        for p in params:  # jax.grad gives a parameter the loss does not reach a zero
            if p.grad is None:  # gradient, so the decay still reaches it
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    def weight_step(self, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """image (N, H, W, 3) float, label (N, H, W) int, on the model's device."""
        lr = self.schedule(self.step)
        for group in self.w_optimizer.param_groups:
            group["lr"] = lr
        loss = self._update(image, label, self.w_params, self.a_params, self.w_optimizer)
        self.step += 1
        return loss

    def arch_step(self, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self._update(image, label, self.a_params, self.w_params, self.a_optimizer)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "w_opt": self.w_optimizer.state_dict(),
                "a_opt": self.a_optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict):
        """Restore the weights, BN statistics and arch, both optimizers'
        states and the step, from the port's state or from the JAX
        package's search state (``params``, ``batch_stats``, ``arch``,
        ``w_opt``, ``a_opt``, through the bridge; the step is ``w_opt``'s
        schedule count). A JAX state saved without the optimizers leaves
        them fresh and the step at 0, with a warning, as the JAX package's
        search trainer does."""
        load_checkpoint_weights(self.model, state)
        if is_jax_tree(state):
            if "w_opt" not in state or "a_opt" not in state:
                warnings.warn("the search checkpoint holds no optimizer states: momentum and the Adam moments "
                              "start fresh and the schedule restarts", stacklevel=2)
                return
            count = load_jax_optimizer_state(self.w_optimizer, self.model, state["w_opt"])
            if count is None:
                raise ValueError("w_opt: no schedule count (the search's weight optimizer runs a schedule)")
            load_jax_optimizer_state(self.a_optimizer, self.model, state["a_opt"])
            self.step = count
            return
        self.w_optimizer.load_state_dict(state["w_opt"])
        self.a_optimizer.load_state_dict(state["a_opt"])
        self.step = int(state["step"])


def make_eval_step(model):
    """The all-exits eval program (JAX ``make_eval_step``): NHWC images ->
    the per-exit argmax predictions (N, H, W), with the model's own
    weights, in eval mode."""

    @torch.inference_mode()
    def eval_step(image: torch.Tensor) -> List[torch.Tensor]:
        model.eval()
        return [o.argmax(dim=-1) for o in model(image)]

    return eval_step
