"""The training step (train/step.py of the JAX package; the reference's
loop body, train.py:216-247): SGD with Nesterov momentum and PyTorch's
weight decay, a per-iteration learning rate, and the joint multi-exit
cross entropy.

``torch.optim.SGD(momentum, nesterov, weight_decay)`` is the JAX package's
``optax.add_decayed_weights`` + ``optax.sgd(nesterov)`` chain: the decay is
added to the raw gradient before the momentum buffer's update. The bf16
policy keeps fp32 parameters (the convs cast them) and, as in JAX, uses no
loss scaler. One device: the data-parallel step waits for ROADMAP Queue 1
item 12, the architecture optimizer for NAS search (item 11).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from .loss import multi_exit_cross_entropy
from .schedules import Schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    momentum: float = 0.9,
    nesterov: bool = True,
    weight_decay: float = 4e-5,
) -> torch.optim.SGD:
    """SGD over ``params``; its learning rate is set by ``TrainStep``."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)


class TrainStep:
    """One single-device step of ``model`` on a batch: forward in training
    mode, the multi-exit loss on (N, C, H, W) logits, backward, the
    optimizer's step at lr = ``schedule(step)``, and ``step`` + 1.

    ``step`` counts the optimizer updates from 0 (the JAX TrainState's
    ``step``); ``__call__`` returns the loss as a 0-d device tensor, so a
    loop of steps reads nothing back."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        schedule: Schedule,
        class_weight: Optional[np.ndarray] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
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
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict, weights_only: bool = False):
        """Restore the model's parameters and BN statistics and, unless
        ``weights_only`` (fine-tuning: the schedule restarts), the optimizer
        and the step."""
        self.model.load_state_dict(state["model"])
        if not weights_only:
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])
