"""FLOPs, bytes and parameter accounting (utils/flops.py of the JAX
package, which reads them from XLA's cost analysis of the compiled
program; the reference reports ptflops MACs, eval.py:233-238).

Here the operations are counted as PyTorch dispatches them:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, 2 per
    multiply-add of the convolutions and matrix products only. XLA also
    counts elementwise work (BN, ReLU, adds, resizes, softmax), so its
    figure for the same model is somewhat larger;
  * ``bytes accessed``: the sum, over every aten op that is not a view,
    of the bytes of its tensor inputs and outputs. XLA counts what its
    fused kernels read and write, so a chain of elementwise ops counts
    once there and once an op here.

A function that launches the hand-written kernels (K1-K6 go through
ctypes and Triton, not the dispatcher) is counted only as far as its
PyTorch ops; ``model_complexity`` therefore counts the plain path on a
CPU copy of the model with fake tensors (no memory, no compute), which
runs the kernels' plain versions at any size.
"""
from __future__ import annotations

import copy
from typing import Callable, Iterable, Tuple, Union

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def count_params(params: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """Elements of a module's parameters (BN statistics are buffers, as
    they are the ``batch_stats`` collection in the JAX package), or of an
    iterable of tensors."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params
    return sum(int(t.numel()) for t in tensors)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


class _BytesAccessed(TorchDispatchMode):
    """Sums each non-view aten op's tensor input and output bytes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def cost_analysis(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` once and return {"flops", "bytes accessed"} of the
    PyTorch ops it dispatched: the counterpart of the JAX package's
    ``xla_cost(fn, *args)``."""
    with FlopCounterMode(display=False) as flops, _BytesAccessed() as nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(nbytes.total)}


def model_complexity(model: nn.Module, input_shape: Tuple[int, ...]) -> dict:
    """{"flops", "params", "bytes_accessed"} of one eval forward (every exit)
    of ``model`` on NHWC images of ``input_shape``; the reference reports
    its MACs at (1, 1025, 2049, 3). The model itself is left as it is."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    probe = copy.deepcopy(model).cpu().eval()
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True) as fake:
        x = fake.from_tensor(torch.zeros(tuple(input_shape)))
        cost = cost_analysis(probe, x)
    return {
        "flops": cost["flops"],
        "params": count_params(model),
        "bytes_accessed": cost["bytes accessed"],
    }
