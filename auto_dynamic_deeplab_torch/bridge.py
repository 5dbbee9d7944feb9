"""Carry the JAX package's flax variables into a port module.

``variables`` is the flax ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays (or anything ``np.asarray`` accepts). The port
names every parameter and buffer after its flax path, so
``params/cell_3/ops_0/dw1/kernel`` lands on ``cell_3.ops_0.dw1.kernel``.
Layout rules (tests/torch_bridge.py:10-37):

  * conv kernel (kh, kw, in/groups, out) → (out, in/groups, kh, kw), which
    also maps a depthwise (k, k, 1, C) kernel to (C, 1, k, k);
  * Dense kernel (in, out) → (out, in);
  * BN scale/bias (params) and mean/var (batch_stats), conv and Dense
    biases: copied as they are.

Every flax leaf must land on a port tensor of the same shape and every port
parameter and buffer must be filled; otherwise ``load_jax_variables``
raises and changes nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def _to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name.rsplit(".", 1)[-1] == "kernel":
        if arr.ndim == 4:
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return arr.T
    return arr


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy flax params and batch stats into ``module`` (see module doc)."""
    flat: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        _flatten(variables.get(collection, {}), "", flat)
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unsupported variable collections: {sorted(extra)}")

    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unused = sorted(set(flat) - set(targets))
    missing = sorted(set(targets) - set(flat))
    if unused or missing:
        raise KeyError(f"flax keys without a port tensor: {unused}; port tensors without a flax key: {missing}")

    converted = {}
    for name, arr in flat.items():
        arr = _to_torch_layout(name, arr)
        if tuple(arr.shape) != tuple(targets[name].shape):
            raise ValueError(
                f"{name}: flax shape {arr.shape} does not fit port shape {tuple(targets[name].shape)}"
            )
        converted[name] = arr
    with torch.no_grad():
        for name, arr in converted.items():
            t = targets[name]
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))
    return module
