"""Carry the JAX package's flax variables into a port module.

``variables`` is the flax ``{"params": ..., "batch_stats": ...}`` tree, and
for a supernet its ``arch`` collection (``alphas``, ``betas``), as nested
dicts of numpy arrays (or anything ``np.asarray`` accepts). The port names
every parameter and buffer after its flax path, so
``params/cell_3/ops_0/dw1/kernel`` lands on ``cell_3.ops_0.dw1.kernel``,
``arch/betas`` on ``betas``; the port's modules carry flax's names for the
lists a flax module builds in ``setup`` (``l{i}_c{j}``,
``dense_preprocess_{i}_{j}``, ``aspp_{lv}``, ``aspp_exit_{s}_{lv}``,
``mixed_{e}``, ``pool_bn_{i}``).

A mixed supernet cell of the JAX package's ``banked`` or ``scan`` layout
(``mixed_exec``) carries its edges' variables stacked on leading lane
axes: ``bank_{i}/...`` (2+i lanes, block i) and ``blocks/bank/...`` (B
blocks x B+2 lanes, lanes past a block's 2+i edges zero-weight padding).
Those are unstacked onto the per-edge ``mixed_{e}`` modules, e = the
block's first edge + lane, and the padding lanes are dropped.

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

import re
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


def _edge_offset(block: int) -> int:
    return sum(2 + i for i in range(block))


def _per_edge(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Unstack the banked and scan layouts' lanes onto per-edge keys."""
    out: Dict[str, np.ndarray] = {}

    def put(key, arr):
        if key in out:
            raise KeyError(f"two flax leaves land on {key}")
        out[key] = arr

    for key, arr in flat.items():
        parts = key.split(".")
        scan = [k for k in range(len(parts) - 1) if parts[k] == "blocks" and parts[k + 1] == "bank"]
        bank = [k for k, p in enumerate(parts) if re.fullmatch(r"bank_\d+", p)]
        if scan:
            k = scan[0]
            blocks, lanes = arr.shape[:2]
            if lanes != blocks + 2:
                raise ValueError(f"{key}: scan lanes {lanes} != blocks {blocks} + 2")
            for b in range(blocks):
                for j in range(2 + b):  # lanes >= 2 + b: zero-weight padding
                    put(".".join(parts[:k] + [f"mixed_{_edge_offset(b) + j}"] + parts[k + 2:]), arr[b, j])
        elif bank:
            k = bank[0]
            b = int(parts[k].split("_")[1])
            if arr.shape[0] != 2 + b:
                raise ValueError(f"{key}: {arr.shape[0]} lanes, block {b} has {2 + b} edges")
            for j in range(2 + b):
                put(".".join(parts[:k] + [f"mixed_{_edge_offset(b) + j}"] + parts[k + 1:]), arr[j])
        else:
            put(key, arr)
    return out


def _to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name.rsplit(".", 1)[-1] == "kernel":
        if arr.ndim == 4:
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return arr.T
    return arr


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy flax params, batch stats and arch into ``module`` (see module doc)."""
    flat: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats", "arch"):
        _flatten(variables.get(collection, {}), "", flat)
    extra = set(variables) - {"params", "batch_stats", "arch"}
    if extra:
        raise KeyError(f"unsupported variable collections: {sorted(extra)}")
    flat = _per_edge(flat)

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
