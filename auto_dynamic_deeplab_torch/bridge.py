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

Optimizer states (``load_jax_optimizer_state``): an optax chain's state,
as ``utils/orbax_reader.py`` reads it (a tuple as a dict of int keys, a
state's fields as str keys, an ``EmptyState`` as ``None``), goes onto a
``torch.optim`` optimizer of the port's parameters, leaf by leaf under the
names and layout rules above:

  * ``TraceState.trace`` (``optax.sgd`` with momentum: the stage-2
    ``add_decayed_weights`` + ``sgd(momentum, nesterov)`` chain and the
    search's weight optimizer) → ``torch.optim.SGD``'s ``momentum_buffer``;
  * ``ScaleByAdamState`` (the search's architecture optimizer,
    ``add_decayed_weights`` + ``scale_by_adam`` + ``scale(-lr)``): ``mu`` →
    ``exp_avg``, ``nu`` → ``exp_avg_sq``, ``count`` → ``step``;
  * ``ScaleByScheduleState.count`` (the learning-rate schedule's position,
    the updates taken) is returned, for ``TrainStep.step`` /
    ``SearchSteps.step``; the Adam state's count is returned likewise.

Where each state sits in the chain depends on the chain's members (a
weight decay of 0 drops ``add_decayed_weights`` from the stage-2 chain), so
the states are found by their fields, not by their index. Any other state,
or a trace for another optimizer, raises and names it.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

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


# the optax states the JAX package's optimizers hold, by their fields
_OPTAX_STATES = {frozenset({"trace"}): "trace", frozenset({"count"}): "count",
                 frozenset({"count", "mu", "nu"}): "adam"}


def _optax_states(tree, path: str = "opt_state") -> List[Tuple[str, str, Any]]:
    """(kind, path, node) of every optax state in a chain's state tree."""
    if tree is None:
        return []  # EmptyState
    if not isinstance(tree, dict) or not tree:
        raise ValueError(f"{path}: not an optax state ({type(tree).__name__})")
    kind = _OPTAX_STATES.get(frozenset(tree))
    if kind is not None:
        return [(kind, path, tree)]
    if all(isinstance(k, int) for k in tree):  # a chain: a tuple of states
        return [s for k in sorted(tree) for s in _optax_states(tree[k], f"{path}.{k}")]
    raise ValueError(f"{path}: unsupported optax state with fields {sorted(map(str, tree))}")


def _per_param(optimizer: torch.optim.Optimizer, module: nn.Module, tree, what: str):
    """(parameter, array in the port's layout) for every parameter of
    ``optimizer``, from a params-shaped flax tree."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    flat = _per_edge(flat)
    names = {id(p): n for n, p in module.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    missing = [p for p in params if id(p) not in names]
    if missing:
        raise KeyError(f"{what}: {len(missing)} optimizer parameters are not parameters of the module")
    wanted = {names[id(p)]: p for p in params}
    unused, absent = sorted(set(flat) - set(wanted)), sorted(set(wanted) - set(flat))
    if unused or absent:
        raise KeyError(f"{what}: flax keys without an optimizer parameter: {unused}; "
                       f"optimizer parameters without a flax key: {absent}")
    out = []
    for name, p in wanted.items():
        arr = _to_torch_layout(name, flat[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{what}.{name}: flax shape {arr.shape} does not fit port shape {tuple(p.shape)}")
        out.append((p, torch.from_numpy(np.ascontiguousarray(arr)).to(p.device, p.dtype)))
    return out


def load_jax_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module, opt_state) -> Optional[int]:
    """Fill ``optimizer``'s state (its parameters are ``module``'s) from an
    optax chain's state (see the module doc). Returns the chain's count,
    None when it holds none. Changes nothing when it raises."""
    states = _optax_states(opt_state)
    kinds = [k for k, _, _ in states]
    if sorted(kinds) not in (["count", "trace"], ["trace"], ["adam"]):
        raise ValueError(f"opt_state: optax states {[(k, p) for k, p, _ in states]} are not an SGD-with-momentum "
                         "chain (trace, and a schedule's count) or an Adam chain (scale_by_adam)")
    by_kind = {k: (p, node) for k, p, node in states}
    count = None
    if "adam" in by_kind:
        if not isinstance(optimizer, torch.optim.Adam):
            raise ValueError(f"{by_kind['adam'][0]}: an Adam state for a {type(optimizer).__name__}")
        path, node = by_kind["adam"]
        count = int(np.asarray(node["count"]))
        mu = _per_param(optimizer, module, node["mu"], f"{path}.mu")
        nu = _per_param(optimizer, module, node["nu"], f"{path}.nu")
        fill = {p: {"step": torch.tensor(float(count), dtype=torch.float32), "exp_avg": m,
                    "exp_avg_sq": v} for (p, m), (_, v) in zip(mu, nu)}
    else:
        path, node = by_kind["trace"]
        if not isinstance(optimizer, torch.optim.SGD) or any(g["momentum"] == 0 for g in optimizer.param_groups):
            raise ValueError(f"{path}: a momentum trace for a {type(optimizer).__name__} without momentum")
        fill = {p: {"momentum_buffer": t} for p, t in _per_param(optimizer, module, node["trace"], f"{path}.trace")}
        if "count" in by_kind:
            count = int(np.asarray(by_kind["count"][1]["count"]))
    for p, st in fill.items():
        optimizer.state[p] = st
    return count


def is_jax_tree(state) -> bool:
    """True for the tree of a JAX package checkpoint (flax collections at
    its top), False for a port checkpoint (a ``model`` state_dict)."""
    return isinstance(state, dict) and "params" in state and "model" not in state


def load_checkpoint_weights(module: nn.Module, state) -> nn.Module:
    """The weights, BN statistics and arch of a restored checkpoint into
    ``module``: a port checkpoint's ``model`` state_dict, or a JAX tree's
    ``params``, ``batch_stats`` and ``arch`` (through ``load_jax_variables``)."""
    if is_jax_tree(state):
        return load_jax_variables(module, {c: state[c] for c in ("params", "batch_stats", "arch") if c in state})
    module.load_state_dict(state["model"])
    return module
