"""How well-posed the three-step training parity of the tiny ADD is, on the
CPU: the JAX package's fp32 train step against the port's in fp32 and in
float64 (exact arithmetic for the same semantics).

For the tiny ADD of tests/test_torch_train.py (path [1,2,2,2,3,2], exit at
cell 1, F=4, B=5, 7 classes) on a synthetic batch, it prints JSON lines:
  * the BN layers whose training statistics are worst conditioned at the
    initial weights (smallest batch variance, largest mean²/(var + eps),
    over n = N·H·W values);
  * per learning rate, the three steps' losses of JAX fp32, the port fp32
    and the port float64, the first step's gradient error of each fp32 run
    against float64 (L2 over all parameters, relative), and the parameters'
    and BN statistics' largest error after three steps (per tensor,
    |Δ| / max(1, max|ref|)).

    JAX_PLATFORMS=cpu python scripts/torch_train_conditioning.py [--lr 0.02 0.001] [--hw 33 65] [--batch 2]

Needs jax (the oracle); each learning rate compiles the JAX step once.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train as T  # noqa: E402  (the parity test's own set-up)
from auto_dynamic_deeplab_torch.ops.norm import BatchNorm  # noqa: E402


def bn_conditioning(variables, image, top: int):
    pm = T._pt_add(variables).train()
    rows = []

    def hook(name):
        def record(_, inputs, __):
            x = inputs[0].detach().double()
            var = x.var(dim=(0, 2, 3), unbiased=False)
            mean = x.mean(dim=(0, 2, 3))
            rows.append({"bn": name, "n": x.numel() // x.shape[1], "min_var": var.min().item(),
                         "max_mean2_over_var_eps": (mean ** 2 / (var + 1e-5)).max().item()})
        return record

    for name, m in pm.named_modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(hook(name))
    pm(torch.from_numpy(image))
    return sorted(rows, key=lambda r: r["min_var"])[:top]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", type=float, nargs="+", default=[0.02, 0.001])
    p.add_argument("--hw", type=int, nargs=2, default=list(T.HW))
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--top", type=int, default=4)
    args = p.parse_args(argv)
    T.HW = tuple(args.hw)
    T._batch.__defaults__ = (args.batch, 0)
    variables = T.flax_variables(T._jx_add(), jnp.zeros((1, *T.HW, 3)), train=False, seed=5)
    image, _ = T._batch()
    print(json.dumps({"hw": T.HW, "batch": args.batch,
                      "worst_bn": bn_conditioning(variables, image, args.top)}), flush=True)
    for lr in args.lr:
        T.LR = lr
        tr = T.trained.__wrapped__()
        port, port64 = tr["port"], tr["port64"]
        exact = port64["grads"]
        state = {k: t.double() for k, t in port64["model"].state_dict().items()}
        print(json.dumps({
            "lr": lr, "losses": {"jax_fp32": tr["jax_losses"], "port_fp32": port["losses"],
                                 "port_float64": port64["losses"]},
            "grad_l2_rel_err_step1": {"jax_fp32": T._l2_rel(tr["jax_grads"], exact),
                                      "port_fp32": T._l2_rel(port["grads"], exact)},
            "state_max_err_step3": {
                "jax_fp32": T._max_err(tr["jax_model"].state_dict(), state),
                "port_fp32": T._max_err(port["model"].state_dict(), state)},
        }, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
