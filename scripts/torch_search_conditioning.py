"""Where the mixed supernet's bilevel step parts from the JAX package, on
the CPU: the port's weight and arch steps on the tiny ModelSearch of
tests/test_torch_search.py (65x65, 4 layers, F=2, B=2, 5 classes, batch 4),
from the variables and against the JAX step recorded in
tests/torch_search_ref.npz (the JAX package run in float64 by
scripts/torch_record_search_ref.py), computed three ways:

  * fp32, the port as it is (two-pass BN variance, as torch.batch_norm);
  * float64, exact arithmetic for the same semantics (the port's casts to
    fp32, in the MixedOp sum and the fp32 heads, keep float64 here);
  * fp32 with the JAX package's one-pass BN variance, E[x²] - E[x]²
    clipped at 0 (auto_dynamic_deeplab_tpu/ops/norm.py), differentiated
    through as JAX does.

It prints one JSON line per step: the loss of each, the gradient distance
(L2 over all parameters, relative) of each pair, and the recorded
distance of the JAX package's own fp32 step from its float64 one; then
the BN layers whose batch statistics are worst conditioned in the weight
step's training forward (smallest batch variance against eps, over n =
N·H·W values).

    JAX_PLATFORMS=cpu python scripts/torch_search_conditioning.py

Needs no JAX: the JAX answers are the recorded ones.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_search as T  # noqa: E402  (the parity test's own set-up)
from auto_dynamic_deeplab_torch.ops import norm  # noqa: E402


@contextlib.contextmanager
def float64_kept():
    """``.float()`` and ``.to(torch.float32)`` leave float64 tensors as they are."""
    to_float, to = torch.Tensor.float, torch.Tensor.to

    def keep_float(self, *a, **k):
        return self if self.dtype == torch.float64 else to_float(self, *a, **k)

    def keep_to(self, *a, **k):
        if self.dtype == torch.float64 and (a[:1] == (torch.float32,) or k.get("dtype") is torch.float32):
            return self
        return to(self, *a, **k)

    torch.Tensor.float, torch.Tensor.to = keep_float, keep_to
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = to_float, to


@contextlib.contextmanager
def one_pass_variance():
    """Training BN as the JAX package computes it: fp32 mean and mean of
    squares, var = max(E[x²] - E[x]², 0), the running statistics blended
    with the unbiased variance."""
    forward = norm.BatchNorm.forward

    def jax_forward(self, x):
        if not self.training:
            return forward(self, x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        n = xf.numel() // xf.shape[1]
        with torch.no_grad():
            self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.var.mul_(1 - self.momentum).add_(self.momentum * var * (n / max(n - 1, 1)))
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + self.epsilon)[:, None, None]
        if self.affine:
            y = y * self.scale[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype or x.dtype)

    norm.BatchNorm.forward = jax_forward
    try:
        yield
    finally:
        norm.BatchNorm.forward = forward


def step(rec, which, reduce, dtype):
    variables = {c: T._tree(rec, f"mixed/variables/{c}") for c in ("params", "batch_stats", "arch")}
    image, label = T._recorded_batch(rec, 1)
    model = T._port(variables, "mixed").to(dtype)
    st = T.SearchSteps(model, T.make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=T.WD),
                       T.make_arch_optimizer(model.arch_parameters(), T.ARCH_LR, T.ARCH_WD),
                       T.pt_lr_schedule("cos", T.LR, 1, 2, min_lr=0.003), loss_reduce=reduce)
    loss = (st.weight_step if which == "weight" else st.arch_step)(torch.from_numpy(image).to(dtype),
                                                                   torch.from_numpy(label))
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads


def bn_conditioning(rec, top=5):
    variables = {c: T._tree(rec, f"mixed/variables/{c}") for c in ("params", "batch_stats", "arch")}
    model = T._port(variables, "mixed").train()
    rows = []

    def hook(name):
        def record(_, inputs, __):
            x = inputs[0].detach().double()
            var, mean = x.var(dim=(0, 2, 3), unbiased=False), x.mean(dim=(0, 2, 3))
            rows.append({"bn": name, "n": x.numel() // x.shape[1], "min_var": var.min().item(),
                         "max_mean2_over_var_eps": (mean ** 2 / (var + 1e-5)).max().item()})
        return record

    for name, m in model.named_modules():
        if isinstance(m, norm.BatchNorm):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.from_numpy(T._recorded_batch(rec, 1)[0]))
    return sorted(rows, key=lambda r: r["min_var"])[:top]


def main():
    with np.load(T.REF_PATH) as z:
        rec = {k: z[k] for k in z.files}
    for which, collection, decay, reduce in (("weight", "params", T.WD, "mean"), ("arch", "arch", T.ARCH_WD, "sum")):
        p0 = T._flat(T._tree(rec, f"mixed/variables/{collection}"))
        decayed = T._flat(T._tree(rec, f"mixed_step/{which}/decayed"))
        runs = {"jax_float64": (float(rec[f"mixed_step/{which}/loss"]),
                                {k: g - decay * p0[k] for k, g in decayed.items()})}
        runs["port_fp32"] = step(rec, which, reduce, torch.float32)
        with float64_kept():
            runs["port_float64"] = step(rec, which, reduce, torch.float64)
        with one_pass_variance():
            runs["port_fp32_one_pass_var"] = step(rec, which, reduce, torch.float32)
        names = list(runs)
        keys = list(runs["jax_float64"][1])
        dist = {f"{a} vs {b}": T._l2_rel({k: runs[a][1][k] for k in keys}, {k: runs[b][1][k] for k in keys})
                for i, a in enumerate(names) for b in names[i + 1:]}
        dist["jax_fp32 vs jax_float64 (recorded)"] = float(rec[f"mixed_step/{which}/fp32_grad_rel_l2"])
        print(json.dumps({"step": which, "loss": {n: runs[n][0] for n in names}, "grad_rel_l2": dist}), flush=True)
    print(json.dumps({"worst_conditioned_bn": bn_conditioning(rec)}), flush=True)


if __name__ == "__main__":
    main()
