"""Seeded raw weights, made on the device in a few large calls.

Every parameter named by a specification (``reference.add.all_specs``) is
one view of a single flat buffer: one normal and one uniform draw of the
buffer's length from a generator on the device, each element scaled and
shifted by its parameter's kind, so that the logits stay finite and spread
through a deep net whose eval-mode BN statistics are not fitted to it:

  * conv kernels: He normal, std sqrt(2 / fan_in);
  * dense kernels: std sqrt(1 / fan_in);
  * biases, BN biases and BN means: normal, std 0.1;
  * BN scales: uniform in [0.5, 1.5); BN variances: uniform in [0.5, 2.0).

Non-trivial BN statistics make a program's BN folding do real work.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# kind -> (normal factor, uniform factor, offset); None: He or LeCun by fan-in
_KINDS = {
    "conv": (None, 0.0, 0.0),
    "dense": (None, 0.0, 0.0),
    "bias": (0.1, 0.0, 0.0),
    "bn_scale": (0.0, 1.0, 0.5),
    "bn_bias": (0.1, 0.0, 0.0),
    "bn_mean": (0.1, 0.0, 0.0),
    "bn_var": (0.0, 1.5, 0.5),
}


def _factors(shape: Tuple[int, ...], kind: str) -> Tuple[float, float, float]:
    normal, uniform, offset = _KINDS[kind]
    if normal is None:
        fan_in = math.prod(shape[1:])
        normal = math.sqrt((2.0 if kind == "conv" else 1.0) / fan_in)
    return normal, uniform, offset


def make_weights(specs: List[Tuple[str, Tuple[int, ...], str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every (name, shape, kind) of ``specs``, float32
    on ``device``, from ``seed``."""
    device = torch.device(device)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    total = sum(sizes)
    factors = np.array([_factors(shape, kind) for _, shape, kind in specs], dtype=np.float32)
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    per = torch.from_numpy(factors).to(device)
    a, b, c = (torch.repeat_interleave(per[:, i], counts, output_size=total) for i in range(3))
    flat = torch.addcmul(torch.addcmul(c, normal, a), uniform, b)
    del normal, uniform, a, b, c
    return {name: t.view(shape) for (name, shape, _), t in zip(specs, torch.split(flat, sizes))}
