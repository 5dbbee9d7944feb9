"""The beacon-propagation task of the trained weights under
artifacts/product_proof/ (a numpy-only copy of ``gen_item`` in
scripts/product_proof.py, which imports jax).

The per-pixel label quantizes a low-frequency field into 7 classes; the
image shows the field only at sparse 4x4 "beacon" blocks, elsewhere the cue
channel is high-frequency noise. Half the images are dense (the first exit
decodes them), half sparse (only the deeper path's receptive field
propagates the field far enough), so an exit gate has a real decision to
make. The validation set is ``gen_item(9000 + i, (321, 321))`` for i < 32
(``meta.json``'s ``val_seeds``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

N_CLASSES = 7


def gen_item(seed: int, hw: Tuple[int, int], rho: Optional[float] = None) -> dict:
    """One {"image" (H, W, 3) fp32, "label" (H, W) int32, "rho"} sample."""
    r = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # the low-frequency field: wavelengths of about 160-400 px
    field = np.zeros((h, w), np.float32)
    for _ in range(3):
        fx, fy = r.uniform(0.015, 0.04, 2)
        ph = r.uniform(0, 6.28)
        field += np.sin(fx * xx + fy * yy + ph)

    def hf():
        out = np.zeros((h, w), np.float32)
        for _ in range(3):
            fx, fy = r.uniform(0.6, 1.6, 2)
            ph = r.uniform(0, 6.28)
            out += np.sin(fx * xx + fy * yy + ph)
        return out

    # beacon blocks of 4x4 at a per-image density: dense (0.15-0.5) or
    # sparse (0.006-0.05), with equal odds, log-uniform within each mode
    if rho is None:
        if r.rand() < 0.5:
            rho = float(np.exp(r.uniform(np.log(0.15), np.log(0.5))))
        else:
            rho = float(np.exp(r.uniform(np.log(0.006), np.log(0.05))))
    mb = r.rand(h // 4 + 1, w // 4 + 1) < rho
    mask = np.kron(mb, np.ones((4, 4), np.float32))[:h, :w]
    cue = field * mask
    image = np.stack(
        [cue + 0.5 * hf(), mask * 2.0 - 1.0 + 0.5 * hf(), hf()], axis=-1
    ).astype(np.float32)
    q = (field - field.min()) / (np.ptp(field) + 1e-6) * N_CLASSES
    label = np.clip(q.astype(np.int32), 0, N_CLASSES - 1)
    return {"image": image, "label": label, "rho": rho}


class BeaconSegmentation:
    """A dataset of ``gen_item(seed, hw)`` over ``seeds``, for ``DataLoader``."""

    NUM_CLASSES = N_CLASSES

    def __init__(self, seeds: Sequence[int], hw: Tuple[int, int] = (321, 321)):
        self.seeds = [int(s) for s in seeds]
        self.hw = tuple(hw)

    def __len__(self):
        return len(self.seeds)

    def __getitem__(self, index: int, rng=None):
        item = gen_item(self.seeds[index], self.hw)
        return {"image": item["image"], "label": item["label"]}
