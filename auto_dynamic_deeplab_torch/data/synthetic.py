"""Synthetic segmentation dataset for tests/benchmarks (no Cityscapes on disk);
a numpy-only copy of auto_dynamic_deeplab_tpu/data/synthetic.py.

Labels are a deterministic function of the image (quantized smooth field), so
models can measurably overfit — used by the end-to-end training smoke tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SyntheticSegmentation:
    NUM_CLASSES = 19

    def __init__(
        self,
        length: int = 64,
        crop_size: Tuple[int, int] = (65, 65),
        num_classes: int = 19,
        seed: int = 0,
    ):
        self.length = length
        self.crop_size = crop_size
        self.NUM_CLASSES = num_classes
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        r = np.random.RandomState(self.seed * 100003 + index)
        h, w = self.crop_size
        # smooth random field: few random sinusoids
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        field = np.zeros((h, w), np.float32)
        for _ in range(4):
            fx, fy = r.uniform(0.02, 0.2, 2)
            ph = r.uniform(0, 6.28)
            field += np.sin(fx * xx + fy * yy + ph)
        image = np.stack(
            [field, np.roll(field, 3, 0), np.roll(field, 3, 1)], axis=-1
        ).astype(np.float32)
        image += 0.05 * r.randn(h, w, 3).astype(np.float32)
        label = np.clip(
            ((field - field.min()) / (np.ptp(field) + 1e-6) * self.NUM_CLASSES).astype(
                np.int32
            ),
            0,
            self.NUM_CLASSES - 1,
        )
        # sprinkle ignore pixels to exercise the 255 path
        ignore = r.rand(h, w) < 0.02
        label = np.where(ignore, 255, label).astype(np.int32)
        return {"image": image, "label": label}
