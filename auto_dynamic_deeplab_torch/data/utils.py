"""Label colorization and class-balance weights (a numpy-only copy of
auto_dynamic_deeplab_tpu/data/utils.py; the reference's
dataloaders/utils.py and utils/calculate_weights.py)."""
from __future__ import annotations

import numpy as np

CITYSCAPES_COLORS = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    np.uint8,
)

PASCAL_COLORS = np.array(
    [
        [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
        [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0],
        [192, 0, 0], [64, 128, 0], [192, 128, 0], [64, 0, 128],
        [192, 0, 128], [64, 128, 128], [192, 128, 128], [0, 64, 0],
        [128, 64, 0], [0, 192, 0], [128, 192, 0], [0, 64, 128],
    ],
    np.uint8,
)


def decode_segmap(label_mask: np.ndarray, dataset: str = "cityscapes") -> np.ndarray:
    """(H, W) class ids → (H, W, 3) uint8 RGB; ignore/out-of-range → black."""
    colors = CITYSCAPES_COLORS if dataset == "cityscapes" else PASCAL_COLORS
    n = len(colors)
    palette = np.concatenate([colors, np.zeros((1, 3), np.uint8)], axis=0)
    safe = np.where((label_mask >= 0) & (label_mask < n), label_mask, n)
    return palette[safe]


def calculate_class_weights(dataset, num_classes: int, max_items: int = 0) -> np.ndarray:
    """1 / log(1.02 + freq) class-balance weights
    (utils/calculate_weights.py:6-29)."""
    z = np.zeros(num_classes, np.float64)
    n = len(dataset) if max_items == 0 else min(max_items, len(dataset))
    for i in range(n):
        y = dataset[i]["label"]
        mask = (y >= 0) & (y < num_classes)
        z += np.bincount(y[mask].astype(np.int64), minlength=num_classes)
    freq = z / max(z.sum(), 1.0)
    return (1.0 / np.log(1.02 + freq)).astype(np.float32)
