"""Training scalars and image grids (utils/summaries.py of the JAX package;
the reference's tensorboardX summaries), as files in the experiment
directory: ``scalars.jsonl``, one JSON object a line with ``t``, ``tag``,
``value`` and ``step`` (the JAX package's fallback format), and
``images/{image,pred,gt}_{step}.png``. No TensorBoard writer: the card's
machine has no tensorboard package, and where TensorFlow is installed
``torch.utils.tensorboard`` loads it, and JAX with it, into the process."""
from __future__ import annotations

import json
import os
import time

import numpy as np

from ..data.utils import decode_segmap


def _grid(images: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) uint8 → one (H, N*W, 3) row."""
    return np.concatenate(list(images), axis=1)


class TrainingSummary:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()

    def visualize_image(self, image, target, pred, step: int, dataset: str = "cityscapes",
                        max_images: int = 3):
        """Image / prediction / ground-truth grids (summaries.py:15-23) of
        the first ``max_images`` of a batch: NHWC images scaled to [0, 1]
        over the batch, as the JAX package scales them, and the label maps
        colored by ``decode_segmap``. Returns the three PNG paths."""
        from PIL import Image

        img = np.asarray(image[:max_images], np.float32)
        img = (img - img.min()) / max(float(img.max() - img.min()), 1e-6)
        grids = {
            "image": (img * 255.0 + 0.5).astype(np.uint8),
            "pred": np.stack([decode_segmap(np.asarray(p), dataset) for p in pred[:max_images]]),
            "gt": np.stack([decode_segmap(np.asarray(t), dataset) for t in target[:max_images]]),
        }
        out_dir = os.path.join(self.directory, "images")
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for tag, batch in grids.items():
            path = os.path.join(out_dir, f"{tag}_{int(step)}.png")
            Image.fromarray(_grid(batch)).save(path)
            paths.append(path)
        return paths

    def close(self):
        self._jsonl.close()
