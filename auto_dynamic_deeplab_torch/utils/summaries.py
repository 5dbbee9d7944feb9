"""Training scalars (utils/summaries.py of the JAX package; the reference's
tensorboardX summaries), as ``scalars.jsonl`` in the experiment directory:
one JSON object a line with ``t``, ``tag``, ``value`` and ``step``, the
JAX package's fallback format. No TensorBoard writer: the card's machine
has no tensorboard package, and where TensorFlow is installed
``torch.utils.tensorboard`` loads it, and JAX with it, into the process."""
from __future__ import annotations

import json
import os
import time


class TrainingSummary:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
