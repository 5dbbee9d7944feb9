"""Confidence-signal analysis (train/analysis.py of the JAX package; the
reference's eval_edm.py testing_entropy study, :196-250): how well cheap
per-image signals (the feature's mean magnitude, the normalized entropy,
the max-probability coverage) track the true per-image loss, measured by
cosine similarity over the val set. Used to justify the EDM.

The signals are plain PyTorch ops (``ops/confidence.py``), as the JAX
study uses its plain jnp functions, not the entropy kernel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.confidence import confidence_max, normalized_shannon_entropy
from .loss import cross_entropy


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else float("nan")


@torch.inference_mode()
def entropy_signal_study(model, loader, num_classes: int = 19, threshold: float = 0.9) -> Dict:
    """Per-image first-exit signals of ``model`` (its own weights, in eval
    mode, on its device) over ``loader``, and their cosine similarity to
    the per-image cross-entropy loss."""
    model.eval()
    device = next(model.parameters()).device
    ent, maxc, pool, loss = [], [], [], []
    for batch in loader:
        x = torch.as_tensor(batch["image"]).to(device, torch.float32)
        y = torch.as_tensor(batch["label"]).to(device)
        logits, feature = model.get_feature(x, class_leading=True)
        loss.append(torch.stack([cross_entropy(logits[i:i + 1], y[i:i + 1]) for i in range(x.shape[0])]))
        ent.append(normalized_shannon_entropy(logits, num_classes, class_axis=1))
        maxc.append(confidence_max(logits, threshold, class_axis=1))
        pool.append(feature.float().abs().mean(dim=(1, 2, 3)))  # GAP magnitude
    ent, maxc, pool, loss = (torch.cat(v).cpu().numpy() for v in (ent, maxc, pool, loss))
    return {
        "cos_entropy_loss": cosine_similarity(ent, loss),
        "cos_max_loss": cosine_similarity(maxc, loss),
        "cos_pool_loss": cosine_similarity(pool, loss),
        "n": len(loss),
        "entropy": ent,
        "loss": loss,
    }


def time_measure(engine, x, confidence: str = "entropy", threshold: float = -1.0) -> float:
    """Latency probe (autodeeplab.py:206-229 / ADD timing): one timed pass
    of ``engine.infer`` (full depth at the default threshold); seconds."""
    _, _, dt, _ = engine.infer(x, threshold=threshold, confidence=confidence)
    return dt
