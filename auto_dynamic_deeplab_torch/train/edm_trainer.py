"""Stage 3: train the Earlier-exit Decision Maker (train/edm_trainer.py of
the JAX package; the reference's train_edm.py).

1. ``make_edm_dataset``: one pass over the train images through the
   frozen backbone's first exit, keeping (pre-head feature, normalized
   Shannon entropy of the exit's logits) pairs (train_edm.py:146-167); on
   the card the entropy is K2's. The cache files and their layout (NHWC
   fp32 features) are the JAX package's.
2. ``train_edm``: Adam(1e-3) and an L1 regression of the entropy from the
   feature (train_edm.py:107-108, :169-185), in the JAX package's batch
   order: one ``np.random.RandomState(seed).permutation`` an epoch,
   partial batches dropped. A plain loop of steps (the JAX package's one
   ``lax.scan`` saves a TPU dispatch per step).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.confidence import entropy_argmax
from ..models.decoded import EDM
from ..runtime import resolve_device
from ..utils.initialize import init_params


def make_edm_dataset(
    model,
    loader,
    num_classes: int = 19,
    cache_dir: Optional[str] = None,
    max_items: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features (N, h, w, c), entropies (N,)), both fp32."""
    cache_key = f"arch{''.join(map(str, model.network_arch))}_F{model.F}_B{model.B}"
    if cache_dir:
        fpath = os.path.join(cache_dir, f"feature_{cache_key}.npy")
        epath = os.path.join(cache_dir, f"entropy_{cache_key}.npy")
        if os.path.exists(fpath) and os.path.exists(epath):
            return np.load(fpath), np.load(epath)

    device = resolve_device(device)
    model = model.to(device).eval()
    feats, ents = [], []
    count = 0
    with torch.inference_mode():
        for batch in loader:
            logits, feature = model.get_feature(torch.as_tensor(batch["image"]).to(device), class_leading=True)
            ent = entropy_argmax(logits, num_classes, class_axis=1)[0]
            feats.append(feature.permute(0, 2, 3, 1).float().cpu().numpy())
            ents.append(ent.cpu().numpy())
            count += feature.shape[0]
            if max_items and count >= max_items:
                break
    features = np.concatenate(feats)[: max_items or None]
    entropies = np.concatenate(ents)[: max_items or None]

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(fpath, features)
        np.save(epath, entropies)
    return features, entropies


def train_edm(
    features: np.ndarray,
    entropies: np.ndarray,
    epochs: int = 20,
    batch_size: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    device="cuda",
    edm: Optional[EDM] = None,
) -> Tuple[EDM, float]:
    """Returns (the trained EDM in eval mode, the last epoch's mean L1).
    ``edm`` is the starting module (a fresh one seeded by ``seed`` when
    None); ``features`` NHWC as ``make_edm_dataset`` gives them."""
    n = features.shape[0]
    if n == 0:
        raise ValueError("empty EDM dataset")
    device = resolve_device(device)
    if edm is None:
        edm = init_params(EDM(features.shape[-1]), torch.Generator().manual_seed(seed))
    edm = edm.to(device).train()
    if epochs <= 0:
        return edm.eval(), float("nan")
    batch_size = min(batch_size, n)  # small datasets must still train
    optimizer = torch.optim.Adam(edm.parameters(), lr=lr)
    feats = torch.from_numpy(features).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    ents = torch.from_numpy(entropies)
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n))
        losses = []
        for b in range(0, n - batch_size + 1, batch_size):
            ib = order[b : b + batch_size]
            f, e = feats[ib].to(device), ents[ib].to(device)
            loss = (edm(f)[:, 0] - e).abs().mean()  # L1 (train_edm.py:108)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
    return edm.eval(), float(torch.stack(losses).mean())
