"""Loader factory (data/__init__.py::make_data_loader of the JAX package),
synthetic data only in this slice: Cityscapes and Pascal (and the search
split of Cityscapes, ``two_train_seg``) wait for ROADMAP Queue 1 item 8."""
from __future__ import annotations

from typing import Optional

from .loader import DataLoader, peek_batch
from .synthetic import SyntheticSegmentation
from .utils import calculate_class_weights, decode_segmap


def make_data_loader(
    dataset: str,
    batch_size: int,
    test_batch_size: Optional[int] = None,
    num_workers: int = 4,
    shard=(0, 1),
    seed: int = 0,
    synthetic_length: int = 64,
    synthetic_crop=(65, 65),
    supernet: bool = False,
):
    """Returns (train, val, num_classes); with ``supernet`` (the bilevel
    search) (train, train B, val, num_classes), B the seed-2 half."""
    if dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet (ROADMAP Queue 1 item 8); "
            "use --dataset synthetic"
        )
    test_batch_size = test_batch_size or batch_size
    train_set = SyntheticSegmentation(synthetic_length, synthetic_crop)
    val_set = SyntheticSegmentation(max(8, synthetic_length // 4), synthetic_crop, seed=1)
    kw = dict(num_workers=num_workers, seed=seed, shard=shard)
    val = DataLoader(val_set, test_batch_size, shuffle=False, drop_last=False, **kw)
    if supernet:
        half = SyntheticSegmentation(synthetic_length // 2, synthetic_crop, seed=2)
        return DataLoader(train_set, batch_size, **kw), DataLoader(half, batch_size, **kw), val, train_set.NUM_CLASSES
    return (
        DataLoader(train_set, batch_size, **kw),
        val,
        train_set.NUM_CLASSES,
    )


__all__ = [
    "DataLoader", "SyntheticSegmentation", "calculate_class_weights", "decode_segmap",
    "make_data_loader", "peek_batch",
]
