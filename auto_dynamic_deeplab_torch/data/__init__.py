"""Loader factory (data/__init__.py::make_data_loader of the JAX package;
the reference's dataloaders/__init__.py).

Supernet search mode returns TWO train loaders, from a 50/50 Cityscapes
train split (the bilevel weight/arch optimization); edm mode returns
full-size train images. ``DEFAULT_ROOTS`` come from ``CITYSCAPES_ROOT``
and ``PASCAL_ROOT``.
"""
from __future__ import annotations

import os
from typing import Optional

from .cityscapes import CityscapesSegmentation, two_train_seg
from .device_transforms import augment_batch, make_eval_preprocess, make_train_augment, sample_augment_params
from .loader import DataLoader, peek_batch
from .pascal import VOCSegmentation
from .rawcache import RawArrayCache
from .synthetic import SyntheticSegmentation
from .transforms import (
    CITYSCAPES_MEAN,
    CITYSCAPES_STD,
    IGNORE_LABEL,
    eval_preprocess,
    full_image_eval_preprocess,
    train_preprocess,
)
from .utils import calculate_class_weights, decode_segmap

DEFAULT_ROOTS = {
    "cityscapes": os.environ.get("CITYSCAPES_ROOT", "/data/cityscapes"),
    "pascal": os.environ.get("PASCAL_ROOT", "/data/pascal/VOCdevkit"),
}


def make_data_loader(
    dataset: str,
    batch_size: int,
    test_batch_size: Optional[int] = None,
    root: Optional[str] = None,
    supernet: bool = False,
    edm: bool = False,
    num_workers: int = 4,
    shard=(0, 1),
    seed: int = 0,
    crop_size=(769, 769),
    synthetic_length: int = 64,
    synthetic_crop=(65, 65),
    raw_train: bool = False,
):
    """Returns (train, val, num_classes); with ``supernet`` (the bilevel
    search) (train, train B, val, num_classes): on Cityscapes the two
    halves of ``two_train_seg``, on the synthetic set B is the seed-2
    half.

    ``raw_train`` (Cityscapes, plain train mode): the train loader yields
    decode-only uint8 batches for the on-device augmentation
    (``data/device_transforms.py``); val stays host-preprocessed at full
    size."""
    test_batch_size = test_batch_size or batch_size
    kw = dict(num_workers=num_workers, seed=seed, shard=shard)

    if dataset == "synthetic":
        train_set = SyntheticSegmentation(synthetic_length, synthetic_crop)
        val_set = SyntheticSegmentation(max(8, synthetic_length // 4), synthetic_crop, seed=1)
        val = DataLoader(val_set, test_batch_size, shuffle=False, drop_last=False, **kw)
        if supernet:
            half = SyntheticSegmentation(synthetic_length // 2, synthetic_crop, seed=2)
            return DataLoader(train_set, batch_size, **kw), DataLoader(half, batch_size, **kw), val, train_set.NUM_CLASSES
        return DataLoader(train_set, batch_size, **kw), val, train_set.NUM_CLASSES

    if dataset == "pascal":
        root = root or DEFAULT_ROOTS["pascal"]
        train_set = VOCSegmentation(root, "train")
        val_set = VOCSegmentation(root, "val")
    elif "cityscapes" in dataset:
        root = root or DEFAULT_ROOTS["cityscapes"]
        val_set = CityscapesSegmentation(root, "val")
        if edm or dataset == "cityscapes_edm":
            train_set = CityscapesSegmentation(root, "train", full=True)
        elif supernet:
            set_a, set_b = two_train_seg(root, seed=seed)
            return (
                DataLoader(set_a, batch_size, **kw),
                DataLoader(set_b, batch_size, **kw),
                DataLoader(val_set, test_batch_size, shuffle=False, drop_last=False, **kw),
                set_a.NUM_CLASSES,
            )
        else:
            train_set = CityscapesSegmentation(root, "train", crop_size=crop_size, raw=raw_train)
    else:
        raise NotImplementedError(dataset)

    return (
        DataLoader(train_set, batch_size, **kw),
        DataLoader(val_set, test_batch_size, shuffle=False, drop_last=False, **kw),
        train_set.NUM_CLASSES,
    )


__all__ = [
    "CITYSCAPES_MEAN",
    "CITYSCAPES_STD",
    "DEFAULT_ROOTS",
    "IGNORE_LABEL",
    "CityscapesSegmentation",
    "DataLoader",
    "RawArrayCache",
    "SyntheticSegmentation",
    "VOCSegmentation",
    "augment_batch",
    "calculate_class_weights",
    "decode_segmap",
    "eval_preprocess",
    "full_image_eval_preprocess",
    "make_data_loader",
    "make_eval_preprocess",
    "make_train_augment",
    "peek_batch",
    "sample_augment_params",
    "train_preprocess",
    "two_train_seg",
]
