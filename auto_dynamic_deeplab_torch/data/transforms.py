"""Host preprocessing (a numpy and PIL copy of
auto_dynamic_deeplab_tpu/data/transforms.py; the reference's
dataloaders/custom_transforms.py:238-347).

train_preprocess: random hflip → random log-uniform scale in [0.5, 2] (or a
fixed scale for search) → normalize → zero-pad to crop (mask pad 255) →
random crop. eval/full_image variants pad only. The ``*_native`` variants
run the same pipeline in one pass of the C++ engine (``data/native.py``).

Output layout is NHWC float32 + int32 masks. PIL is imported by the
functions that resample, so that the package imports without Pillow.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

CITYSCAPES_MEAN = (0.29866842, 0.30135223, 0.30561872)
CITYSCAPES_STD = (0.23925215, 0.23859318, 0.2385942)
IGNORE_LABEL = 255


def _normalize(img, mean, std) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _pad_to(image: np.ndarray, mask: np.ndarray, crop: Tuple[int, int]):
    h, w = image.shape[:2]
    pad_tb = max(0, crop[0] - h)
    pad_lr = max(0, crop[1] - w)
    if pad_tb or pad_lr:
        image = np.pad(image, ((0, pad_tb), (0, pad_lr), (0, 0)))
        mask = np.pad(mask, ((0, pad_tb), (0, pad_lr)), constant_values=IGNORE_LABEL)
    return image, mask


def _draw_scale(scale: float, rng) -> float:
    """``scale``, or 2**u with u uniform in [log2 0.5, log2 2] when it is 0."""
    if scale != 0.0:
        return scale
    lo, hi = math.log(0.5, 2), math.log(2.0, 2)
    return 2.0 ** (lo + rng.random_sample() * (hi - lo))


def train_preprocess(
    img,
    mask,
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
    scale: float = 0.0,
    rng: Optional[np.random.RandomState] = None,
):
    """PIL image and mask → (crop (h, w, 3) f32, crop (h, w) i32). Draws,
    in this order: flip, scale (when ``scale`` is 0), crop i, crop j."""
    from PIL import Image

    rng = rng or np.random
    if rng.random_sample() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)

    w, h = img.size
    random_scale = _draw_scale(scale, rng)
    new_size = (int(round(w * random_scale)), int(round(h * random_scale)))
    if new_size != (w, h):
        img = img.resize(new_size, Image.LANCZOS)  # reference: Image.ANTIALIAS
        mask = mask.resize(new_size, Image.NEAREST)

    image = _normalize(img, mean, std)
    m = np.asarray(mask, np.int64).astype(np.int32)
    image, m = _pad_to(image, m, crop_size)

    h, w = image.shape[:2]
    i = rng.randint(0, h - crop_size[0] + 1)
    j = rng.randint(0, w - crop_size[1] + 1)
    return image[i : i + crop_size[0], j : j + crop_size[1]], m[i : i + crop_size[0], j : j + crop_size[1]]


def eval_preprocess(
    img,
    mask,
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
    rng: Optional[np.random.RandomState] = None,
):
    """Random-crop eval (custom_transforms.py:289-320)."""
    rng = rng or np.random
    image = _normalize(img, mean, std)
    m = np.asarray(mask, np.int64).astype(np.int32)
    image, m = _pad_to(image, m, crop_size)
    h, w = image.shape[:2]
    i = rng.randint(0, h - crop_size[0] + 1)
    j = rng.randint(0, w - crop_size[1] + 1)
    return image[i : i + crop_size[0], j : j + crop_size[1]], m[i : i + crop_size[0], j : j + crop_size[1]]


def full_image_eval_preprocess(
    img,
    mask,
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
):
    """Pad-only full-image eval (custom_transforms.py:322-347): e.g.
    1024x2048 → 1025x2049 padded (image 0, mask 255)."""
    image = _normalize(img, mean, std)
    m = np.asarray(mask, np.int64).astype(np.int32)
    return _pad_to(image, m, crop_size)


# ---------------------------------------------------------------- native path


def train_preprocess_native(
    img,
    mask,
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
    scale: float = 0.0,
    rng: Optional[np.random.RandomState] = None,
):
    """One pass of the C++ engine (``csrc/augment.cpp``), with the same
    draws in the same order as ``train_preprocess``. Its image filter is a
    separable antialiased triangle, not PIL's LANCZOS: the two agree
    exactly at scale 1 only."""
    from .native import augment_train_native

    rng = rng or np.random
    flip = rng.random_sample() < 0.5
    w, h = img.size
    random_scale = _draw_scale(scale, rng)
    nh, nw = int(round(h * random_scale)), int(round(w * random_scale))
    pad_h, pad_w = max(nh, crop_size[0]), max(nw, crop_size[1])
    i = rng.randint(0, pad_h - crop_size[0] + 1)
    j = rng.randint(0, pad_w - crop_size[1] + 1)
    return augment_train_native(
        np.asarray(img, np.uint8), np.asarray(mask, np.uint8),
        crop_size, mean, std, float(random_scale), bool(flip), int(i), int(j),
    )


def full_image_eval_preprocess_native(
    img,
    mask,
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
):
    """Normalize and pad in one pass of the C++ engine."""
    from .native import eval_full_native

    return eval_full_native(np.asarray(img, np.uint8), np.asarray(mask, np.uint8), crop_size, mean, std)
