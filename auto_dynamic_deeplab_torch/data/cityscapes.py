"""Cityscapes (a copy of auto_dynamic_deeplab_tpu/data/cityscapes.py; the
reference's dataloaders/datasets/cityscapes.py).

19 classes from 33 raw ids (table at cityscapes.py:44-52), ignore=255,
the dataset's mean/std, recursive png discovery, and the supernet search's
50/50 split (``two_train_seg``, twoTrainSeg at cityscapes.py:12-22).

Items are decoded with Pillow, imported where a file is opened.
Preprocessing runs on the native C++ engine (``data/native.py``) when it
builds and ``ADD_TPU_NATIVE`` is not 0, else in numpy and PIL; the two
resample differently at a scale other than 1, so each dataset logs once
which engine it took.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from . import native
from . import transforms as T

log = logging.getLogger(__name__)

NUM_CLASSES = 19
VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]
CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic_light",
    "traffic_sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]

# raw label id -> train id (255 = ignore)
LUT = np.full(256, T.IGNORE_LABEL, np.uint8)
for _train_id, _raw in enumerate(VALID_CLASSES):
    LUT[_raw] = _train_id


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    return LUT[mask.astype(np.uint8)]


def recursive_glob(rootdir: str, suffix: str = ".png"):
    return sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(rootdir)
        for f in files
        if f.endswith(suffix)
    )


class CityscapesSegmentation:
    """Map-style dataset of {"image" (h, w, 3) f32, "label" (h, w) i32};
    with ``raw`` {"image_u8" (H, W, 3) u8, "label_u8" (H, W) u8 train ids}
    for the on-device augmentation (``data/device_transforms.py``)."""

    NUM_CLASSES = NUM_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "train",
        crop_size: Tuple[int, int] = (769, 769),
        search: bool = False,
        full: bool = False,
        indices_for_split: Optional[Sequence[int]] = None,
        eval_crop: Tuple[int, int] = (1025, 2049),
        raw: bool = False,
    ):
        self.root = root
        self.split = split
        self.search = search
        self.full = full
        self.raw = raw
        self.crop_size = (321, 321) if search else crop_size
        self.eval_crop = eval_crop
        self.images_base = os.path.join(root, "leftImg8bit", split)
        self.annotations_base = os.path.join(root, "gtFine", split)
        self.files = recursive_glob(self.images_base)
        if indices_for_split is not None:
            self.files = [self.files[i] for i in indices_for_split]
        if not self.files:
            raise FileNotFoundError(f"No files for split={split} found in {self.images_base}")
        # raw items are decoded only; the others take the native engine when
        # it is on and builds
        self.native = not raw and native.enabled() and native.available()
        if not raw:
            log.info("cityscapes %s: preprocessing on the %s engine", split,
                     "native C++ (triangle filter)" if self.native else "numpy/PIL (LANCZOS)")

    def __len__(self):
        return len(self.files)

    def label_path(self, img_path: str) -> str:
        return os.path.join(
            self.annotations_base,
            os.path.basename(os.path.dirname(img_path)),
            os.path.basename(img_path)[: -len("leftImg8bit.png")] + "gtFine_labelIds.png",
        )

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        from PIL import Image

        img_path = self.files[index]
        img = Image.open(img_path).convert("RGB")
        raw = np.asarray(Image.open(self.label_path(img_path)), np.uint8)
        if self.raw:
            return {"image_u8": np.asarray(img, np.uint8), "label_u8": encode_segmap(raw)}

        train = self.split == "train" and not self.full
        scale = 0.5 if self.search else 0.0
        if self.native:
            mask = Image.fromarray(native.encode_labels_native(raw, LUT))
            if train:
                image, label = T.train_preprocess_native(img, mask, self.crop_size, scale=scale, rng=rng)
            else:
                image, label = T.full_image_eval_preprocess_native(img, mask, self.eval_crop)
        else:
            mask = Image.fromarray(encode_segmap(raw))
            if train:
                image, label = T.train_preprocess(img, mask, self.crop_size, scale=scale, rng=rng)
            else:
                image, label = T.full_image_eval_preprocess(img, mask, self.eval_crop)
        return {"image": image, "label": label}


def two_train_seg(
    root: str, seed: Optional[int] = None, **kw
) -> Tuple[CityscapesSegmentation, CityscapesSegmentation]:
    """50/50 train split for the bilevel supernet search
    (cityscapes.py:12-22): one ``RandomState(seed).permutation``."""
    probe = CityscapesSegmentation(root, split="train", search=True, **kw)
    perm = np.random.RandomState(seed).permutation(len(probe))
    half = len(probe) // 2
    return (
        CityscapesSegmentation(root, split="train", search=True, indices_for_split=perm[:half], **kw),
        CityscapesSegmentation(root, split="train", search=True, indices_for_split=perm[half:], **kw),
    )
