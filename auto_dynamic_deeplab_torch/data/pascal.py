"""Pascal VOC 2012 segmentation (a copy of
auto_dynamic_deeplab_tpu/data/pascal.py; the reference's
dataloaders/datasets/pascal.py): 21 classes, 513x513 crops, list files.
Items are decoded with Pillow, imported where a file is opened.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import transforms as T

NUM_CLASSES = 21
PASCAL_MEAN = (0.485, 0.456, 0.406)
PASCAL_STD = (0.229, 0.224, 0.225)


class VOCSegmentation:
    NUM_CLASSES = NUM_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "train",
        crop_size: Tuple[int, int] = (513, 513),
        year: str = "VOC2012",
    ):
        self.root = root
        self.split = split
        self.crop_size = crop_size
        base = os.path.join(root, year)
        self.image_dir = os.path.join(base, "JPEGImages")
        self.label_dir = os.path.join(base, "SegmentationClass")
        list_file = os.path.join(base, "ImageSets", "Segmentation", f"{split}.txt")
        with open(list_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        if not self.ids:
            raise FileNotFoundError(f"empty split list {list_file}")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        from PIL import Image

        name = self.ids[index]
        img = Image.open(os.path.join(self.image_dir, name + ".jpg")).convert("RGB")
        mask = Image.open(os.path.join(self.label_dir, name + ".png"))
        if self.split == "train":
            image, label = T.train_preprocess(img, mask, self.crop_size, mean=PASCAL_MEAN, std=PASCAL_STD, rng=rng)
        else:
            image, label = T.full_image_eval_preprocess(img, mask, self.crop_size, mean=PASCAL_MEAN, std=PASCAL_STD)
        return {"image": image, "label": label.astype(np.int32)}
