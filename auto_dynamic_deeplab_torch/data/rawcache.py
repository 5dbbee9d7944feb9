"""Decode-once raw uint8 cache, the storage layer of the on-device input
pipeline (a copy of auto_dynamic_deeplab_tpu/data/rawcache.py; the file
format is the same, so either package reads a cache the other wrote).

A Cityscapes frame costs 100-200 ms of host CPU to decode, again every
epoch. The cache decodes each frame once into memory-mapped uint8 arrays
and serves views of them afterwards; with ``data/device_transforms.py``
the host's work a sample is a memmap slice and an upload.

Files under ``cache_dir``: images.npy (N, H, W, 3) u8, labels.npy (N, H, W)
u8 (train ids), meta.json. Build once with ``RawArrayCache.build``; the
class is a map-style dataset yielding the same {"image_u8", "label_u8"}
items as a ``raw=True`` dataset, so it drops into DataLoader unchanged.
"""
from __future__ import annotations

import json
import os

import numpy as np


class RawArrayCache:
    """Map-style dataset over a decode-once raw uint8 cache."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        n, h, w = self.meta["n"], self.meta["h"], self.meta["w"]
        self.images = np.lib.format.open_memmap(os.path.join(cache_dir, "images.npy"), mode="r")
        self.labels = np.lib.format.open_memmap(os.path.join(cache_dir, "labels.npy"), mode="r")
        if self.images.shape != (n, h, w, 3) or self.labels.shape != (n, h, w):
            raise ValueError(f"cache {cache_dir}: arrays {self.images.shape}, {self.labels.shape} "
                             f"do not match meta.json's (n, h, w) = {(n, h, w)}")
        self.NUM_CLASSES = self.meta.get("num_classes", 19)

    def __len__(self):
        return self.meta["n"]

    def __getitem__(self, index: int, rng=None):
        # a copy of the memmap slice: pages fault in lazily, then the OS
        # page cache serves them
        return {"image_u8": np.asarray(self.images[index]), "label_u8": np.asarray(self.labels[index])}

    @staticmethod
    def build(dataset, cache_dir: str, num_classes: int = 19) -> "RawArrayCache":
        """Decode every item of a ``raw=True``-style dataset once into the
        cache (kept when a complete cache is already there)."""
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.isfile(meta_path):
            try:
                return RawArrayCache(cache_dir)
            except (OSError, ValueError, KeyError):  # incomplete cache: rebuild
                pass
        os.makedirs(cache_dir, exist_ok=True)
        first = dataset[0]
        h, w = first["image_u8"].shape[:2]
        n = len(dataset)
        images = np.lib.format.open_memmap(os.path.join(cache_dir, "images.npy"), mode="w+",
                                           dtype=np.uint8, shape=(n, h, w, 3))
        labels = np.lib.format.open_memmap(os.path.join(cache_dir, "labels.npy"), mode="w+",
                                           dtype=np.uint8, shape=(n, h, w))
        for i in range(n):
            item = first if i == 0 else dataset[i]
            images[i] = item["image_u8"]
            labels[i] = item["label_u8"]
        images.flush()
        labels.flush()
        del images, labels
        with open(meta_path, "w") as f:
            json.dump({"n": n, "h": h, "w": w, "num_classes": num_classes}, f)
        return RawArrayCache(cache_dir)
