"""The one traffic generator: turns a traffic file's parameters and a seed
into the order of requests.

An early-exit mix comes in blocks of ``block`` requests, of which
``early_per_block`` are sent with ``early_threshold`` (they exit at the
first decision) and the rest with ``full_threshold`` (they run to full
depth), in an order that the seed shuffles anew in every block; so every
seed sends the same share, exactly, over every block. The images are drawn
from a pool of ``pool_images``, each visited once in every pass over the
pool, in an order the seed shuffles anew in every pass.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Request(NamedTuple):
    index: int
    image: int  # index into the image pool
    early: bool  # sent to exit at the first decision
    threshold: float


def requests(traffic: dict, rng: np.random.Generator) -> Iterator[Request]:
    """An endless, seeded stream of requests."""
    block, early = int(traffic["block"]), int(traffic["early_per_block"])
    if not 0 <= early <= block:
        raise ValueError(f"early_per_block {early} outside 0..{block}")
    pool = int(traffic["pool_images"])
    kinds = np.array([True] * early + [False] * (block - early))
    images: list = []
    i = 0
    while True:
        for is_early in rng.permutation(kinds):
            if not images:
                images = list(rng.permutation(pool))
            yield Request(i, int(images.pop()), bool(is_early),
                          float(traffic["early_threshold"] if is_early else traffic["full_threshold"]))
            i += 1
