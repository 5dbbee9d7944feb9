"""Genotype schema and the shipped searched architectures (a numpy-only copy
of auto_dynamic_deeplab_tpu/nas/genotypes.py; the port imports nothing of
the JAX package).

A cell genotype is a (k, 2) int array of [edge_index, op_index] rows; a
network path is a length-12 array of levels in {0,1,2,3} (stride 4/8/16/32).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

PRIMITIVES = [
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
]


class Genotype(NamedTuple):
    """The reference's genotype record (modeling/genotypes.py): a cell's
    rows and the states its output concatenates."""

    cell: Sequence
    cell_concat: Sequence


def num_edges(B: int) -> int:
    """k = sum_{i<B} (2+i): 20 for B=5 (model_search.py:634)."""
    return sum(2 + i for i in range(B))


# Decoded network paths hardcoded in the reference's train driver
# (train.py:75-100). low_level_layer is the dense skip tap for the decoder.
NETWORK_ARCH = {
    2: dict(path=[1, 2, 2, 2, 3, 2, 2, 1, 1, 1, 1, 2], C_index=[5], low_level_layer=0),
    3: dict(path=[1, 2, 3, 2, 2, 3, 2, 3, 2, 3, 2, 3], C_index=[3, 7], low_level_layer=0),
    4: dict(path=[1, 2, 3, 3, 2, 3, 3, 3, 3, 3, 2, 2], C_index=[2, 5, 8], low_level_layer=0),
    "autodeeplab": dict(
        path=[0, 0, 0, 1, 2, 1, 2, 2, 3, 3, 2, 1], C_index=[], low_level_layer=2
    ),
}

# C -> exit layer indices used by the search driver (search.py:81-88).
SEARCH_C_INDEX = {2: [5], 3: [3, 7], 4: [2, 5, 8]}


def load_genotype(path: str) -> np.ndarray:
    """Load a (k, 2) [edge, op] genotype .npy (e.g. searched_arch/*/genotype*.npy)."""
    g = np.load(path)
    if g.ndim != 2 or g.shape[1] != 2:
        raise ValueError(f"bad genotype shape {g.shape}")
    return g.astype(np.int64)


# The shipped searched cell (searched_arch/autodeeplab/genotype.npy).
AUTODEEPLAB_GENOTYPE = np.array(
    [
        [0, 7],
        [1, 4],
        [2, 4],
        [3, 6],
        [5, 4],
        [8, 4],
        [11, 5],
        [13, 5],
        [19, 7],
        [18, 5],
    ],
    dtype=np.int64,
)
