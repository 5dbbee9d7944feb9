"""Named supernet constructors mirroring the reference model classes
(models/path_supernet.py of the JAX package).

ModelSearch             → modeling/model_search.py Model_search (cell+path
                          search, two exit stations with per-station heads)
ModelNetSearch          → modeling/model_net_search.py Model_net_search
                          (path-only search with fixed cells, C_index exits,
                          shared heads)
ModelBaselinePathSearch → modeling/model_baseline_path_search.py
                          Model_layer_search_baseline (path-only, one fixed
                          early exit, shared heads, NON-dense trellis)
"""
from __future__ import annotations

from typing import Sequence

from .cell import as_genotype_rows
from .supernet import TrellisSupernet


def ModelSearch(num_classes: int, num_layers: int = 12, F: int = 8, B: int = 5, exit_layer: int = 5,
                **kw) -> TrellisSupernet:
    return TrellisSupernet(num_classes, num_layers, F, B, cell_kind="mixed", exit_layers_cfg=(exit_layer,),
                           shared_exit_heads=False, **kw)


def ModelNetSearch(num_classes: int, cell_arch, num_layers: int = 12, F: int = 8, B: int = 5,
                   C_index: Sequence[int] = (5,), **kw) -> TrellisSupernet:
    return TrellisSupernet(num_classes, num_layers, F, B, cell_kind="fixed", genotype=as_genotype_rows(cell_arch),
                           exit_layers_cfg=tuple(int(c) for c in C_index), shared_exit_heads=True, **kw)


def ModelBaselinePathSearch(num_classes: int, cell_arch, num_layers: int = 12, F: int = 8, B: int = 5,
                            exit_layer: int = 5, **kw) -> TrellisSupernet:
    return TrellisSupernet(num_classes, num_layers, F, B, cell_kind="fixed", genotype=as_genotype_rows(cell_arch),
                           exit_layers_cfg=(exit_layer,), shared_exit_heads=True, dense=False, **kw)
