from .cell import FixedCell, as_genotype_rows, edge_op_assignment
from .decoded import ADD, EDM, AutoDeepLab, BaselineModel, DecodedNet
from .path_supernet import ModelBaselinePathSearch, ModelNetSearch, ModelSearch
from .supernet import TrellisSupernet, normalize_betas
from .supernet_cell import MixedOp, TrellisCell

__all__ = [
    "ADD",
    "AutoDeepLab",
    "BaselineModel",
    "DecodedNet",
    "EDM",
    "FixedCell",
    "MixedOp",
    "ModelBaselinePathSearch",
    "ModelNetSearch",
    "ModelSearch",
    "TrellisCell",
    "TrellisSupernet",
    "as_genotype_rows",
    "edge_op_assignment",
    "normalize_betas",
]
