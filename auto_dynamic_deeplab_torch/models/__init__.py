from .cell import FixedCell, as_genotype_rows, edge_op_assignment
from .decoded import ADD, EDM, AutoDeepLab, BaselineModel, DecodedNet

__all__ = [
    "ADD",
    "AutoDeepLab",
    "BaselineModel",
    "DecodedNet",
    "EDM",
    "FixedCell",
    "as_genotype_rows",
    "edge_op_assignment",
]
