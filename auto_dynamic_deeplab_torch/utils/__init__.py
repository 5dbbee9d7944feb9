from .initialize import init_params, randomize_bn
from .meters import AverageMeter
from .metrics import Evaluator, confusion_matrix_update

__all__ = ["AverageMeter", "Evaluator", "confusion_matrix_update", "init_params", "randomize_bn"]
