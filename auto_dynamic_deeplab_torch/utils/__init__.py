from .initialize import init_params, randomize_bn
from .meters import AverageMeter
from .metrics import Evaluator, confusion_matrix_update
from .saver import Saver, find_latest_checkpoint, restore_checkpoint
from .summaries import TrainingSummary

__all__ = [
    "AverageMeter", "Evaluator", "Saver", "TrainingSummary", "confusion_matrix_update",
    "find_latest_checkpoint", "init_params", "randomize_bn", "restore_checkpoint",
]
