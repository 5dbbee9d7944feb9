from .flops import cost_analysis, count_params, model_complexity
from .initialize import init_params, randomize_bn
from .meters import AverageMeter
from .orbax_reader import is_orbax_checkpoint, read_orbax_checkpoint
from .metrics import Evaluator, confusion_matrix_update
from .profiling import device_time, flops_of, trace
from .restore import copy_state_dict
from .saver import Saver, checkpoint_path, find_latest_checkpoint, restore_checkpoint
from .summaries import TrainingSummary

__all__ = [
    "AverageMeter", "Evaluator", "Saver", "TrainingSummary", "confusion_matrix_update", "copy_state_dict",
    "cost_analysis", "count_params", "device_time", "find_latest_checkpoint", "flops_of", "init_params",
    "model_complexity", "randomize_bn", "restore_checkpoint", "trace",
]
