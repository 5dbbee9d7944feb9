from .dynamic import DynamicInferenceEngine
from .edm_trainer import make_edm_dataset, train_edm
from .evaluator import Evaluation
from .loss import SegmentationLosses, cross_entropy, multi_exit_cross_entropy
from .schedules import lr_schedule
from .search_trainer import SearchConfig, SearchTrainer
from .step import SearchSteps, TrainStep, make_arch_optimizer, make_eval_step, make_optimizer
from .trainer import TrainConfig, Trainer

__all__ = [
    "DynamicInferenceEngine", "Evaluation", "SearchConfig", "SearchSteps", "SearchTrainer", "SegmentationLosses",
    "TrainConfig", "TrainStep", "Trainer", "cross_entropy", "lr_schedule", "make_arch_optimizer", "make_edm_dataset",
    "make_eval_step", "make_optimizer", "multi_exit_cross_entropy", "train_edm",
]
