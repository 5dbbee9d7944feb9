from .dynamic import DynamicInferenceEngine
from .evaluator import Evaluation

__all__ = ["DynamicInferenceEngine", "Evaluation"]
