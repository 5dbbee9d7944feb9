from .aspp import ASPPLite, ASPPSearch, ASPPTrain
from .confidence import confidence_max, normalized_shannon_entropy
from .heads import DecoderHead, LowLevelConv
from .norm import BatchNorm
from .primitives import (
    OPS,
    Conv2d,
    Dense,
    DilConv,
    DoubleFactorizedReduce,
    FactorizedReduce,
    Identity,
    Pool,
    ReLUConvBN,
    SepConv,
    Zero,
)
from .resize import resize_bilinear, resize_bilinear_cl, scale_dimension, scale_dimension_search

__all__ = [
    "ASPPLite",
    "ASPPSearch",
    "ASPPTrain",
    "BatchNorm",
    "Conv2d",
    "DecoderHead",
    "Dense",
    "DilConv",
    "DoubleFactorizedReduce",
    "FactorizedReduce",
    "Identity",
    "LowLevelConv",
    "OPS",
    "Pool",
    "ReLUConvBN",
    "SepConv",
    "Zero",
    "confidence_max",
    "normalized_shannon_entropy",
    "resize_bilinear",
    "resize_bilinear_cl",
    "scale_dimension",
    "scale_dimension_search",
]
