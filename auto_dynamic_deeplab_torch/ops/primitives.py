"""NAS primitive op library (ops/primitives.py of the JAX package).

Every module takes NCHW tensors and trains (its BNs follow
``nn.Module.training``). Weights keep the flax names (``kernel``, ``bias``)
in PyTorch layout and stay fp32; with a policy ``dtype`` the operands are
cast to it, as flax does with ``dtype=``, and the gradients flow back
through the casts to the fp32 parameters.
Padding is explicit and symmetric, as in the reference's PyTorch convs.
On a ``band.RowBand`` (spatial sharding) the convs, pools and the shift
take their band rules (``ops/band.py``): halo rows from the other ranks,
padding only past the global edges. A conv with a ``shard`` (channel
tensor parallelism, ``parallel.tensor``) computes only its block of
output channels and gathers the rest.

The 8 primitives (modeling/genotypes.py:5-14) are exposed through ``OPS``:
name -> factory(C, stride, **kw) -> module called as ``op(x)``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import band
from .norm import BatchNorm


def _cast(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]):
    """flax dtype semantics: cast both to ``dtype``, else promote."""
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


class Conv2d(nn.Module):
    """Conv with weight ``kernel`` (out, in/groups, kh, kw)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        groups: int = 1,
        use_bias: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.dtype = dtype
        self.shard = None  # parallel.tensor: this module holds a block of its output channels
        self.kernel = nn.Parameter(
            torch.empty(features, in_features // groups, kernel_size, kernel_size)
        )
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _cast(x, self.kernel, self.dtype)
        b = None if self.bias is None else self.bias.to(w.dtype)
        if self.shard is not None and not band.is_band(x):
            return self.shard.conv2d(self, x, w, b)
        return conv2d(x, w, b, self.stride, self.padding, self.dilation, self.groups)


class Dense(nn.Module):
    """flax nn.Dense: weight ``kernel`` (out, in) in PyTorch layout, bias."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _cast(x, self.kernel, self.dtype)
        return F.linear(x, w, self.bias.to(w.dtype))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with symmetric padding; on a band its band rule."""
    if band.is_band(x):
        return band.conv2d(x, w, b, stride, padding, dilation, groups)
    return F.conv2d(x, w, b, stride, padding, dilation, groups)


def max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """MaxPool2d(3, stride, padding=1): padding never wins the max."""
    if band.is_band(x):
        return band.max_pool_3x3(x, stride)
    return F.max_pool2d(x, 3, stride, 1)


def avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(3, stride, padding=1, count_include_pad=False), summed in fp32."""
    if band.is_band(x):
        return band.avg_pool_3x3(x, stride)
    return F.avg_pool2d(x.float(), 3, stride, 1, count_include_pad=False).to(x.dtype)


class Pool(nn.Module):
    def __init__(self, kind: str, stride: int = 1):
        super().__init__()
        self.kind, self.stride = kind, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "max":
            return max_pool_3x3(x, self.stride)
        return avg_pool_3x3(x, self.stride)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Zero(nn.Module):
    """'none' primitive: zeros (strided slice first if stride > 1)."""

    def __init__(self, stride: int = 1):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride != 1:
            x = x[:, :, :: self.stride, :: self.stride]
        return torch.zeros_like(x)


class ReLUConvBN(nn.Module):
    """ReLU → Conv → BN (modeling/operations.py:18-29)."""

    def __init__(
        self, in_features: int, features: int, kernel_size: int = 1,
        stride: int = 1, padding: int = 0, affine: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, stride, padding, dtype=dtype)
        self.bn = BatchNorm(features, affine=affine, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(F.relu(x)))


class DilConv(nn.Module):
    """ReLU → dilated (dense, not separable) Conv → BN (operations.py:32-43)."""

    def __init__(
        self, in_features: int, features: int, kernel_size: int, stride: int = 1,
        padding: int = 0, dilation: int = 2, affine: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv = Conv2d(
            in_features, features, kernel_size, stride, padding, dilation, dtype=dtype
        )
        self.bn = BatchNorm(features, affine=affine, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(F.relu(x)))


def weights_key(module: nn.Module, dtype: torch.dtype) -> tuple:
    """What a cache of weights derived from ``module`` is valid for: the
    dtype and every parameter's and buffer's storage and version (an
    in-place update, ``load_state_dict`` or a move changes it)."""
    tensors = list(module.parameters()) + list(module.buffers())
    return (dtype, tuple((t.data_ptr(), t.device, -1 if t.is_inference() else t._version) for t in tensors))


def composed_sep_kernel(dw: Conv2d, pw: Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """One separable stage, depthwise(k) then pointwise(1x1) with no
    nonlinearity between them, as ONE dense kxk kernel
    ``K[o, c] = dw[c, 0] * pw[o, c]`` (JAX ops/primitives.py::
    _composed_sep_stage): composed in fp32, cast once to ``dtype``."""
    k = dw.kernel.float()[None, :, 0] * pw.kernel.float()[:, :, 0, 0, None, None]
    return k.to(dtype).contiguous()


class SepConv(nn.Module):
    """ReLU → dw(k,stride) → pw → BN → ReLU → dw(k,1) → pw → BN
    (operations.py:46-62).

    ``dense_form=True`` (eval only) runs each dw→pw pair as one dense kxk
    conv with the composed kernel (``composed_sep_kernel``), kept on the
    module and composed again only when a weight changes. Training and the
    parameters are those of the factored form."""

    def __init__(
        self, in_features: int, features: int, kernel_size: int, stride: int = 1,
        padding: int = 0, affine: bool = True, dtype: Optional[torch.dtype] = None,
        dense_form: bool = False,
    ):
        super().__init__()
        k, c = kernel_size, in_features
        self.dtype, self.dense_form = dtype, dense_form
        self.stride, self.padding = stride, padding
        self.dw1 = Conv2d(c, c, k, stride, padding, groups=c, dtype=dtype)
        self.pw1 = Conv2d(c, features, 1, dtype=dtype)
        self.bn1 = BatchNorm(features, affine=affine, dtype=dtype)
        self.dw2 = Conv2d(features, features, k, 1, padding, groups=features, dtype=dtype)
        self.pw2 = Conv2d(features, features, 1, dtype=dtype)
        self.bn2 = BatchNorm(features, affine=affine, dtype=dtype)

    def composed(self, dtype: torch.dtype):
        """The two stages' composed kernels in ``dtype``, cached per weight
        version."""
        key = weights_key(self, dtype)
        cached = getattr(self, "_composed", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            w = (composed_sep_kernel(self.dw1, self.pw1, dtype),
                 composed_sep_kernel(self.dw2, self.pw2, dtype))
        self._composed = (key, w)
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dense_form and not self.training:
            dt = self.dtype or x.dtype
            k1, k2 = self.composed(dt)
            x = self.bn1(conv2d(F.relu(x).to(dt), k1, None, self.stride, self.padding))
            return self.bn2(conv2d(F.relu(x).to(dt), k2, None, 1, self.padding))
        x = self.bn1(self.pw1(self.dw1(F.relu(x))))
        return self.bn2(self.pw2(self.dw2(F.relu(x))))


def _shift_up_left(x: torch.Tensor, shift: int) -> torch.Tensor:
    """y[i, j] = x[i+shift, j+shift], zero-filled past the edge
    (the reference's pad-then-slice trick, operations.py:94-99)."""
    if band.is_band(x):
        return band.shift_up_left(x, shift)
    return F.pad(x[:, :, shift:, shift:], (0, shift, 0, shift))


class FactorizedReduce(nn.Module):
    """Dual strided 1x1 convs, the second on a ``stride // 2``-shifted input,
    concatenated (operations.py:86-101). ``stride=4`` with a 2px shift is
    DoubleFactorizedReduce (operations.py:104-119)."""

    def __init__(
        self, in_features: int, features: int, affine: bool = True,
        dtype: Optional[torch.dtype] = None, stride: int = 2, shift: Optional[int] = None,
    ):
        super().__init__()
        if features % 2:
            raise ValueError(f"features must be even, got {features}")
        self.shift = stride // 2 if shift is None else shift
        self.conv1 = Conv2d(in_features, features // 2, 1, stride, dtype=dtype)
        self.conv2 = Conv2d(in_features, features // 2, 1, stride, dtype=dtype)
        self.bn = BatchNorm(features, affine=affine, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        y = _shift_up_left(x, self.shift)
        return self.bn(torch.cat([self.conv1(x), self.conv2(y)], dim=1))


def DoubleFactorizedReduce(
    in_features: int, features: int, affine: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> FactorizedReduce:
    """Stride-4 variant with a 2px-shifted second branch."""
    return FactorizedReduce(in_features, features, affine, dtype, stride=4, shift=2)


# name -> factory(C, stride, affine=..., dtype=...) -> module (in = out = C).
# Mirrors the OPS dict at modeling/operations.py:7-16.
OPS: Dict[str, Callable[..., nn.Module]] = {
    "none": lambda C, stride, **kw: Zero(stride=stride),
    "avg_pool_3x3": lambda C, stride, **kw: Pool("avg", stride),
    "max_pool_3x3": lambda C, stride, **kw: Pool("max", stride),
    "skip_connect": lambda C, stride, **kw: Identity(),
    "sep_conv_3x3": lambda C, stride, **kw: SepConv(C, C, 3, stride, 1, **kw),
    "sep_conv_5x5": lambda C, stride, **kw: SepConv(C, C, 5, stride, 2, **kw),
    "dil_conv_3x3": lambda C, stride, **kw: DilConv(C, C, 3, stride, 2, 2, **kw),
    "dil_conv_5x5": lambda C, stride, **kw: DilConv(C, C, 5, stride, 4, 2, **kw),
}
