"""K1's work (the three stems at once): operations and bytes, counted as the
inputs need them, each input byte read once and each output byte written
once (a frozen copy of the port's ``chip_smoke.py::stems_products`` and
``stems_bound``, against published peaks)."""
from __future__ import annotations

from . import peaks


def conv_out(n: int) -> int:
    """Output size of a 3x3, stride-2, padding-1 conv."""
    return (n - 1) // 2 + 1


def flops(h: int, w: int, n: int = 1) -> int:
    """Products of stem0 (27 a pixel and channel: 3x3x3 into 64), stem1
    (3x3x64 into 64) and stem2 (3x3x64 into 128, at stride 4), a
    multiply-add counting 2."""
    h0, w0 = conv_out(h), conv_out(w)
    h1, w1 = conv_out(h0), conv_out(w0)
    return 2 * n * ((27 * 64 + 576 * 64) * h0 * w0 + 576 * 128 * h1 * w1)


def nbytes(h: int, w: int, n: int = 1, elem: int = 4) -> int:
    """The image read (NHWC, 3 channels), s0 (64 channels at stride 2) and
    s1 (128 at stride 4) written, the three kernels and BN terms read."""
    h0, w0 = conv_out(h), conv_out(w)
    h1, w1 = conv_out(h0), conv_out(w0)
    weights = elem * (27 * 64 + 576 * 64 + 576 * 128) + 4 * 2 * (64 + 64 + 128)
    return n * (h * w * 3 * 4 + (h0 * w0 * 64 + h1 * w1 * 128) * elem) + weights


def bound_s(h: int, w: int, dtype: str = "float32", n: int = 1) -> float:
    """The least time one call could take: operations at the tensor-core
    rate of the configuration's precision, or bytes at the HBM rate,
    whichever is larger."""
    elem = 4 if dtype == "float32" else 2
    return max(flops(h, w, n) / peaks.TENSOR_FLOPS[dtype], nbytes(h, w, n, elem) / peaks.BYTES_PER_S)
