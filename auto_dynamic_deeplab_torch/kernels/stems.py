"""K1: the three ADD stems as one hand-written CUDA kernel (``csrc/stems.cu``).

Replaces auto_dynamic_deeplab_tpu/kernels/stems.py::fused_stems. The source
note in ``csrc/stems.cu`` gives the kernel's bound and design. This module
holds its plain PyTorch version (``stems_reference``), the BN folding and
the ctypes wrapper (``fused_stems``). ``models.decoded._Stems.forward`` is
the one place that chooses between them: the kernel for a CUDA tensor, the
plain version for a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import load_library


def _conv_out(n: int) -> int:
    """Output size of k=3 s=2 p=1 (PyTorch conv arithmetic)."""
    return (n - 1) // 2 + 1


def stems_reference(stems, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: conv s2 → BN → ReLU → conv → BN (= s0) → ReLU → conv s2
    → BN (= s1), with the module's own convs and BNs. x: (N, 3, H, W)."""
    x = F.relu(stems.stem0_bn(stems.stem0_conv(x)))
    s0 = stems.stem1_bn(stems.stem1_conv(x))
    s1 = stems.stem2_bn(stems.stem2_conv(F.relu(s0)))
    return s0, s1


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.add_stems_forward.argtypes = [p, i] + [p] * 9 + [p, p, i, i, i, i, p]
    lib.add_stems_forward.restype = i
    lib.add_cuda_error_string.argtypes = [i]
    lib.add_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_weight(w: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """(co, ci, 3, 3) → fp32 [kh][kw][ci][co], rounded to bf16 values under
    the bf16 policy (the reference casts its conv kernels to the policy)."""
    w = w.detach()
    if round_bf16:
        w = w.to(torch.bfloat16)
    return w.float().permute(2, 3, 1, 0).contiguous()


def fused_stems(
    x: torch.Tensor,
    w0: torch.Tensor, bn0_s: torch.Tensor, bn0_b: torch.Tensor,
    w1: torch.Tensor, bn1_s: torch.Tensor, bn1_b: torch.Tensor,
    w2: torch.Tensor, bn2_s: torch.Tensor, bn2_b: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1. x: (N, 3, H, W) CUDA, fp32 or bf16 (any memory format);
    w*: conv weights (co, ci, 3, 3); bn*_s/bn*_b: folded BN (fp32).
    Returns s0 (N, 64, H0, W0) pre-ReLU and s1 (N, 128, H1, W1), both
    channels_last, in ``out_dtype`` (fp32 when None)."""
    out_dtype = out_dtype or torch.float32
    if x.device.type != "cuda":
        raise ValueError(f"fused_stems needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"expected (N, 3, H, W) images, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    for w, ci, co in ((w0, 3, 64), (w1, 64, 64), (w2, 64, 128)):
        if tuple(w.shape) != (co, ci, 3, 3):
            raise ValueError(f"stem weight shape {tuple(w.shape)} != {(co, ci, 3, 3)}")
    n, _, h, w = x.shape
    h0, w0_ = _conv_out(h), _conv_out(w)
    h1, w1_ = _conv_out(h0), _conv_out(w0_)
    bf16 = out_dtype == torch.bfloat16
    xh = x.permute(0, 2, 3, 1).contiguous()  # NHWC memory; free for channels_last
    params = [
        _kernel_weight(w0, bf16), bn0_s.float().contiguous(), bn0_b.float().contiguous(),
        _kernel_weight(w1, bf16), bn1_s.float().contiguous(), bn1_b.float().contiguous(),
        _kernel_weight(w2, bf16), bn2_s.float().contiguous(), bn2_b.float().contiguous(),
    ]
    for t in params:
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError("stem parameters must be 16-byte aligned on the input's device")
    s0 = torch.empty((n, h0, w0_, 64), dtype=out_dtype, device=x.device)
    s1 = torch.empty((n, h1, w1_, 128), dtype=out_dtype, device=x.device)
    lib = _bind(load_library("stems"))
    rc = lib.add_stems_forward(
        xh.data_ptr(), int(xh.dtype == torch.bfloat16),
        *[t.data_ptr() for t in params],
        s0.data_ptr(), s1.data_ptr(), int(bf16), n, h, w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"stems kernel launch failed: CUDA error {rc} "
            f"({lib.add_cuda_error_string(rc).decode()})"
        )
    fused_stems.launches += 1
    return s0.permute(0, 3, 1, 2), s1.permute(0, 3, 1, 2)


fused_stems.launches = 0
