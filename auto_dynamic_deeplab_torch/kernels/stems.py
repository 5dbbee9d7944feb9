"""K1: the three ADD stems as one hand-written CUDA kernel (``csrc/stems.cu``).

Replaces auto_dynamic_deeplab_tpu/kernels/stems.py::fused_stems. The source
note in ``csrc/stems.cu`` gives the kernel's bound and design. This module
holds its plain PyTorch version (``stems_reference``), the weights packed
for the tensor cores (``stem_weights``, folded once per module), the
plan (``plan_stems``: the s1 tile and the shared memory it needs) and the
ctypes wrapper (``fused_stems``). ``models.decoded._Stems.forward`` is the
one place that chooses between them: the kernel for a CUDA tensor, the
plain version for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.primitives import weights_key
from ._build import load_library
from .cell_ops import SM_COUNT, SM_SMEM, SMEM_LIMIT  # the H100's SMs and shared memory

WARPS = 8            # a block's warps; stem1's take two 16-pixel fragments each
K0 = 32              # stem0's depth: 27 (kh, kw, ci) products and 5 zeros
# s1 tiles (rows, columns) in order of preference. 7 x 8 puts (2*7+1) x
# (2*8+1) = 255 ReLU(s0) pixels, 16 fragments, on 8 warps in one pass
# (1.14x the owned s0 pixels), and its 56 s1 pixels on 2 fragment pairs
# x 4 channel groups; in bf16 two blocks share an SM.
STEM_TILES = ((7, 8), (8, 8), (4, 16), (4, 8), (2, 8))
# blocks an SM holds by the kernel's launch bounds: two in bf16, one in fp32
MAX_RESIDENT = {torch.bfloat16: 2, torch.float32: 1}
# a block's fixed cost (image reads, epilogues, barriers) in the plan
# model, in units of one warp's 16 x 64 product over one K = 64 tap
BLOCK_FIXED = 8.0


class StemWeights(NamedTuple):
    """The stems folded for K1: each conv's weight times its BN scale, in
    fp32, then cast to the storage dtype, packed (tap, out, in) with the
    input channels innermost (the tensor cores' B operand): pk0 (1, 64, 32)
    with stem0's inputs in (kh, kw, ci) order and 5 zeros, pk1 (9, 64, 64),
    pk2 (9, 128, 64), taps in (kh, kw) order; b0, b1, b2 the folded BN
    biases, fp32."""

    pk0: torch.Tensor
    b0: torch.Tensor
    pk1: torch.Tensor
    b1: torch.Tensor
    pk2: torch.Tensor
    b2: torch.Tensor


class StemPlan(NamedTuple):
    tile: Tuple[int, int]  # s1 rows and columns a block owns
    smem: int              # the carve-up's bytes (csrc stem_layout)
    resident: int          # blocks an SM holds


class _StemArgs(ctypes.Structure):
    """Mirrors ``StemArgs`` of csrc/stems.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "pk0", "pk1", "pk2", "b0", "b1", "b2", "s0", "s1")] + [
        (name, ctypes.c_int) for name in ("N", "H", "W", "x_is_bf16", "is_bf16", "tq", "tw", "smem")
    ]


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


# ------------------------------------------------------------------ plan


def _elem_bytes(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K1 stores fp32 or bf16, not {dtype}")
    return torch.finfo(dtype).bits // 8


def stem_smem(tq: int, tw: int, dtype: torch.dtype) -> int:
    """K1's carve-up (csrc stem_layout): the a0 window or stem2's two
    stages of 128 weight rows, the ReLU(s0) window (rows of 2 tw + 2
    pixels, columns by parity) or stem0's im2col, and two stages of 64
    weight rows; each row its channels plus 16 bytes of skew."""
    eb = _elem_bytes(dtype)
    pb, pb0 = 64 * eb + 16, K0 * eb + 16
    r0, c0, r1 = 2 * tq + 3, 2 * tw + 3, 2 * tq + 1
    return max(r0 * c0 * pb, 256 * pb) + max(r1 * (2 * tw + 2) * pb, r0 * c0 * pb0) + 128 * pb


def stem_blocks(tile: Tuple[int, int], n: int, h: int, w: int) -> int:
    """K1's grid for an (N, 3, h, w) input: s1 tiles x images."""
    h1, w1 = _conv_out(_conv_out(h)), _conv_out(_conv_out(w))
    return -(-h1 // tile[0]) * -(-w1 // tile[1]) * n


def stem_block_cost(tq: int, tw: int) -> float:
    """Modelled time of one block, in one warp's 32 x 64 product over a
    K = 64 tap: stem0 (16 x 64, K = 32: a quarter) in passes of WARPS
    fragments, stem1 (9 taps) in passes of WARPS fragment pairs, stem2 (9
    taps of 32 x 32 a warp) in one, plus BLOCK_FIXED."""
    passes0 = -(-(-(-(2 * tq + 3) * (2 * tw + 3) // 16)) // WARPS)
    passes1 = -(-(-(-(-(-(2 * tq + 1) * (2 * tw + 1) // 16)) // 2)) // WARPS)
    return passes0 * 0.25 + passes1 * 9 + 4.5 + BLOCK_FIXED


@functools.lru_cache(maxsize=None)  # pure, and called on every launch
def plan_stems(dtype: torch.dtype, hw: Optional[Tuple[int, int]] = None, n: int = 1) -> StemPlan:
    """K1's tile: of STEM_TILES that fit 227 KB, the first without ``hw``;
    with (H, W) and batch n, the one with the least modelled time (waves
    of resident blocks, by shared memory and launch bounds, times
    ``stem_block_cost``; the first of equals)."""
    fits = []
    for tq, tw in STEM_TILES:
        smem = stem_smem(tq, tw, dtype)
        if smem <= SMEM_LIMIT and tq * tw <= 64:
            fits.append(StemPlan((tq, tw), smem, min(MAX_RESIDENT[dtype], SM_SMEM // (smem + 1024))))
    if not fits:
        raise ValueError(f"no K1 tile fits for {dtype}")
    if hw is None:
        return fits[0]

    def cost(p: StemPlan) -> float:
        waves = -(-stem_blocks(p.tile, n, *hw) // (SM_COUNT * p.resident))
        return waves * stem_block_cost(*p.tile)

    return min(fits, key=cost)


# --------------------------------------------------------------- weights


def _pack(conv, bn, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(taps, out, in) weights with the BN scale folded in fp32, cast to
    ``dtype``, and the fp32 bias."""
    s, b = bn.folded()
    w = conv.kernel.float() * s[:, None, None, None]  # (out, in, 3, 3)
    o, c = w.shape[:2]
    return w.permute(2, 3, 0, 1).reshape(9, o, c).to(dtype).contiguous(), b.float().contiguous()


def stem_weights(stems, dtype: torch.dtype) -> StemWeights:
    """The stems' weights packed for K1 in ``dtype``. Kept on the module
    and packed again only when a parameter or BN statistic changed (in
    place, moved or replaced): packing is about twenty small launches, on
    every image otherwise."""
    key = weights_key(stems, dtype)
    cached = getattr(stems, "_packed_stems", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        s, b0 = stems.stem0_bn.folded()
        w0 = stems.stem0_conv.kernel.float() * s[:, None, None, None]  # (64, 3, 3, 3)
        pk0 = F.pad(w0.permute(0, 2, 3, 1).reshape(64, 27), (0, K0 - 27))[None]
        pk1, b1 = _pack(stems.stem1_conv, stems.stem1_bn, dtype)
        pk2, b2 = _pack(stems.stem2_conv, stems.stem2_bn, dtype)
        w = StemWeights(pk0.to(dtype).contiguous(), b0.float().contiguous(), pk1, b1, pk2, b2)
    stems._packed_stems = (key, w)
    return w


# --------------------------------------------------------------- wrapper


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points of a built csrc/stems.cu."""
    p = ctypes.POINTER(_StemArgs)
    lib.add_stems_forward.argtypes = [p, ctypes.c_void_p]
    lib.add_stems_forward.restype = ctypes.c_int
    lib.add_stems_smem_bytes.argtypes = [p]
    lib.add_stems_smem_bytes.restype = ctypes.c_longlong
    lib.add_stems_args_size.argtypes = []
    lib.add_stems_args_size.restype = ctypes.c_int
    lib.add_cuda_error_string.argtypes = [ctypes.c_int]
    lib.add_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return bind(load_library("stems"))


def fused_stems(
    x: torch.Tensor, weights: StemWeights, out_dtype: Optional[torch.dtype] = None,
    plan: Optional[StemPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1. x: (N, 3, H, W) CUDA, fp32 or bf16 (any memory format);
    ``weights`` from ``stem_weights`` in ``out_dtype``; ``plan`` from
    ``plan_stems`` (the one for this input when None). Returns s0 (N, 64,
    H0, W0) pre-ReLU and s1 (N, 128, H1, W1), both channels_last, in
    ``out_dtype`` (fp32 when None)."""
    out_dtype = out_dtype or torch.float32
    if x.device.type != "cuda":
        raise ValueError(f"fused_stems needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"expected (N, 3, H, W) images, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    _elem_bytes(out_dtype)
    shapes = {"pk0": (1, 64, K0), "pk1": (9, 64, 64), "pk2": (9, 128, 64), "b0": (64,), "b1": (64,), "b2": (128,)}
    for name, shape in shapes.items():
        t = getattr(weights, name)
        want = torch.float32 if name[0] == "b" else out_dtype
        if tuple(t.shape) != shape or t.dtype != want or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"stem weight {name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want contiguous {shape} {want} on {x.device}")
    n, _, h, w = x.shape
    s0, s1 = _launch(library(), x, weights, out_dtype, plan or plan_stems(out_dtype, (h, w), n))
    fused_stems.launches += 1
    return s0, s1


fused_stems.launches = 0


def _launch(lib: ctypes.CDLL, x: torch.Tensor, weights: StemWeights, out_dtype: torch.dtype, plan: StemPlan):
    """K1 from ``lib`` (the built csrc/stems.cu, or a variant of it) on
    checked arguments."""
    n, _, h, w = x.shape
    h0, w0 = _conv_out(h), _conv_out(w)
    h1, w1 = _conv_out(h0), _conv_out(w0)
    xh = x.permute(0, 2, 3, 1).contiguous()  # NHWC memory; free for channels_last
    s0 = torch.empty((n, h0, w0, 64), dtype=out_dtype, device=x.device)
    s1 = torch.empty((n, h1, w1, 128), dtype=out_dtype, device=x.device)
    args = _StemArgs(
        xh.data_ptr(), *(getattr(weights, k).data_ptr() for k in ("pk0", "pk1", "pk2", "b0", "b1", "b2")),
        s0.data_ptr(), s1.data_ptr(), n, h, w, int(xh.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), *plan.tile, plan.smem,
    )
    rc = lib.add_stems_forward(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"stems kernel launch failed: CUDA error {rc} ({lib.add_cuda_error_string(rc).decode()})"
        )
    return s0.permute(0, 3, 1, 2), s1.permute(0, 3, 1, 2)
