"""K2: fused softmax-entropy + argmax over class logits, in Triton.

Replaces auto_dynamic_deeplab_tpu/kernels/confidence.py::entropy_argmax_pallas.
One pass over the logits returns the per-image normalized Shannon entropy
(the mean over pixels of -Σ p log p, divided by log C) and the per-pixel
argmax (first maximal index on ties, as torch.argmax and jnp.argmax).

Bound on an H100 SXM at (1, 19, 1025, 2049): the pass is memory-bound —
80 MB of bf16 logits (160 MB fp32) read once plus 8 MB of int32 argmax
written: 26 us in bf16, 50 us in fp32 at 3.35 TB/s. The arithmetic
(a max, 19 exps, a log and a few sums per pixel) is far below the card's
rate.

Design: one launch per call, with no memset and no follow-up op. A
persistent grid of ``K2_CONFIG.per_sm`` programs per SM (``plan``) is
shared among the N images; each program walks its image's blocks of
BLOCK_P pixels with a stride, one pixel a thread at the tuned launch, and
each thread takes its pixel's classes one at a time, twice: the max and
the first-max argmax, then Z = Σ exp(x - m) and the entropy log Z - Σ
e·(x - m) / Z (the block's logits are in L1 by then), summed in
registers. No class is padded and no reduction crosses threads until the
program's end, so the pass costs the same in every layout. A program then
stores its partial sum and takes a ticket from its image's counter (an
acquire-release atomic); the program that takes the last ticket sums the
partials in a fixed order (deterministic, no fp32 atomics), writes the
image's entropy / (H·W) / log(num_classes) and resets the counter. The
partials and counters are allocated once per (device, stream) and reused
(``_scratch``): the kernel leaves the counters at 0, so a CUDA graph
replayed on the stream it was captured on needs no memset. It takes
class-leading (N, C, H, W) and NHWC logits of any memory format whose
pixels are evenly strided (both contiguous layouts and channels_last), at
any N, in fp32 or bf16. Triton is imported only when the kernel launches.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..ops.confidence import normalized_shannon_entropy


class K2Config(NamedTuple):
    block_p: int  # pixels a program takes at a time
    num_warps: int
    per_sm: int  # programs per SM, shared among the images


# tuned on the card (PERF.md §6, scripts/torch_bench_k2.py): one pixel a
# thread, a full SM of threads
K2_CONFIG = K2Config(block_p=256, num_warps=8, per_sm=8)


class K2Plan(NamedTuple):
    programs: int  # per image: grid (programs, N)
    n_blocks: int  # blocks of block_p pixels per image
    r_block: int  # the partials' reduction width: a power of two >= programs


def plan(n: int, hw: int, sm_count: int) -> K2Plan:
    """K2's grid: K2_CONFIG.per_sm programs for each SM, shared among the n
    images, at least one per image and at most one per block."""
    n_blocks = -(-hw // K2_CONFIG.block_p)
    programs = max(1, min(n_blocks, -(-sm_count * K2_CONFIG.per_sm // n)))
    return K2Plan(programs, n_blocks, 1 << (programs - 1).bit_length())


_SCRATCH: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, n: int, programs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partials, counters): at least n * programs fp32 and n int32 zeros,
    kept per (device, stream) and grown when a call needs more. Only a
    call that grows them launches anything (the zeros); the kernel leaves
    its counters at 0, and calls on one stream run in order."""
    parts, counts = _SCRATCH.get((device, stream), (None, None))
    if parts is None or parts.numel() < n * programs or counts.numel() < n:
        grown = max(n * programs, 0 if parts is None else parts.numel())
        parts = torch.empty(grown, dtype=torch.float32, device=device)
        counts = torch.zeros(max(n, 0 if counts is None else counts.numel()), dtype=torch.int32, device=device)
        _SCRATCH[(device, stream)] = parts, counts
    return parts, counts


def scratch_buffers(device: torch.device, stream: int) -> Tuple[torch.Tensor, ...]:
    """The (partials, counters) that K2 launches on ``stream`` use now, or
    () before the first. A CUDA graph captured on ``stream`` bakes these
    buffers in: its owner keeps them referenced, since a later call that
    grows the scratch replaces them here."""
    return _SCRATCH.get((device, stream), ())


def entropy_argmax_reference(
    logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1
):
    """Plain version: (normalized entropy (N,) fp32, argmax (N, H, W) int32)."""
    return (
        normalized_shannon_entropy(logits, num_classes, class_axis),
        logits.argmax(dim=class_axis).to(torch.int32),
    )


def entropy_argmax_triton(
    logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1
):
    """Launch K2 on CUDA ``logits``; same contract as the plain version."""
    if logits.device.type != "cuda":
        raise ValueError(f"entropy_argmax_triton needs a CUDA tensor, got {logits.device}")
    if logits.dim() != 4:
        raise ValueError(f"expected 4-D logits, got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported logits dtype {logits.dtype}")
    if class_axis not in (1, -1, 3):
        raise ValueError(f"class_axis must be 1 or -1, got {class_axis}")
    # (N, C, H, W) or (N, H, W, C) sizes and strides, as (n, c, h, w)
    order = (0, 1, 2, 3) if class_axis == 1 else (0, 3, 1, 2)
    n, c, h, w = (logits.shape[d] for d in order)
    sn, sc, sh, sw = (logits.stride(d) for d in order)
    if sh != w * sw:  # pixels not evenly strided: make them so
        logits = logits.contiguous()
        sn, sc, sh, sw = (logits.stride(d) for d in order)

    from ._entropy_argmax_triton import entropy_argmax_kernel

    dev = logits.device
    k2 = plan(n, h * w, _sm_count(dev))
    parts, counts = _scratch(dev, torch.cuda.current_stream(dev).cuda_stream, n, k2.programs)
    ent = torch.empty((n,), dtype=torch.float32, device=dev)
    arg = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    entropy_argmax_kernel[(k2.programs, n)](
        logits, parts, counts, ent, arg, h * w, c, sn, sw, sc, k2.n_blocks, math.log(num_classes),
        BLOCK_P=K2_CONFIG.block_p, R_BLOCK=k2.r_block, num_warps=K2_CONFIG.num_warps,
    )
    entropy_argmax_triton.launches += 1
    return ent, arg


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


entropy_argmax_triton.launches = 0


def entropy_argmax(logits: torch.Tensor, num_classes: int = 19, class_axis: int = -1):
    """K2 for CUDA logits, the plain version for CPU logits."""
    if logits.device.type == "cuda":
        return entropy_argmax_triton(logits, num_classes, class_axis)
    if logits.device.type == "cpu":
        return entropy_argmax_reference(logits, num_classes, class_axis)
    raise ValueError(f"unsupported device {logits.device}")
