"""K3-K6: the cell-DAG kernels of the ``--cell-exec flat`` path, host side.

Counterpart of auto_dynamic_deeplab_tpu/kernels/cell_ops.py without the
TPU's flat (C, lane) layout: the kernels (``csrc/cell_ops.cu``, whose note
gives their bound and design) work on the port's states as they are,
NCHW logical in channels_last memory, so one pixel's C channels are
contiguous. This module holds, for each kernel, its plain PyTorch version
(``*_reference``), its ctypes wrapper with a ``launches`` counter, and its
plan (the tile, the shared-memory bytes against 227 KB a block, the
output-channel slice and warp groups):

  K3 ``block_stage``  one DAG block: 1-2 edges (sep, dil, skip), fp32 sum
  K4 ``sep_fused``    one whole SepConv edge (K3's kernel with that edge)
  K5 ``sep_stage``    one dw -> pw -> BN stage (two of them make a SepConv)
  K6 ``dense_stage``  one DilConv edge

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``run_dag`` drives a cell's B blocks
with the route of the JAX package's ``run_dag_flat``: K3 where every
active edge is sep/dil/skip and K3's plan fits, else one op at a time
(pools as plain torch ops, ``none`` as zeros, sep by K4 or else K5 twice,
dil by K6) summed in torch. The JAX package's last-resort XLA fallback is
not carried over: a route that ends in no kernel raises.

Rounding follows the Pallas kernels, not the unfused cell: the depthwise
sum is rounded to the state dtype before the pointwise product, the mid is
ReLU'd and then rounded, the depthwise taps stay fp32, the pointwise and
dense weights are folded with the BN scale in fp32 and then cast, biases
are fp32, and a block's edges are summed in fp32 and rounded once.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nas.genotypes import PRIMITIVES
from ..ops import band
from ..ops.primitives import avg_pool_3x3, max_pool_3x3, weights_key
from ._build import load_library

# op name -> (kind, k, dilation), as _EDGE_KINDS (cell_ops.py:534-540)
EDGE_KINDS = {
    "sep_conv_3x3": ("sep", 3, 1),
    "sep_conv_5x5": ("sep", 5, 1),
    "dil_conv_3x3": ("dil", 3, 2),
    "dil_conv_5x5": ("dil", 5, 2),
    "skip_connect": ("skip", 0, 0),
}
_KIND_CODE = {"skip": 0, "sep": 1, "dil": 2}

SMEM_LIMIT = 232448  # 227 KB: the most shared memory one block may have on Hopper
# The first, CUDA-core K5's tiles, kept as the record of the widths it
# took: the coverage tests of K5 and K6 read them.
STAGE_TILES = ((8, 16), (8, 8), (4, 8), (4, 4))
# K5 (tensor cores): the input channels in chunks of STAGE_CHUNK bytes
# (csrc STAGE_CHUNK), whose A and weight rows are 16 bytes longer, so
# that its shared memory does not grow with C and every width fits its
# 8x8 tile (four warps). A 4x8 tile was never more than 3% faster at
# the flagship widths, and up to 23% slower (PERF.md §6), so the plan
# takes 8x8 only.
SEP_STAGE_TILES = ((8, 8),)
STAGE_CHUNK = 128
# K3/K4 (tensor cores): one warp per 16 tile pixels, 4 of them, times one
# or two warp groups. They recompute SepConv's stage 1 on a k//2 halo, so
# they keep the 8x8 tile (at most 2.25x the stage-1 pixels, for sep5).
BLOCK_TILES = ((8, 8),)
# Registers a thread of K3's kernel holds, by dtype and warp groups (ptxas,
# PERF.md §6): three 128-thread blocks an SM, or one of 256 threads.
BLOCK_REGS = {(torch.float32, 1): 168, (torch.bfloat16, 1): 167,
              (torch.float32, 2): 244, (torch.bfloat16, 2): 239}
# A K3 block's time with one warp group against two, where one block
# fills an SM either way (fitted on the card, PERF.md §6)
ONE_GROUP_SLOWDOWN = 1.3
# K6 (tensor-core implicit GEMM): one warp per 16 tile pixels, at most 4.
# The tiles of 8 and 4 pixels leave part of the mma's 16 rows idle; they
# are kept so that every width the CUDA-core K6 took still has a plan.
DENSE_TILES = ((8, 8), (4, 8), (2, 8), (2, 4), (1, 4))
DENSE_NS_MAX = 40  # output channels a block computes: 5 n8 fragments a warp
SM_COUNT = 132     # the H100's SMs: the grids of K3, K4 and K6 should have at least this many blocks
SM_SMEM = 233472   # shared memory of one H100 SM (228 KB)
# K3's plan model, in fp32 CUDA-core depthwise taps: a tensor-core
# multiply-add (bf16 mma.sync; fp32 as three tf32 mmas at half the bf16
# rate), and a block's fixed cost (copies, barriers and their latencies;
# fitted on the card, PERF.md §6: a level-1 block takes ~47 µs whatever
# its slice, against ~1 µs for each output channel of an fp32 dil5)
TC_COST = {torch.bfloat16: 1 / 8, torch.float32: 3 / 4}
BLOCK_FIXED = 2.0e6
# K5's plan model: a block's fixed cost in the same units (copies and
# barriers; the plans it picks at the flagship widths, the fastest or
# within 3% in the card's sweep, hold for any value from 1e5 to 5e6), and
# the registers a thread of its kernel holds (ptxas, PERF.md §6)
STAGE_FIXED = 5.0e5
STAGE_REGS = {torch.float32: 169, torch.bfloat16: 149}


class Plan(NamedTuple):
    tile: Tuple[int, int]
    smem: int
    ns: int = 0  # K3/K4/K6: output channels a block computes (the N-slice)
    ng: int = 1  # K3/K4/K6: warp groups that split the N-slice's fragments


class SepStageWeights(NamedTuple):
    """One folded dw -> pw -> BN stage (sep_stage_weights, cell_ops.py:846):
    dwk (C, k*k) fp32 depthwise taps; pw (C, O8) the pointwise (O, C) weight
    with the BN scale folded in fp32, cast to the state dtype, transposed
    and zero-padded to O8 = O rounded up to 8; bias (O8,) fp32. packed
    (1, O8, Cpad) holds pw with the input channels innermost, zero-padded
    to Cpad (``dense_cpad``): the tensor cores' B operand as one tap, which
    K3, K4 and K5 read; the plain version reads pw."""

    dwk: torch.Tensor
    pw: torch.Tensor
    bias: torch.Tensor
    k: int
    packed: torch.Tensor


class DenseWeights(NamedTuple):
    """One folded DilConv (dense_stage_weights, cell_ops.py:863): q
    (k*k, C, O8) the (O, k*k*C) conv weight with the BN scale folded in
    fp32, cast to the state dtype, output channels innermost and padded to
    O8; bias (O8,) fp32. packed (k*k, O8, Cpad) holds the same values with
    the input channels innermost, zero-padded to Cpad (``dense_cpad``): the
    tensor cores' B operand, which K3 and K6 read; the plain version reads q."""

    q: torch.Tensor
    bias: torch.Tensor
    k: int
    dil: int
    packed: torch.Tensor


# --------------------------------------------------------------- plans


def _elem_bytes(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the cell kernels take fp32 or bf16 states, not {dtype}")
    return torch.finfo(dtype).bits // 8


def dense_cpad(C: int, dtype: torch.dtype) -> int:
    """The mma layout's input channels, padded to one 32-byte depth step (16 bf16, 8 fp32)."""
    q = 32 // _elem_bytes(dtype)
    return -(-C // q) * q


def _edge_rows(name: str, th: int, tw: int) -> int:
    """Pixels of one edge's working space (csrc edge_rows): a sep edge's
    input window with a 2(k//2) halo plus its stage-1 region, a dil edge's
    window with its dilated halo."""
    kind, k, dil = EDGE_KINDS[name]
    if kind == "sep":
        r = k // 2
        return (th + 4 * r) * (tw + 4 * r) + (th + 2 * r) * (tw + 2 * r)
    if kind == "dil":
        reach = dil * (k // 2)
        return (th + 2 * reach) * (tw + 2 * reach)
    return 0


def _mma_smem(names, C: int, dtype: torch.dtype, th: int, tw: int, ns: int, ng: int = 1) -> int:
    """K3/K4/K6's carve-up (csrc block_smem): the largest edge's space plus
    two stages of ns weight rows, each row Cpad channels and 16 bytes of
    skew; with two edges that have products, K3's stash: 4 fp32 for each
    n8 fragment a thread holds, for each of the block's threads."""
    rows = max(_edge_rows(n, th, tw) for n in names)
    stash = 0
    if sum(EDGE_KINDS[n][0] != "skip" for n in names) > 1:
        threads = -(-th * tw // 16) * ng * 32
        stash = threads * 4 * -(-(ns // 8) // ng) * 4
    return (rows + 2 * ns) * (dense_cpad(C, dtype) * _elem_bytes(dtype) + 16) + stash


def _dense_smem(name: str, C: int, dtype: torch.dtype, th: int, tw: int, ns: int) -> int:
    return _mma_smem((name,), C, dtype, th, tw, ns)


def dense_blocks(plan: Plan, C: int, N: int, H: int, W: int) -> int:
    """The grid of K3, K4 and K6: tiles x images x N-slices."""
    th, tw = plan.tile
    return -(-H // th) * -(-W // tw) * N * (-(-C // 8) * 8 // plan.ns)


def _resident(plan: Plan, regs: int = 0) -> int:
    """Blocks of this plan one SM holds at once, by shared memory (228 KB
    an SM, 1 KB of it reserved a block), threads (2048 an SM) and, given
    the kernel's registers a thread, registers (64K an SM, allocated in
    eights)."""
    threads = -(-plan.tile[0] * plan.tile[1] // 16) * plan.ng * 32
    by_regs = 65536 // (threads * -(-regs // 8) * 8) if regs else 2048 // threads
    return max(1, min(SM_SMEM // (plan.smem + 1024), 2048 // threads, by_regs))


def _slices(C: int):
    """N-slices in order of width: multiples of 8 that divide O8, at most 40."""
    o8 = -(-C // 8) * 8
    return [ns for ns in range(min(o8, DENSE_NS_MAX), 0, -8) if o8 % ns == 0]


@functools.lru_cache(maxsize=None)  # pure, and called on every launch
def plan_dense_stage(name: str, C: int, dtype: torch.dtype, hw: Optional[Tuple[int, int]] = None,
                     N: int = 1) -> Optional[Plan]:
    """K6's plan: tile, N-slice, warp groups and shared memory. Candidates
    run from the largest tile and widest slice down (slices divide O8, so
    the packed weights serve every plan); tiles of fewer than 16 pixels only
    where no other fits. Without ``hw`` the first that fits. With (H, W)
    and batch N, the one with the least modelled time: waves of resident
    blocks times a block's work, taken as its slice plus a fixed cost of 32
    channels (window, per-tap overhead; fitted on the card, PERF.md §6).
    Two warp groups split the slice where fewer than 12 warps would be
    resident on an SM (PERF.md §6: fp32 at C=160, and dil5 at C=80)."""
    if EDGE_KINDS.get(name, ("",))[0] != "dil":
        raise ValueError(f"{name} is not a DilConv")
    fits = [
        Plan((th, tw), smem, ns)
        for th, tw in DENSE_TILES
        for ns in _slices(C)
        if (smem := _dense_smem(name, C, dtype, th, tw, ns)) <= SMEM_LIMIT
    ]
    full = [p for p in fits if p.tile[0] * p.tile[1] % 16 == 0]
    fits = full or fits
    if not fits:
        return None
    if hw is None:
        return fits[0]

    def cost(p: Plan) -> int:
        slots = SM_COUNT * _resident(p)
        return -(-dense_blocks(p, C, N, *hw) // slots) * (p.ns + 32)

    best = min(fits, key=cost)  # the first of equals: larger tile, wider slice
    warps = -(-best.tile[0] * best.tile[1] // 16) * _resident(best)
    return best._replace(ng=2) if best.ns >= 16 and warps < 12 else best


def block_cost(names, C: int, dtype: torch.dtype, th: int, tw: int, ns: int) -> float:
    """Modelled work of one K3 block, in fp32 depthwise taps: a fixed
    BLOCK_FIXED, a sep edge's two depthwise passes (stage 1 on the tile
    plus a k//2 halo), its pw1 over that region for every output channel
    and its pw2 over the slice; a dil edge's k*k taps over the slice. A
    tensor-core multiply-add counts TC_COST[dtype] taps."""
    o8, cpad, tc = -(-C // 8) * 8, dense_cpad(C, dtype), TC_COST[dtype]
    work = BLOCK_FIXED
    for name in names:
        kind, k, _ = EDGE_KINDS[name]
        if kind == "sep":
            halo = (th + 2 * (k // 2)) * (tw + 2 * (k // 2))
            work += (halo + th * tw) * C * k * k + tc * (halo * o8 + th * tw * ns) * cpad
        elif kind == "dil":
            work += tc * k * k * th * tw * ns * cpad
    return work


@functools.lru_cache(maxsize=None)  # pure, and called on every launch
def _plan_block(names: Tuple[str, ...], C: int, dtype: torch.dtype, hw, N: int) -> Optional[Plan]:
    if not names or len(names) > 2 or any(n not in EDGE_KINDS for n in names):
        return None
    sep = any(EDGE_KINDS[n][0] == "sep" for n in names)

    def warps(p: Plan) -> int:  # resident on an SM
        return _resident(p, BLOCK_REGS[dtype, p.ng]) * p.tile[0] * p.tile[1] // 16 * p.ng

    fits = []
    for th, tw in BLOCK_TILES:
        for ns in _slices(C):
            by_ng = [
                Plan((th, tw), smem, ns, ng) for ng in (2, 1)
                # the depthwise gives each thread one channel pair
                if not (sep and dense_cpad(C, dtype) // 2 > th * tw // 16 * ng * 32)
                and (smem := _mma_smem(names, C, dtype, th, tw, ns, ng)) <= SMEM_LIMIT
            ]
            if by_ng:  # one group only where more of its warps are resident
                fits.append(max(by_ng, key=warps))
    if not fits or hw is None:
        return fits[0] if fits else None

    def cost(p: Plan) -> float:
        waves = -(-dense_blocks(p, C, N, *hw) // (SM_COUNT * _resident(p, BLOCK_REGS[dtype, p.ng])))
        return waves * block_cost(names, C, dtype, *p.tile, p.ns) * (ONE_GROUP_SLOWDOWN if p.ng == 1 else 1)

    return min(fits, key=cost)  # the first of equals: the wider slice


def plan_block(names: Sequence[str], C: int, dtype: torch.dtype, hw: Optional[Tuple[int, int]] = None,
               N: int = 1) -> Optional[Plan]:
    """K3's plan for a block of these active edges: tile, N-slice, warp
    groups and shared memory (the largest edge's space, edges running one
    after another, plus the weight stages). None when an edge is not
    sep/dil/skip or nothing fits. Without ``hw`` the widest slice that
    fits; with (H, W) and batch N, the one with the least modelled time:
    waves of resident blocks (registers included) times ``block_cost``,
    times ONE_GROUP_SLOWDOWN for one warp group. Every slice recomputes a
    sep edge's stage 1, so a narrower slice buys blocks with work. Each
    slice takes one warp group where that leaves more warps resident on
    an SM (three 128-thread blocks against one of 256), else two."""
    _elem_bytes(dtype)
    return _plan_block(tuple(names), C, dtype, None if hw is None else tuple(hw), N)


def plan_sep_fused(name: str, C: int, dtype: torch.dtype, hw: Optional[Tuple[int, int]] = None,
                   N: int = 1) -> Optional[Plan]:
    """K4's plan: K3's for the one sep edge."""
    if EDGE_KINDS.get(name, ("",))[0] != "sep":
        raise ValueError(f"{name} is not a SepConv")
    return plan_block((name,), C, dtype, hw, N)


def _stage_smem(name: str, th: int, tw: int, ns: int) -> int:
    """K5's carve-up (csrc stage_smem): two stages of a chunk's raw window
    (tile plus a k//2 halo, STAGE_CHUNK bytes a pixel) and of its ns weight
    rows, and the chunk's A rows (the tile's depthwise output); A and
    weight rows are STAGE_CHUNK + 16 bytes. The same in both dtypes."""
    r, pitch = EDGE_KINDS[name][1] // 2, STAGE_CHUNK + 16
    return 2 * ((th + 2 * r) * (tw + 2 * r) * STAGE_CHUNK + ns * pitch) + th * tw * pitch


def stage_cost(name: str, C: int, dtype: torch.dtype, th: int, tw: int, ns: int) -> float:
    """Modelled work of one K5 block, in fp32 depthwise taps: a fixed
    STAGE_FIXED, the depthwise over the tile for all C input channels
    (every slice recomputes it) and the pointwise product over the slice,
    a tensor-core multiply-add counting TC_COST[dtype] taps."""
    k = EDGE_KINDS[name][1]
    return STAGE_FIXED + th * tw * C * k * k + TC_COST[dtype] * th * tw * ns * dense_cpad(C, dtype)


@functools.lru_cache(maxsize=None)  # pure, and called on every launch
def plan_sep_stage(name: str, C: int, dtype: torch.dtype, hw: Optional[Tuple[int, int]] = None,
                   N: int = 1) -> Optional[Plan]:
    """K5's plan: tile, N-slice and shared memory, with one warp group (two
    were slower in the card's sweep: PERF.md §6). Without ``hw`` the
    widest slice; with (H, W) and batch N, the one with the least modelled
    time: waves of resident blocks (registers included) times
    ``stage_cost``. Every slice recomputes the depthwise, so a narrower
    slice buys blocks with work."""
    if EDGE_KINDS.get(name, ("",))[0] != "sep":
        raise ValueError(f"{name} is not a SepConv")
    _elem_bytes(dtype)
    fits = [
        Plan((th, tw), smem, ns)
        for th, tw in SEP_STAGE_TILES
        for ns in _slices(C)
        if (smem := _stage_smem(name, th, tw, ns)) <= SMEM_LIMIT
    ]
    if not fits or hw is None:
        return fits[0] if fits else None

    def cost(p: Plan) -> float:
        waves = -(-dense_blocks(p, C, N, *hw) // (SM_COUNT * _resident(p, STAGE_REGS[dtype])))
        return waves * stage_cost(name, C, dtype, *p.tile, p.ns)

    return min(fits, key=cost)  # the first of equals: the wider slice


# ------------------------------------------------------------- folding


def _fold_sep_stage(dw, pw, bn, dtype) -> SepStageWeights:
    C, k = dw.kernel.shape[0], dw.kernel.shape[-1]
    s, b = bn.folded()
    w = (pw.kernel[:, :, 0, 0].float() * s[:, None]).to(dtype)  # (O, C), scale folded in fp32
    O = w.shape[0]
    o8 = -(-O // 8) * 8
    return SepStageWeights(
        dwk=dw.kernel.detach().float().reshape(C, k * k).contiguous(),
        pw=F.pad(w.t(), (0, o8 - O)).contiguous(),
        bias=F.pad(b.float(), (0, o8 - O)).contiguous(),
        k=k,
        packed=F.pad(w, (0, dense_cpad(C, dtype) - C, 0, o8 - O))[None].contiguous(),
    )


def _fold_dense(conv, bn, dtype) -> DenseWeights:
    O, C, k, _ = conv.kernel.shape
    s, b = bn.folded()
    w = (conv.kernel.float() * s[:, None, None, None]).to(dtype)  # (O, C, k, k)
    o8 = -(-O // 8) * 8
    q = F.pad(w.permute(2, 3, 1, 0).reshape(k * k, C, O), (0, o8 - O))
    packed = F.pad(w.permute(2, 3, 0, 1).reshape(k * k, O, C), (0, dense_cpad(C, dtype) - C, 0, o8 - O))
    return DenseWeights(
        q=q.contiguous(), bias=F.pad(b.float(), (0, o8 - O)).contiguous(), k=k, dil=conv.dilation,
        packed=packed.contiguous(),
    )


def edge_weights(op: nn.Module, name: str, dtype: torch.dtype):
    """The folded weights of one primitive for states of ``dtype``:
    (stage 1, stage 2) SepStageWeights for a SepConv, DenseWeights for a
    DilConv, None otherwise. Kept on the module and folded again only when
    a parameter or BN statistic changed (in place, moved or replaced):
    folding is about ten small launches an edge, on a path whose eager loop
    is bound by its launches."""
    kind = EDGE_KINDS.get(name, ("",))[0]
    if kind not in ("sep", "dil"):
        return None
    key = weights_key(op, dtype)
    cached = getattr(op, "_folded_edge", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        if kind == "sep":
            w = (_fold_sep_stage(op.dw1, op.pw1, op.bn1, dtype),
                 _fold_sep_stage(op.dw2, op.pw2, op.bn2, dtype))
        else:
            w = _fold_dense(op.conv, op.bn, dtype)
    op._folded_edge = (key, w)
    return w


# ------------------------------------------------------ plain versions


def sep_stage_reference(x, w: SepStageWeights, in_relu: bool, out_relu: bool, round_out: bool = True):
    """Plain K5: [ReLU] -> dw k x k (fp32 taps) -> round -> pw (fp32
    accumulation) -> +bias -> [ReLU] -> round (fp32 when not round_out)."""
    dtype, C = x.dtype, x.shape[1]
    if in_relu:
        x = F.relu(x)
    d = F.conv2d(x.float(), w.dwk.view(C, 1, w.k, w.k), padding=w.k // 2, groups=C)
    d = d.to(dtype).float()
    y = F.conv2d(d, w.pw[:, :C].float().t()[:, :, None, None]) + w.bias[:C].view(1, C, 1, 1)
    if out_relu:
        y = F.relu(y)
    return y.to(dtype) if round_out else y


def sep_fused_reference(x, w1: SepStageWeights, w2: SepStageWeights, round_out: bool = True):
    """Plain K4: the two stages, the mid ReLU'd and rounded in between."""
    mid = sep_stage_reference(x, w1, in_relu=True, out_relu=True)
    return sep_stage_reference(mid, w2, in_relu=False, out_relu=False, round_out=round_out)


def dense_stage_reference(x, w: DenseWeights, round_out: bool = True):
    """Plain K6: ReLU -> dense k x k conv at the dilation -> +bias -> round."""
    dtype, C = x.dtype, x.shape[1]
    q = w.q[:, :, :C].float().reshape(w.k, w.k, C, C).permute(3, 2, 0, 1)
    y = F.conv2d(F.relu(x).float(), q, dilation=w.dil, padding=w.dil * (w.k // 2))
    y = y + w.bias[:C].view(1, C, 1, 1)
    return y.to(dtype) if round_out else y


def _edge_reference(x, name: str, w):
    kind = EDGE_KINDS[name][0]
    if kind == "skip":
        return x.float()
    if kind == "sep":
        return sep_fused_reference(x, *w, round_out=False)
    return dense_stage_reference(x, w, round_out=False)


def block_stage_reference(edges):
    """Plain K3: the edges' fp32 outputs summed in fp32, rounded once."""
    acc = None
    for x, name, w in edges:
        y = _edge_reference(x, name, w)
        acc = y if acc is None else acc + y
    return acc.to(edges[0][0].dtype)


# -------------------------------------------------------------- binding


class _Edge(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p), ("img_stride", ctypes.c_longlong),
        ("ps", ctypes.c_int), ("kind", ctypes.c_int), ("k", ctypes.c_int), ("dil", ctypes.c_int),
        ("dwk1", ctypes.c_void_p), ("b1", ctypes.c_void_p),
        ("pk1", ctypes.c_void_p), ("dwk2", ctypes.c_void_p), ("b2", ctypes.c_void_p),
        ("pk2", ctypes.c_void_p),
    ]


class _Args(ctypes.Structure):
    _fields_ = [
        ("e", _Edge * 2), ("n_edges", ctypes.c_int), ("in_relu", ctypes.c_int),
        ("out_relu", ctypes.c_int), ("is_bf16", ctypes.c_int), ("out", ctypes.c_void_p),
        ("out_img_stride", ctypes.c_longlong), ("out_ps", ctypes.c_int), ("N", ctypes.c_int),
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("C", ctypes.c_int), ("O8", ctypes.c_int),
        ("th", ctypes.c_int), ("tw", ctypes.c_int), ("smem", ctypes.c_int), ("ns", ctypes.c_int),
        ("ng", ctypes.c_int),
    ]


_ENTRY = {"block": "add_cell_block", "sep_fused": "add_cell_sep_fused",
          "sep_stage": "add_cell_sep_stage", "dense_stage": "add_cell_dense_stage"}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """``csrc/cell_ops.cu``, built at first use, with its C interface declared."""
    lib = load_library("cell_ops")
    args_p = ctypes.POINTER(_Args)
    for fn in _ENTRY.values():
        getattr(lib, fn).argtypes = [args_p, ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.add_cell_smem_bytes.argtypes = [ctypes.c_int, args_p]
    lib.add_cell_smem_bytes.restype = ctypes.c_longlong
    lib.add_cell_args_size.argtypes = []
    lib.add_cell_args_size.restype = ctypes.c_int
    lib.add_cell_error_string.argtypes = [ctypes.c_int]
    lib.add_cell_error_string.restype = ctypes.c_char_p
    return lib


def _pixel_layout(t: torch.Tensor, like: torch.Tensor, what: str) -> Tuple[int, int]:
    """(image stride, pixel stride) of a channels_last state, which may be a
    channel slice of a wider buffer; raises on any other layout."""
    if t.device != like.device or t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(
            f"{what}: {tuple(t.shape)} {t.dtype} on {t.device} does not match "
            f"{tuple(like.shape)} {like.dtype} on {like.device}"
        )
    _, C, H, W = t.shape
    sn, sc, sh, sw = t.stride()
    if (C > 1 and sc != 1) or sw < C or (H > 1 and sh != W * sw):
        raise ValueError(
            f"{what}: strides {t.stride()} are not channels_last (channels contiguous, "
            "pixels evenly spaced); the cell kernels take channels_last states"
        )
    return sn, sw


def _check_state(x: torch.Tensor, fn: str):
    if x.device.type != "cuda":
        raise ValueError(f"{fn} launches a CUDA kernel; got a tensor on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{fn}: expected an (N, C, H, W) state, got {tuple(x.shape)}")
    _elem_bytes(x.dtype)


def _check_weights(tensors, x: torch.Tensor, fn: str):
    for t in tensors:
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: weights must be contiguous, 16-byte aligned, on {x.device}")


def _fill_edge(e: _Edge, x: torch.Tensor, name: str, w, like: torch.Tensor, fn: str):
    """One edge's source and weights: a sep edge's ``w`` is its stages
    (both for K3/K4, the one to run for K5), a dil edge's DenseWeights.
    Taps and biases are fp32, the packed pointwise and dense weights the
    state dtype."""
    kind, k, dil = EDGE_KINDS[name]
    e.img_stride, e.ps = _pixel_layout(x, like, f"{fn} source")
    e.src, e.kind, e.k, e.dil = x.data_ptr(), _KIND_CODE[kind], k, dil
    C, o8, f32 = like.shape[1], -(-like.shape[1] // 8) * 8, torch.float32
    cpad = dense_cpad(C, like.dtype)
    if kind == "sep":
        for i, st in enumerate(w, start=1):
            shapes = tuple(st.dwk.shape), tuple(st.pw.shape), tuple(st.bias.shape), tuple(st.packed.shape)
            dtypes = st.dwk.dtype, st.pw.dtype, st.bias.dtype, st.packed.dtype
            if st.k != k or shapes != ((C, k * k), (C, o8), (o8,), (1, o8, cpad)) or \
                    dtypes != (f32, like.dtype, f32, like.dtype):
                raise ValueError(f"{fn}: {name} stage-{i} weights do not fit C={C} {like.dtype}")
            _check_weights((st.dwk, st.pw, st.bias, st.packed), like, fn)
            setattr(e, f"dwk{i}", st.dwk.data_ptr())
            setattr(e, f"b{i}", st.bias.data_ptr())
            setattr(e, f"pk{i}", st.packed.data_ptr())
    elif kind == "dil":
        packed = (k * k, o8, cpad)
        if (w.k, w.dil) != (k, dil) or tuple(w.q.shape) != (k * k, C, o8) or tuple(w.bias.shape) != (o8,) \
                or tuple(w.packed.shape) != packed or (w.q.dtype, w.packed.dtype, w.bias.dtype) != \
                (like.dtype, like.dtype, f32):
            raise ValueError(f"{fn}: {name} weights do not fit C={C} {like.dtype}")
        _check_weights((w.bias, w.packed), like, fn)
        e.b1, e.pk1 = w.bias.data_ptr(), w.packed.data_ptr()


def _launch(entry: str, like: torch.Tensor, edges, plan: Plan, out: torch.Tensor,
            in_relu: bool = False, out_relu: bool = False):
    a = _Args()
    for e, (x, name, w) in zip(a.e, edges):
        _fill_edge(e, x, name, w, like, entry)
    N, C, H, W = like.shape
    a.n_edges, a.in_relu, a.out_relu = len(edges), int(in_relu), int(out_relu)
    a.is_bf16 = int(like.dtype == torch.bfloat16)
    a.out_img_stride, a.out_ps = _pixel_layout(out, like, f"{entry} output")
    a.out = out.data_ptr()
    a.N, a.H, a.W, a.C, a.O8 = N, H, W, C, -(-C // 8) * 8
    (a.th, a.tw), a.smem, a.ns, a.ng = plan.tile, plan.smem, plan.ns, plan.ng
    lib = library()
    rc = getattr(lib, _ENTRY[entry])(ctypes.byref(a), torch.cuda.current_stream(like.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"cell kernel {entry} failed to launch: CUDA error {rc} "
            f"({lib.add_cell_error_string(rc).decode()})"
        )


def _new_state(like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like, memory_format=torch.channels_last)


def _no_plan(fn: str, what: str, C: int, dtype) -> ValueError:
    return ValueError(f"{fn}: no tile of {what} fits {SMEM_LIMIT} bytes of shared memory at C={C} {dtype}")


# ------------------------------------------------------------- wrappers


def block_stage(edges, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. ``edges``: 1-2 (state, op name, edge_weights) of one block, all
    states of one shape and dtype. Returns their sum, written into ``out``
    (e.g. a channel slice of the cell's concat buffer) when given."""
    x0 = edges[0][0]
    if x0.device.type == "cpu":
        y = block_stage_reference(edges)
        return y if out is None else out.copy_(y)
    _check_state(x0, "block_stage")
    names = [name for _, name, _ in edges]
    N, C, H, W = x0.shape
    plan = plan_block(names, C, x0.dtype, (H, W), N)
    if plan is None:
        raise _no_plan("block_stage", names, x0.shape[1], x0.dtype)
    out = _new_state(x0) if out is None else out
    _launch("block", x0, edges, plan, out)
    block_stage.launches += 1
    return out


def sep_fused(x: torch.Tensor, name: str, w) -> torch.Tensor:
    """K4: a whole SepConv ``name`` with weights ``w`` = (stage 1, stage 2)."""
    if x.device.type == "cpu":
        return sep_fused_reference(x, *w)
    _check_state(x, "sep_fused")
    N, C, H, W = x.shape
    plan = plan_sep_fused(name, C, x.dtype, (H, W), N)
    if plan is None:
        raise _no_plan("sep_fused", name, x.shape[1], x.dtype)
    out = _new_state(x)
    _launch("sep_fused", x, [(x, name, w)], plan, out)
    sep_fused.launches += 1
    return out


def sep_stage(x: torch.Tensor, name: str, w: SepStageWeights, in_relu: bool, out_relu: bool) -> torch.Tensor:
    """K5: one stage of the SepConv ``name``."""
    if x.device.type == "cpu":
        return sep_stage_reference(x, w, in_relu, out_relu)
    _check_state(x, "sep_stage")
    N, C, H, W = x.shape
    plan = plan_sep_stage(name, C, x.dtype, (H, W), N)
    if plan is None:
        raise _no_plan("sep_stage", name, x.shape[1], x.dtype)
    out = _new_state(x)
    _launch("sep_stage", x, [(x, name, (w,))], plan, out, in_relu, out_relu)
    sep_stage.launches += 1
    return out


def dense_stage(x: torch.Tensor, name: str, w: DenseWeights) -> torch.Tensor:
    """K6: the DilConv ``name``."""
    if x.device.type == "cpu":
        return dense_stage_reference(x, w)
    _check_state(x, "dense_stage")
    N, C, H, W = x.shape
    plan = plan_dense_stage(name, C, x.dtype, (H, W), N)
    if plan is None:
        raise _no_plan("dense_stage", name, x.shape[1], x.dtype)
    out = _new_state(x)
    _launch("dense_stage", x, [(x, name, w)], plan, out)
    dense_stage.launches += 1
    return out


for _fn in (block_stage, sep_fused, sep_stage, dense_stage):
    _fn.launches = 0


# ---------------------------------------------------------- DAG runner


def dag_blocks(assignment, B: int) -> List[List[Tuple[int, int, int]]]:
    """Per block, its selected edges as (state index, op index, primitive
    index) in ascending edge order: ops are consumed in that order, as
    run_dag_flat (cell_ops.py:1008-1014) does."""
    selected = dict(assignment)
    blocks, op_i, offset = [], 0, 0
    for b in range(B):
        rows = []
        for j in range(2 + b):
            if offset + j in selected:
                rows.append((j, op_i, selected[offset + j]))
                op_i += 1
        blocks.append(rows)
        offset += 2 + b
    return blocks


def block_route(names: Sequence[str], C: int, dtype: torch.dtype) -> Tuple[str, ...]:
    """The kernels one block launches, in order: ("block_stage",) when K3
    takes it, else one entry per conv op of the per-op branch
    ("sep_fused", "sep_stage" twice, "dense_stage"); pools, skip and none
    launch none of them. Raises where a conv op has no kernel that fits."""
    active = [n for n in names if n != "none"]
    if active and all(n in EDGE_KINDS for n in active) and plan_block(active, C, dtype) is not None:
        return ("block_stage",)
    route = []
    for n in active:
        kind = EDGE_KINDS.get(n, ("pool",))[0]
        if kind == "sep":  # K5's shared memory does not grow with C: it takes every width
            route += ["sep_fused"] if plan_sep_fused(n, C, dtype) is not None else ["sep_stage", "sep_stage"]
        elif kind == "dil":
            if plan_dense_stage(n, C, dtype) is None:
                raise _no_plan("run_dag", n, C, dtype)
            route.append("dense_stage")
    return tuple(route)


def dag_launches(assignment, B: int, C: int, dtype: torch.dtype, primitives=PRIMITIVES) -> Counter:
    """Kernel launches of one cell's DAG at width C in ``dtype``."""
    count = Counter()
    for rows in dag_blocks(assignment, B):
        count.update(block_route([primitives[p] for _, _, p in rows], C, dtype))
    return count


def _per_op(x: torch.Tensor, name: str, op: nn.Module) -> torch.Tensor:
    if name == "none":
        return torch.zeros_like(x)
    if name == "skip_connect":
        return x
    if name == "max_pool_3x3":
        return max_pool_3x3(x, 1)
    if name == "avg_pool_3x3":
        return avg_pool_3x3(x, 1)
    kind = EDGE_KINDS[name][0]
    w = edge_weights(op, name, x.dtype)
    if kind == "dil":
        return dense_stage(x, name, w)
    if plan_sep_fused(name, x.shape[1], x.dtype) is not None:
        return sep_fused(x, name, w)
    mid = sep_stage(x, name, w[0], in_relu=True, out_relu=True)
    return sep_stage(mid, name, w[1], in_relu=False, out_relu=False)


def _run_block(xs, names: Sequence[str], ops: Sequence[nn.Module], dst: torch.Tensor, start: int = 0):
    """One block of ``run_dag`` on its input states ``xs`` (windows of
    rows from ``start`` on, or the states themselves), written into
    ``dst``: K3 where its route says so, else op by op summed in torch."""
    C, h = dst.shape[1], dst.shape[2]
    whole = not xs or xs[0].shape[2] == h
    if block_route(names, C, dst.dtype) == ("block_stage",):
        edges = [(x, n, edge_weights(op, n, x.dtype)) for x, n, op in zip(xs, names, ops) if n != "none"]
        if whole:
            block_stage(edges, out=dst)
        else:
            dst.copy_(block_stage(edges)[:, :, start:start + h])
        return
    outs = [_per_op(x, n, op) for x, n, op in zip(xs, names, ops)]
    total = outs[0] if outs else torch.zeros_like(xs[0] if xs else dst)
    for o in outs[1:]:
        total = total + o
    dst.copy_(total if whole else total[:, :, start:start + h])


def run_dag(s0: torch.Tensor, s1: torch.Tensor, assignment, B: int, ops: Sequence[nn.Module],
            primitives=PRIMITIVES) -> torch.Tensor:
    """A cell's B-block DAG (run_dag_flat, cell_ops.py:985) over the states
    s0, s1 (N, C, H, W) and the cell's ops in ascending edge order. Returns
    the channel concat of the B block states, (N, B*C, H, W) channels_last:
    each block is written into its channel slice, and later blocks read
    their inputs from there. On row bands (spatial sharding) each block
    runs on a window of global rows around the band (``band.block_windows``)
    and keeps the band's rows; a rank without rows at this level launches
    nothing but still fetches."""
    banded = band.is_band(s1)
    if banded:
        rows, bands = s1.rows, s1.bands
        if not band.is_band(s0) or (s0.rows, s0.row_dim, s1.row_dim) != (rows, 2, 2):
            raise ValueError("run_dag on bands: s0 and s1 must be NCHW bands of the same rows")
        s0, s1 = band.local(s0), band.local(s1)
    N, C, H, W = s1.shape
    # the preprocess 1x1s hand over channels_last states: no copy for them
    states = [s.contiguous(memory_format=torch.channels_last) for s in (s0, s1)]
    concat = torch.empty((N, H, W, B * C), dtype=s1.dtype, device=s1.device).permute(0, 3, 1, 2)
    for b, block in enumerate(dag_blocks(assignment, B)):
        dst = concat[:, b * C:(b + 1) * C]
        names = [primitives[p] for _, _, p in block]
        xs, start = [states[j] for j, _, _ in block], 0
        if banded:
            xs, start = band.block_windows(xs, rows, bands, names)
        if H > 0:
            _run_block(xs, names, [ops[i] for _, i, _ in block], dst, start)
        states.append(dst)
    return band.wrap(concat, rows, bands) if banded else concat
