"""Packed eval-mode execution of the fixed-cell block DAG (ops/packed.py of
the JAX package; ``cli.evaluate --cell-exec packed``).

The DAG is re-scheduled into *waves* of data-ready ops, and each wave's ops
of one kind run as one op over their channel concat:

  * sep convs (3x3 and 5x5 together, the 3x3 depthwise kernels zero-padded
    to 5x5): one grouped depthwise conv over G*C channels, then one
    block-diagonal 1x1 with the eval BN folded into its weights and bias,
    twice (the two sep stages);
  * dil convs (3x3 d2 padded to 5x5 d2: the tap grids nest): one dense
    conv with a block-diagonal kernel, BN folded;
  * pools of a kind: one pool over the concat;
  * skip_connect / none: no compute.

The dense taps' projections (ADD.py:47-52) run as one block-diagonal 1x1
(``packed_relu_conv_bn_1x1``). As in the JAX package this is plain tensor
code (cuDNN convs here): no hand-written kernel computes it. Rounding
follows the JAX package: the folded weights are built in fp32 and cast
once to the compute dtype, and each conv adds its bias in that dtype.
Training keeps the per-op modules (per-op batch statistics). On a row
band (spatial sharding) the convs and pools take their band rules
(``ops/band.py``).

The schedule is static per genotype (host code). The folded weights of a
cell (``wave_weights``, ``pw_group``; the eval BN folded by ``fold_bn``)
are kept by the cell per weight version
(models/cell.py ``FixedCell.packed_weights``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..nas.genotypes import PRIMITIVES
from .primitives import avg_pool_3x3, conv2d, max_pool_3x3

# ---------------------------------------------------------------- schedule


def _block_edges(B: int) -> List[List[int]]:
    """Edge numbers per block: block i consumes edges offset..offset+1+i+1."""
    out, offset = [], 0
    for i in range(B):
        n_states = 2 + i
        out.append(list(range(offset, offset + n_states)))
        offset += n_states
    return out


def _kind(op_name: str) -> str:
    if op_name.startswith("sep_conv"):
        return "sep"
    if op_name.startswith("dil_conv"):
        return "dil"
    if op_name == "max_pool_3x3":
        return "max"
    if op_name == "avg_pool_3x3":
        return "avg"
    if op_name == "skip_connect":
        return "skip"
    return "zero"


def schedule_waves(assignment: Sequence[Tuple[int, int]], B: int):
    """Static wave schedule for a genotype (the JAX package's, verbatim).

    ``assignment``: ((edge, op_index) ...) sorted by edge, the cell's
    edge→op map (models/cell.py edge_op_assignment). Returns a list of
    waves; each wave is a list of groups; each group is
    ``(kind, k, [(block, state, module_idx, op_name), ...])`` where
    ``state`` indexes [s0, s1, b0, ...] and ``module_idx`` indexes the
    cell's sorted-edge op module list.
    """
    blocks = _block_edges(B)
    edge_to_block_state = {}
    for b, edges in enumerate(blocks):
        for j, e in enumerate(edges):
            edge_to_block_state[e] = (b, j)

    ops = []  # (block, state, module_idx, name)
    for idx, (edge, op_idx) in enumerate(assignment):
        b, s = edge_to_block_state[edge]
        ops.append((b, s, idx, PRIMITIVES[op_idx]))

    waves = []
    done = set()
    ready_states = {0, 1}
    block_ops = {b: [o for o in ops if o[0] == b] for b in range(B)}
    while len(done) < len(ops):
        wave_ops = [o for o in ops if o[2] not in done and o[1] in ready_states]
        if not wave_ops:
            raise ValueError("cyclic/unsatisfiable genotype schedule")
        groups: Dict[str, list] = {}
        for o in wave_ops:
            groups.setdefault(_kind(o[3]), []).append(o)
            done.add(o[2])
        wave = []
        for kind, members in groups.items():
            k = 5 if any("5x5" in m[3] for m in members) else 3
            wave.append((kind, k, members))
        waves.append(wave)
        for b in range(B):
            if (2 + b) not in ready_states and all(o[2] in done for o in block_ops[b]):
                ready_states.add(2 + b)
    return waves


# ---------------------------------------------------------------- folding


def fold_bn(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as y = x*scale + bias, both fp32 (C,): the JAX package's
    ``fold_bn`` over a port ``BatchNorm``."""
    return bn.folded()


def _pad_taps(kernel: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad (O, I, kk, kk) taps to (O, I, k, k), centered: exact for
    plain and dilation-2 taps (the grids nest)."""
    p = (k - kernel.shape[-1]) // 2
    return F.pad(kernel, (p, p, p, p)) if p else kernel


def _block_diag(mats: List[torch.Tensor]) -> torch.Tensor:
    """Block-diagonal (ΣO, ΣI, ...) from per-op (O, I, ...) weights."""
    if len(mats) == 1:
        return mats[0]
    rows = sum(m.shape[0] for m in mats)
    cols = sum(m.shape[1] for m in mats)
    out = mats[0].new_zeros((rows, cols, *mats[0].shape[2:]))
    r = c = 0
    for m in mats:
        out[r:r + m.shape[0], c:c + m.shape[1]] = m
        r += m.shape[0]
        c += m.shape[1]
    return out


class SepGroup(NamedTuple):
    """One wave's sep convs: depthwise (G*C, 1, k, k) and block-diagonal
    pointwise (ΣO, G*C, 1, 1) kernels with their folded biases, per stage."""

    dw1: torch.Tensor
    pw1: torch.Tensor
    b1: torch.Tensor
    dw2: torch.Tensor
    pw2: torch.Tensor
    b2: torch.Tensor
    k: int
    sizes: Tuple[int, ...]


class ConvGroup(NamedTuple):
    """A block-diagonal conv (dil convs, or 1x1 projections) with its folded
    bias and the output width of each member."""

    w: torch.Tensor
    b: torch.Tensor
    sizes: Tuple[int, ...]


def sep_group(ops, k: int, dtype: torch.dtype) -> SepGroup:
    """Fold G SepConv modules (relu→dw→pw→bn1→relu→dw→pw→bn2) for a wave."""
    dws1, dws2, pws1, pws2, bias1, bias2 = [], [], [], [], [], []
    for op in ops:
        s1, b1 = fold_bn(op.bn1)
        s2, b2 = fold_bn(op.bn2)
        dws1.append(_pad_taps(op.dw1.kernel.float(), k))
        dws2.append(_pad_taps(op.dw2.kernel.float(), k))
        pws1.append(op.pw1.kernel.float() * s1[:, None, None, None])
        pws2.append(op.pw2.kernel.float() * s2[:, None, None, None])
        bias1.append(b1)
        bias2.append(b2)
    return SepGroup(
        torch.cat(dws1).to(dtype), _block_diag(pws1).to(dtype), torch.cat(bias1).to(dtype),
        torch.cat(dws2).to(dtype), _block_diag(pws2).to(dtype), torch.cat(bias2).to(dtype),
        k, tuple(w.shape[0] for w in pws2),
    )


def dil_group(ops, k: int, dtype: torch.dtype) -> ConvGroup:
    """Fold G DilConv modules (relu→conv(k, d2)→bn) into one block-diagonal
    (ΣO, ΣC, k, k) kernel: a dense conv, not a grouped one, as in JAX."""
    kernels, biases = [], []
    for op in ops:
        s, b = fold_bn(op.bn)
        kernels.append(_pad_taps(op.conv.kernel.float() * s[:, None, None, None], k))
        biases.append(b)
    return ConvGroup(_block_diag(kernels).to(dtype), torch.cat(biases).to(dtype),
                     tuple(w.shape[0] for w in kernels))


def pw_group(modules, dtype: torch.dtype) -> ConvGroup:
    """Fold G ReLUConvBN(kernel_size=1) modules into one block-diagonal 1x1."""
    mats, biases = [], []
    for m in modules:
        s, b = fold_bn(m.bn)
        mats.append(m.conv.kernel.float() * s[:, None, None, None])
        biases.append(b)
    return ConvGroup(_block_diag(mats).to(dtype), torch.cat(biases).to(dtype),
                     tuple(w.shape[0] for w in mats))


# -------------------------------------------------------------- packed ops


def _cat(xs: List[torch.Tensor]) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)


def _split(x: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    return [x] if len(sizes) == 1 else list(torch.split(x, list(sizes), dim=1))


def packed_sep(xs: List[torch.Tensor], w: SepGroup, dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
    """G sep convs (mixed 3x3/5x5) over their channel concat."""
    x = F.relu(_cat(xs)).to(dtype or xs[0].dtype)
    p = w.k // 2
    x = conv2d(x, w.dw1, None, 1, p, 1, x.shape[1])
    x = F.relu(conv2d(x, w.pw1, w.b1))
    x = conv2d(x, w.dw2, None, 1, p, 1, x.shape[1])
    return _split(conv2d(x, w.pw2, w.b2), w.sizes)


def packed_dil(xs: List[torch.Tensor], w: ConvGroup, dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
    """G dilated (d=2) convs over their concat as one block-diagonal conv."""
    x = F.relu(_cat(xs)).to(dtype or xs[0].dtype)
    k = w.w.shape[-1]
    return _split(conv2d(x, w.w, w.b, 1, k - 1, 2), w.sizes)


def packed_relu_conv_bn_1x1(xs: List[torch.Tensor], w: ConvGroup, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """G independent ReLU→1x1 conv→BN stages over their concat as one
    block-diagonal 1x1; returns the still-concatenated result."""
    x = F.relu(_cat(xs)).to(dtype or xs[0].dtype)
    return conv2d(x, w.w, w.b)


def packed_pool(xs: List[torch.Tensor], kind: str) -> List[torch.Tensor]:
    """G stride-1 3x3 pools over their concat (avg: count_include_pad=False)."""
    x = _cat(xs)
    y = max_pool_3x3(x, 1) if kind == "max" else avg_pool_3x3(x, 1)
    return _split(y, [t.shape[1] for t in xs])


# ----------------------------------------------------------------- runner


def wave_weights(waves, ops, dtype: torch.dtype) -> Dict[Tuple[int, int], object]:
    """{(wave, group): SepGroup or ConvGroup} for the conv groups of a
    schedule, over the cell's op modules in sorted-edge order."""
    out = {}
    for wi, wave in enumerate(waves):
        for gi, (kind, k, members) in enumerate(wave):
            group = [ops[m[2]] for m in members]
            if kind == "sep":
                out[wi, gi] = sep_group(group, k, dtype)
            elif kind == "dil":
                out[wi, gi] = dil_group(group, k, dtype)
    return out


def run_packed_dag(
    s0: torch.Tensor,
    s1: torch.Tensor,
    waves,
    weights: Dict[Tuple[int, int], object],
    B: int,
    dtype: Optional[torch.dtype],
) -> List[torch.Tensor]:
    """Execute the packed schedule; returns the B block outputs."""
    states = [s0, s1]
    contrib: Dict[int, list] = {b: [] for b in range(B)}

    def settle():
        # blocks complete in order; a block's state index is 2+b, and every
        # decoded block sums exactly 2 edges
        while len(states) - 2 < B and len(contrib[len(states) - 2]) == 2:
            a, b = contrib[len(states) - 2]
            states.append(a + b)

    for wi, wave in enumerate(waves):
        for gi, (kind, k, members) in enumerate(wave):
            xs = [states[m[1]] for m in members]
            if kind == "sep":
                outs = packed_sep(xs, weights[wi, gi], dtype)
            elif kind == "dil":
                outs = packed_dil(xs, weights[wi, gi], dtype)
            elif kind in ("max", "avg"):
                outs = packed_pool(xs, kind)
            elif kind == "skip":
                outs = xs
            else:  # zero: an exact-zero contribution (Zero, stride 1)
                outs = [torch.zeros_like(x) for x in xs]
            for m, y in zip(members, outs):
                contrib[m[0]].append(y)
        settle()

    if len(states) - 2 != B:
        raise ValueError("unscheduled blocks remain")
    return states[2:]
