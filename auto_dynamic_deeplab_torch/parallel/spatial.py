"""Spatial sharding's geometry and row exchange (the halo exchanges GSPMD
inserts for the JAX package's ``spatial_shard_forward``).

Rows only are sharded (H; W stays whole). ``RowBands(height, group)``
splits every global height the model produces over the group's ranks
as a pure function of that height, the input's height and the world
size, so every rank knows every rank's band without asking:

  * the input's split points p_r are multiples of 4 (K1 reads its
    window from a row that is a multiple of 4: its stride-4 phase),
    p_r = 4·⌊r·⌈H/4⌉/W⌋, p_W = H;
  * a tensor of h rows splits at ⌊p_r·h/H⌋. Along the stride-2 chain
    (1025 → 513 → 257 → 129 → 65 → 33) that halves each point exactly,
    so a stride-2 op maps band [2a, 2b) to [a, b), and the last rank
    takes the odd row at each level; any other height (a resize's
    target, 129 → 65 is not 2:1) splits in proportion. A rank's band
    may be empty at coarse levels (64 rows over 4 ranks leave two ranks
    without a level-3 row).

``fetch`` is the one row primitive: every rank asks for global rows
[lo, hi) of a tensor (any rank's rows, not only a neighbour's) and gets
them, with the op's padding value outside [0, h). Each rank can compute
every rank's request, so the exchange is static: one batch of paired
``isend`` / ``irecv``. The group's backend picks the route: NCCL moves
CUDA rows directly; gloo moves CPU tensors, and CUDA tensors through a
host copy (two ranks on one card, where NCCL refuses them).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host to cross ``group``: a CUDA
    tensor over gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor)."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order; NCHW
    in channels_last memory stays so (gathered as NHWC, channels last),
    so that the convs after it take the algorithms the unsharded model
    takes."""
    if t.dim() == 4 and dim == 1 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return all_gather_cat(t.permute(0, 2, 3, 1), 3, group).permute(0, 3, 1, 2)
    world = dist.get_world_size(group)
    src = (t.cpu() if _staged(t, group) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def row_bounds(height: int, world: int, rows: int) -> Tuple[int, ...]:
    """The split points of a tensor of ``rows`` global rows in a forward
    whose input has ``height`` rows, over ``world`` ranks: rank r holds
    [bounds[r], bounds[r + 1])."""
    quads = -(-height // 4)
    return tuple(4 * (r * quads // world) * rows // height for r in range(world)) + (rows,)


class RowBands:
    """The row split of every tensor of a forward whose input has
    ``height`` rows, over ``group`` (None: one process, one band).
    ``exchanged_bytes`` counts the rows this rank received."""

    def __init__(self, height: int, group=None):
        self.height = int(height)
        self.group = group
        if group is not None:
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            self.backend = dist.get_backend(group)
        else:
            self.rank, self.world, self.backend = 0, 1, None
        self._bounds: Dict[int, Tuple[int, ...]] = {}
        self.exchanged_bytes = 0

    def bounds(self, rows: int) -> Tuple[int, ...]:
        """The split points of a tensor of ``rows`` global rows: rank r holds
        [bounds[r], bounds[r + 1])."""
        b = self._bounds.get(rows)
        if b is None:
            b = self._bounds[rows] = row_bounds(self.height, self.world, rows)
        return b

    def band(self, rows: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """Rank ``rank``'s (default: this rank's) rows [lo, hi) of a tensor
        of ``rows`` global rows."""
        b = self.bounds(rows)
        r = self.rank if rank is None else rank
        return b[r], b[r + 1]

    def fetch(self, x: torch.Tensor, rows: int, dim: int, window: Callable[[int], Tuple[int, int]],
              fill: float) -> torch.Tensor:
        """Global rows ``window(self.rank)`` of a tensor of ``rows`` global
        rows along ``dim``, of which ``x`` holds this rank's band; rows
        outside [0, rows) are ``fill``. A collective: every rank calls it
        with the same ``window``, which gives each rank's request. An NCHW
        ``x`` whose channels are innermost (channels_last, or a channel
        slice of such a buffer) gives a channels_last window: the rows
        move as NHWC, as the cell kernels and cuDNN's channels_last convs
        take them."""
        if dim == 2 and x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1:
            return self.fetch(x.permute(0, 2, 3, 1), rows, 1, window, fill).permute(0, 3, 1, 2)
        own = self.band(rows)
        if x.shape[dim] != own[1] - own[0]:
            raise ValueError(f"band [{own[0]}, {own[1]}) of {rows} rows, got {x.shape[dim]} rows")
        lo, hi = window(self.rank)
        sends: List[Tuple[int, int, int]] = []  # (rank, lo, hi) of my rows another rank asks for
        recvs: List[Tuple[int, int, int]] = []  # (rank, lo, hi) of another rank's rows I ask for
        for r in range(self.world):
            if r == self.rank:
                continue
            a, b = window(r)
            a, b = max(a, own[0]), min(b, own[1])
            if a < b:
                sends.append((r, a, b))
            a, b = self.band(rows, r)
            a, b = max(a, lo), min(b, hi)
            if a < b:
                recvs.append((r, a, b))
        if (lo, hi) == own:
            if sends:
                self._exchange(x, dim, own[0], sends, [])
            return x
        shape = list(x.shape)
        shape[dim] = hi - lo
        out = x.new_full(shape, fill)
        a, b = max(lo, own[0]), min(hi, own[1])
        if a < b:
            out.narrow(dim, a - lo, b - a).copy_(x.narrow(dim, a - own[0], b - a))
        for (r, a, b), buf in zip(recvs, self._exchange(x, dim, own[0], sends, recvs)):
            out.narrow(dim, a - lo, b - a).copy_(buf)
        return out

    def _exchange(self, x: torch.Tensor, dim: int, start: int, sends, recvs) -> List[torch.Tensor]:
        """Send each of ``sends``' rows of ``x`` (whose first row is global
        row ``start``) and receive each of ``recvs``' rows, in one batch."""
        staged = _staged(x, self.group)
        ops, bufs = [], []
        for r, a, b in sends:
            t = x.narrow(dim, a - start, b - a).contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, dist.get_global_rank(self.group, r),
                                  self.group))
        for r, a, b in recvs:
            shape = list(x.shape)
            shape[dim] = b - a
            buf = torch.empty(shape, dtype=x.dtype, device="cpu" if staged else x.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, r), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.exchanged_bytes += sum(b.numel() * b.element_size() for b in bufs)
        return [b.to(x.device) for b in bufs]

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (``t`` itself in one process)."""
        return t if self.group is None else all_reduce_sum(t, self.group)
