"""Row bands: the op layer's side of spatial sharding
(``parallel.spatial_shard_forward``, the JAX package's H-sharded forward).

Under spatial sharding each rank holds a contiguous band of global rows
[lo, hi) of every activation; the split of each global height over the
ranks is a pure function of that height (``parallel.spatial.RowBands``),
so every rank knows every rank's band without asking. A ``RowBand`` is
this rank's rows of one tensor: the local rows as a plain tensor's data,
plus the global height ``rows``, the dim that holds the rows
(``row_dim``: 2 for NCHW, 1 for NHWC) and the geometry ``bands``.

Per-pixel ops (eval BN, ReLU, adds, casts, channel concats) keep a band a
band. An op that reads other rows has a band rule here: it asks the
geometry for the global input rows its output band reads
(``bands.fetch``: rows of any rank, and the op's own padding value
outside [0, rows)) and computes its output rows in global coordinates.
Any other op that could read across rows (a conv, pool, pad, resize,
slice or reduction without a rule) raises instead of computing a wrong
band. Without a ``RowBand`` nothing here runs: the ops take their plain
path unchanged.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

# ops that read across rows and have no band rule: called on a RowBand they raise
_ACROSS_ROWS = frozenset((
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d", "max_pool1d", "max_pool2d",
    "_max_pool2d", "max_pool2d_with_indices", "avg_pool1d", "avg_pool2d", "adaptive_avg_pool2d",
    "adaptive_max_pool2d", "interpolate", "upsample", "pad", "mean", "sum", "prod", "amax", "amin", "max", "min",
    "argmax", "argmin", "std", "var", "var_mean", "norm", "__getitem__", "narrow", "roll", "flip", "unfold",
    "index_select", "gather", "reshape", "view", "flatten", "squeeze", "unsqueeze", "transpose", "cumsum",
))


class RowBand(torch.Tensor):
    """This rank's rows of a tensor of global height ``rows`` along dim
    ``row_dim``, split by ``bands``. Build one with ``wrap``; ``local`` gives
    the plain tensor back."""

    rows: int
    row_dim: int
    bands: object

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        with torch._C.DisableTorchFunctionSubclass():
            ref = _first_band(args, kwargs)
            if ref is not None and name in _ACROSS_ROWS:
                raise ValueError(f"{name} reads across rows and has no band rule: spatial sharding does not "
                                 "cover it")
            out = func(*args, **kwargs)
            if ref is None:
                return out
            if name == "permute":  # the rows move with their dim
                dims = args[1:] if len(args) > 2 else (args[1] if len(args) > 1 else kwargs["dims"])
                dims = [d % ref.ndim for d in dims]
                return wrap(out, ref.rows, ref.bands, dims.index(ref.row_dim))
            return _rewrap(out, ref, name)


def _first_band(args, kwargs) -> Optional[RowBand]:
    found = None
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if type(t) is RowBand:
                if found is None:
                    found = t
                elif (t.rows, t.row_dim, t.bands) != (found.rows, found.row_dim, found.bands):
                    raise ValueError(f"bands of {found.rows} and {t.rows} global rows in one op")
    return found


def _rewrap(out, ref: RowBand, name: str):
    if isinstance(out, (list, tuple)):
        return type(out)(_rewrap(o, ref, name) for o in out)
    if not isinstance(out, torch.Tensor):
        return out
    local_rows = ref.shape[ref.row_dim]
    if out.ndim != ref.ndim or out.shape[ref.row_dim] != local_rows:
        raise ValueError(f"{name} turned a band of {local_rows} rows into {tuple(out.shape)}: no band rule")
    return wrap(out, ref.rows, ref.bands, ref.row_dim)


def wrap(t: torch.Tensor, rows: int, bands, dim: int = 2) -> RowBand:
    """``t`` (this rank's rows along ``dim``) as a band of a tensor of
    ``rows`` global rows split by ``bands``."""
    lo, hi = bands.band(rows)
    if t.shape[dim] != hi - lo:
        raise ValueError(f"a band of rows [{lo}, {hi}) of {rows} needs {hi - lo} rows along dim {dim}, "
                         f"got {tuple(t.shape)}")
    b = t.as_subclass(RowBand)
    b.rows, b.bands, b.row_dim = rows, bands, dim
    return b


def is_band(x) -> bool:
    return type(x) is RowBand


def local(x: torch.Tensor) -> torch.Tensor:
    """The plain tensor of a band's local rows (``x`` itself otherwise)."""
    return x.as_subclass(torch.Tensor) if type(x) is RowBand else x


def shape(x: torch.Tensor) -> torch.Size:
    """The global shape: a band's with its global rows."""
    if type(x) is not RowBand:
        return x.shape
    s = list(local(x).shape)
    s[x.row_dim] = x.rows
    return torch.Size(s)


def _fetch(x: RowBand, window: Callable[[int], Tuple[int, int]], fill: float) -> torch.Tensor:
    """Global rows ``window(me)`` of NCHW band ``x`` as a plain tensor,
    ``fill`` outside [0, rows); ``window(r)`` gives every rank's request."""
    if x.row_dim != 2:
        raise ValueError(f"band ops take NCHW bands (rows in dim 2), got rows in dim {x.row_dim}")
    return x.bands.fetch(local(x), x.rows, 2, window, fill)


def _sliding(x: RowBand, k: int, stride: int, padding: int, dilation: int, fill: float):
    """(fetched rows, output rows, empty-output flag) of a sliding window
    op (k, stride, padding, dilation) on band ``x``."""
    span = dilation * (k - 1)
    rows_out = (x.rows + 2 * padding - span - 1) // stride + 1
    bands = x.bands

    def window(r):
        lo, hi = bands.band(rows_out, r)
        start = lo * stride - padding
        return (start, start) if hi == lo else (start, (hi - 1) * stride - padding + span + 1)

    win = _fetch(x, window, fill)
    lo, hi = bands.band(rows_out)
    return win, rows_out, hi == lo


def _empty_out(x: torch.Tensor, c: int, w_out: int, dtype) -> torch.Tensor:
    return torch.empty((x.shape[0], c, 0, w_out), dtype=dtype, device=x.device)


def conv2d(x: RowBand, w: torch.Tensor, b: Optional[torch.Tensor], stride: int, padding: int, dilation: int,
           groups: int) -> RowBand:
    """``F.conv2d(x, w, b, stride, padding, dilation, groups)`` on a band:
    zero rows only past the global edges, the stride's phase from the
    global row 0."""
    k = w.shape[2]
    win, rows_out, empty = _sliding(x, k, stride, padding, dilation, 0.0)
    if empty:
        w_out = (win.shape[3] + 2 * padding - dilation * (w.shape[3] - 1) - 1) // stride + 1
        out = _empty_out(win, w.shape[0], w_out, torch.promote_types(win.dtype, w.dtype))
    else:
        out = F.conv2d(win, w, b, stride, (0, padding), dilation, groups)
    return wrap(out, rows_out, x.bands)


def max_pool_3x3(x: RowBand, stride: int) -> RowBand:
    """MaxPool2d(3, stride, 1) on a band: -inf rows past the global edges."""
    win, rows_out, empty = _sliding(x, 3, stride, 1, 1, -math.inf)
    if empty:
        out = _empty_out(win, win.shape[1], (win.shape[3] - 1) // stride + 1, win.dtype)
    else:
        out = F.max_pool2d(win, 3, stride, (0, 1))
    return wrap(out, rows_out, x.bands)


def avg_pool_3x3(x: RowBand, stride: int) -> RowBand:
    """AvgPool2d(3, stride, 1, count_include_pad=False) on a band, summed in
    fp32: a fetched row counts, a row past the global edges does not (the
    divisor is the pooled validity mask)."""
    xf = wrap(local(x).float(), x.rows, x.bands)
    win, rows_out, empty = _sliding(xf, 3, stride, 1, 1, 0.0)
    if empty:
        return wrap(_empty_out(win, win.shape[1], (win.shape[3] - 1) // stride + 1, x.dtype), rows_out, x.bands)
    lo, _ = x.bands.band(rows_out)
    first = lo * stride - 1  # the window's first global row
    g = torch.arange(first, first + win.shape[2], device=win.device)
    valid = ((g >= 0) & (g < x.rows)).to(win.dtype)
    mask = valid[None, None, :, None].expand(1, 1, win.shape[2], win.shape[3])
    sums = F.avg_pool2d(win, 3, stride, (0, 1), divisor_override=1)
    counts = F.avg_pool2d(mask, 3, stride, (0, 1), divisor_override=1)
    return wrap((sums / counts).to(x.dtype), rows_out, x.bands)


def shift_up_left(x: RowBand, shift: int) -> RowBand:
    """y[i, j] = x[i+shift, j+shift], zero past the global bottom and the
    right edge: a band's last ``shift`` rows come from the next bands."""
    bands = x.bands

    def window(r):
        lo, hi = bands.band(x.rows, r)
        return lo + shift, hi + shift

    win = _fetch(x, window, 0.0)
    return wrap(F.pad(win[:, :, :, shift:], (0, shift, 0, 0)), x.rows, bands)


def _source_rows(lo: int, hi: int, rows_in: int, rows_out: int, align_corners: bool, device):
    """PyTorch's bilinear source rows and weights for output rows [lo, hi)
    (``area_pixel_compute_source_index``, fp32): half-pixel
    src = (dst + 0.5)·in/out − 0.5 clamped at 0, or src = dst·(in−1)/(out−1)
    with ``align_corners``; i0 = floor(src), i1 = min(i0 + 1, in − 1)."""
    f32 = torch.float32
    dst = torch.arange(lo, hi, device=device, dtype=f32)
    if align_corners:
        scale = (torch.tensor(float(rows_in - 1), dtype=f32) / float(rows_out - 1)) if rows_out > 1 else \
            torch.tensor(0.0, dtype=f32)
        src = dst * scale.to(device)
    else:
        scale = (torch.tensor(float(rows_in), dtype=f32) / torch.tensor(float(rows_out), dtype=f32)).to(device)
        src = ((dst + 0.5) * scale - 0.5).clamp_min(0.0)
    i0 = src.long()
    l1 = (src - i0).clamp(0.0, 1.0)
    i1 = (i0 + 1).clamp_max(rows_in - 1)
    return i0, i1, 1.0 - l1, l1


def resize_rows(x: RowBand, rows_out: int, align_corners: bool, mid: Optional[Callable] = None) -> RowBand:
    """The H axis of a bilinear resize on a band, computed in fp32 and
    rounded once to x's dtype; ``mid`` (the W axis, row by row) runs on
    the fetched rows before the blend when given."""
    bands = x.bands
    lo, hi = bands.band(rows_out)

    def window(r):
        a, b = bands.band(rows_out, r)
        if a == b:
            return 0, 0
        i0, i1, _, _ = _source_rows(a, b, x.rows, rows_out, align_corners, "cpu")
        return int(i0.min()), int(i1.max()) + 1

    win = _fetch(x, window, 0.0)
    if mid is not None:
        win = mid(win)
    if hi == lo:
        return wrap(_empty_out(win, win.shape[1], win.shape[3], win.dtype), rows_out, bands)
    i0, i1, l0, l1 = _source_rows(lo, hi, x.rows, rows_out, align_corners, win.device)
    start = window(bands.rank)[0]
    out = win.index_select(2, i0 - start).float().mul_(l0[:, None])  # x0·λ0 + x1·λ1, two rows' worth of memory
    out.add_(win.index_select(2, i1 - start).float().mul_(l1[:, None]))
    return wrap(out.to(win.dtype), rows_out, bands)


def resize_bilinear(x: RowBand, rows_out: int, w_out: int, align_corners: bool, w_first: bool) -> RowBand:
    """``ops.resize.resize_bilinear`` on a band: W (never sharded) by
    ``F.interpolate`` on this rank's rows, H on global rows by
    ``resize_rows``. Below fp32 each axis rounds, in the plain path's
    order (``w_first``); in fp32 the W pass comes first, as
    ``F.interpolate`` nests its two axes."""
    w_in = local(x).shape[3]

    def w_pass(t):
        if w_in == w_out:
            return t
        if t.shape[2] == 0:
            return t.new_empty((*t.shape[:3], w_out))
        return F.interpolate(t, size=(t.shape[2], w_out), mode="bilinear", align_corners=align_corners)

    if x.rows == rows_out:
        return wrap(w_pass(local(x)), rows_out, x.bands)
    if x.dtype in (torch.float32, torch.float64) or w_first:
        return resize_rows(x, rows_out, align_corners, mid=w_pass)
    y = resize_rows(x, rows_out, align_corners)
    return wrap(w_pass(local(y)), rows_out, x.bands)


def mean_hw(x: RowBand) -> torch.Tensor:
    """The global mean over (H, W), keepdim, in x's dtype: this band's fp32
    sums, summed over the ranks, over the global H·W (a plain tensor:
    every rank holds all of it)."""
    s = local(x).float().sum(dim=(2, 3), keepdim=True)
    s = x.bands.all_sum(s)
    return (s / (x.rows * local(x).shape[3])).to(x.dtype)


# rows a cell-DAG primitive reads on each side of an output row: a SepConv
# two stride-1 stages of k//2, a DilConv (dilation 2) 2·(k//2), a 3x3 pool 1
ROW_RADIUS = {"none": 0, "skip_connect": 0, "max_pool_3x3": 1, "avg_pool_3x3": 1, "sep_conv_3x3": 2,
              "sep_conv_5x5": 4, "dil_conv_3x3": 2, "dil_conv_5x5": 4}


def block_windows(xs, rows: int, bands, names) -> Tuple[list, int]:
    """The band rule of one cell-DAG block (``kernels.cell_ops.run_dag``):
    each of ``xs`` (this rank's rows, NCHW, of states of ``rows`` global
    rows; plain tensors) fetched over the global rows [max(0, lo − R),
    min(rows, hi + R)), R the largest ``ROW_RADIUS`` of the block's ops
    ``names``. The window is clipped, not filled: the block's kernel pads
    at the window's edges as at the image's, which is right at the global
    edges, and its rows within R of an inner edge are computed and thrown
    away. Returns (windows, the band's first row in them). Every rank
    fetches, a rank without rows too (an empty window)."""
    radius = max((ROW_RADIUS[n] for n in names), default=0)

    def window(r):
        lo, hi = bands.band(rows, r)
        return (lo, lo) if hi == lo else (max(0, lo - radius), min(rows, hi + radius))

    wins = [bands.fetch(x, rows, 2, window, 0.0) for x in xs]
    return wins, bands.band(rows)[0] - window(bands.rank)[0]


def broadcast_rows(t: torch.Tensor, like: RowBand) -> RowBand:
    """A (N, C, 1, 1) tensor every rank holds, spread over ``like``'s band
    (the align-corners resize of a 1×1 map: every output is its value)."""
    n, _, h, w = local(like).shape
    return wrap(t.expand(n, t.shape[1], h, w).contiguous(), like.rows, like.bands)
