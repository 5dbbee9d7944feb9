"""Decoded multi-exit networks: ADD (dense), baseline (non-dense) and
single-exit AutoDeepLab (models/decoded.py of the JAX package; the
reference's modeling/ADD.py:118-525).

Images come in NHWC; the backbone state is NCHW in channels_last memory;
``forward`` returns NHWC logits, or (N, C, H, W) with ``class_leading``.
Early-exit inference uses the segment methods (``stem_state``,
``run_cells``, ``exit_feature``, ``exit_logits``), so stopping early skips
the later cells. ``nn.Module.training`` picks the mode: training runs the
plain ops with training-mode BN (the JAX package trains through its
unfused modules too); the kernels K1 and K3-K6 fold eval BN into their
weights and run in eval mode only.

``aspp_size`` uses stride 2^(level+2) everywhere, as ADD.forward does
(ADD.py:279-280); the reference's dynamic path uses 2^level (ADD.py:383),
a defect the JAX package does not replicate either.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.stems import _conv_out, fused_stems, stem_weights, stems_reference
from ..ops import band
from ..ops.aspp import ASPPTrain
from ..ops.heads import DecoderHead, LowLevelConv
from ..ops.norm import BatchNorm, frozen_running_stats
from ..ops.primitives import (
    Conv2d,
    Dense,
    DoubleFactorizedReduce,
    FactorizedReduce,
    ReLUConvBN,
)
from ..ops.resize import resize_bilinear, scale_dimension
from .cell import FixedCell, as_genotype_rows

FM = (1, 2, 4, 8)  # level -> channel multiplier (ADD.py:149)


def _aspp_mult(final_level: int) -> float:
    """Atrous-rate multiplier by the path's final level (ADD.py:242-247),
    extended to level 0 (4.0) as the JAX package does."""
    return {0: 4.0, 1: 2.0, 2: 1.0, 3: 0.5}[final_level]


class _Stems(nn.Module):
    """Three stems (ADD.py:154-169): conv s2 → 64 (+BN+ReLU), conv → 64
    (+BN) = s0, relu + conv s2 → 128 (+BN) = s1."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stem0_conv = Conv2d(3, 64, 3, 2, 1, dtype=dtype)
        self.stem0_bn = BatchNorm(64, dtype=dtype)
        self.stem1_conv = Conv2d(64, 64, 3, 1, 1, dtype=dtype)
        self.stem1_bn = BatchNorm(64, dtype=dtype)
        self.stem2_conv = Conv2d(64, 128, 3, 2, 1, dtype=dtype)
        self.stem2_bn = BatchNorm(128, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) → (s0, s1). The one place that picks K1 (CUDA
        tensors in eval mode) or its plain version (CPU tensors, and
        training, whose BNs take batch statistics); there is no fallback."""
        if band.is_band(x):
            return self._on_band(x)
        if x.device.type == "cuda" and not self.training:
            dtype = self.dtype or torch.float32
            return fused_stems(x, stem_weights(self, dtype), out_dtype=dtype)
        if x.device.type in ("cuda", "cpu"):
            return stems_reference(self, x)
        raise ValueError(f"unsupported device {x.device}")

    def _on_band(self, x: band.RowBand) -> Tuple[band.RowBand, band.RowBand]:
        """The stems on a row band (spatial sharding): K1 (or its plain
        version) runs once on a window of global input rows that starts at
        a multiple of 4, so that its stride-2 and stride-4 phases are the
        global ones, and reaches past the band far enough that the rows
        next to the window's inner edges, which K1 pads with zeros, are
        computed and thrown away: s1 rows from 2 past the window's start
        (their input reaches back 7 rows), s0 rows from 2 past it; at the
        bottom s1 row j reads input rows up to 4j + 1, s0 row i up to
        2i + 1. Only at the global edges is K1's padding the true one."""
        bands, h = x.bands, x.rows
        h0 = _conv_out(h)
        h1 = _conv_out(h0)

        def window(r):
            (a0, b0), (a1, b1) = bands.band(h0, r), bands.band(h1, r)
            starts = ([4 * a1 - 8] if b1 > a1 else []) + ([2 * a0 - 4] if b0 > a0 else [])
            if not starts:
                return 0, 0
            ends = ([4 * b1 + 2] if b1 > a1 else []) + ([2 * b0 + 2] if b0 > a0 else [])
            return max(0, min(starts)) // 4 * 4, min(h, max(ends))

        win = band._fetch(x, window, 0.0)
        (a0, b0), (a1, b1) = bands.band(h0), bands.band(h1)
        g = window(bands.rank)[0]
        if win.shape[2] == 0:
            n, _, _, w = win.shape
            dtype = (self.dtype or torch.float32) if win.is_cuda and not self.training else win.dtype
            s0 = win.new_empty((n, 64, 0, _conv_out(w)), dtype=dtype)
            s1 = win.new_empty((n, 128, 0, _conv_out(_conv_out(w))), dtype=dtype)
        else:
            s0, s1 = self.forward(win)
            s0, s1 = s0[:, :, a0 - g // 2:b0 - g // 2], s1[:, :, a1 - g // 4:b1 - g // 4]
        return band.wrap(s0, h0, bands), band.wrap(s1, h1, bands)


class DecodedNet(nn.Module):
    """Decoded network with its exits sharing one ASPP + decoder head.

    ``network_arch`` is the level path; ``C_index`` the early-exit layer
    indices (the final layer is always an exit); ``genotype`` the decoded
    cell rows; ``dense=True`` gives ADD's densely connected variant;
    ``flat_eval=True`` runs every cell's DAG through the cell kernels
    (``--cell-exec flat``) with the same parameters, in eval mode only;
    ``packed_eval`` (``--cell-exec packed``; with ``flat_eval``,
    ``flat-packed``) and ``dense_sep_eval`` (``dense-sep``) pick the JAX
    package's other eval executions of the cells (models/cell.py), which
    training ignores;
    ``remat=True`` checkpoints each cell in training (recomputed in
    backward: activation memory for FLOPs).
    """

    def __init__(
        self,
        network_arch: Sequence[int],
        C_index: Sequence[int],
        genotype,
        num_classes: int,
        F: int = 20,
        B: int = 5,
        low_level_layer: int = 0,
        dense: bool = True,
        fp32_eval_logits: bool = False,
        dtype: Optional[torch.dtype] = None,
        flat_eval: bool = False,
        remat: bool = False,
        packed_eval: bool = False,
        dense_sep_eval: bool = False,
    ):
        super().__init__()
        arch = tuple(int(v) for v in network_arch)
        self.remat = remat
        self.network_arch = arch
        self.C_index = tuple(int(v) for v in C_index)
        self.num_classes = num_classes
        self.F, self.B = F, B
        self.low_level_layer = low_level_layer
        self.dense = dense
        self.dtype = dtype
        n = len(arch)
        # channels of each cell's concat output
        self._concat_ch = [B * F * FM[level] for level in arch]

        self.stems = _Stems(dtype)
        for i, level in enumerate(arch):
            c_out = F * FM[level]
            downup = (0 - level) if i == 0 else int(arch[i - 1] - level)
            c_prev = 128 if i == 0 else self._concat_ch[i - 1]
            if dense and i >= 3:
                # taps: dense fmaps of cells 0..i-2, each at its cell's C_out
                kw = dict(dense_in_channels=[F * FM[arch[j]] for j in range(i - 1)])
            else:
                kw = dict(C_prev_prev=(64, 128)[i] if i < 2 else self._concat_ch[i - 2])
            self.add_module(
                f"cell_{i}",
                FixedCell(
                    genotype, B, c_out, downup, c_prev,
                    dense_out=dense and i < n - 2, dtype=dtype, flat_eval=flat_eval,
                    packed_eval=packed_eval, dense_sep_eval=dense_sep_eval, **kw,
                ),
            )

        # dense cells (i >= 3) leave `prev` at cell 2's output
        low_src = min(low_level_layer, 2) if dense else low_level_layer
        self.low_level_conv = LowLevelConv(self._concat_ch[low_src], dtype=dtype)
        final_ch = B * F * FM[arch[-1]]
        self.aspp = ASPPTrain(final_ch, out=256, mult=_aspp_mult(arch[-1]), dtype=dtype)
        self.decoder = DecoderHead(
            num_classes, dtype=dtype, fp32_eval_logits=fp32_eval_logits
        )

        # per-exit resolution/channel adapters (ADD.py:265-273), only for
        # early exits whose level differs from the final level
        self._adapters = {}
        for c in self.C_index:
            diff = arch[c] - arch[-1]
            if diff == 0:
                continue
            c_in = self._concat_ch[c]
            if diff == -1:
                mod = FactorizedReduce(c_in, final_ch, dtype=dtype)
            elif diff == -2:
                mod = DoubleFactorizedReduce(c_in, final_ch, dtype=dtype)
            else:  # coarser exit than final: 1x1 adapter after the upsample
                mod = ReLUConvBN(c_in, final_ch, 1, dtype=dtype)
            self.add_module(f"conv_aspp_{c}", mod)
            self._adapters[c] = mod

    @property
    def exit_layers(self) -> Tuple[int, ...]:
        out = []
        for s in self.C_index + (len(self.network_arch) - 1,):
            if s not in out:
                out.append(s)
        return tuple(out)

    def feature_channels(self, i: int) -> int:
        """Channels of ``exit_feature(state, i)`` (the EDM's input)."""
        return self._concat_ch[i]

    # ------------------------------------------------------------ segments

    def stem_state(self, x: torch.Tensor) -> dict:
        """x: NHWC images (N, H, W, 3) → the backbone state."""
        s0, s1 = self.stems(x.permute(0, 3, 1, 2))
        return {"prev_prev": s0, "prev": s1, "x": None, "dense": (), "low_level": None}

    def run_cells(self, state: dict, start: int, end: int) -> dict:
        """Run cells[start..end] inclusive (ADD.py:290-308), with the same
        branch predicates the constructor used (dense_in = i >= 3,
        dense_out = i < n-2)."""
        n = len(self.network_arch)
        s_pp, s_p = state["prev_prev"], state["prev"]
        x = state["x"]
        dense = list(state["dense"])
        low_level = state["low_level"]
        for i in range(start, end + 1):
            cell = getattr(self, f"cell_{i}")
            if self.remat and self.training and torch.is_grad_enabled():
                cell = _checkpointed(cell)
            if not self.dense:
                s_pp, s_p = cell(s_pp, s_p)
            elif i >= 3:
                ins = dense if i == n - 1 else dense[:-1]
                if i < n - 2:
                    _, x, fmap = cell(ins, x)
                    dense.append(fmap)
                else:
                    _, x = cell(ins, x)
            else:
                if i < n - 2:
                    s_pp, s_p, fmap = cell(s_pp, s_p)
                    dense.append(fmap)
                else:
                    s_pp, s_p = cell(s_pp, s_p)
                if i == 2:
                    x = s_p
            if i == self.low_level_layer:
                low_level = self.low_level_conv(s_p)
        return {
            **state, "prev_prev": s_pp, "prev": s_p, "x": x,
            "dense": tuple(dense), "low_level": low_level,
        }

    def exit_feature(self, state: dict, i: int) -> torch.Tensor:
        """Pre-head feature (NCHW) at exit layer i (ADD.py:311-314)."""
        if self.dense and i > 2:
            return state["x"]
        return state["prev"]

    def exit_logits(self, state: dict, i: int, size, class_leading: bool = False) -> torch.Tensor:
        """Shared-head logits at exit layer i, upsampled to ``size`` = (H, W):
        NHWC, or (N, C, H, W) with ``class_leading``."""
        scale = 2.0 ** -(self.network_arch[-1] + 2)
        aspp_hw = (scale_dimension(size[0], scale), scale_dimension(size[1], scale))
        y = self.exit_feature(state, i)
        h, w = band.shape(y)[2:]
        if h < aspp_hw[0] or w < aspp_hw[1]:
            y = resize_bilinear(y, aspp_hw, align_corners=False)
        if i in self._adapters:
            y = self._adapters[i](y)
        y = self.aspp(y)
        return self.decoder(y, state["low_level"], size, class_leading)

    # ------------------------------------------------------------ programs

    def forward(self, x: torch.Tensor, class_leading: bool = False) -> List[torch.Tensor]:
        """All-exit forward on NHWC images: one logits tensor per exit."""
        state = self.stem_state(x)
        size = tuple(band.shape(x)[1:3])
        out = []
        start = 0
        for i in self.exit_layers:
            state = self.run_cells(state, start, i)
            out.append(self.exit_logits(state, i, size, class_leading))
            start = i + 1
        return out

    def get_feature(self, x: torch.Tensor, class_leading: bool = False):
        """(first-exit logits, NHWC or with ``class_leading`` (N, C, H, W),
        and its NCHW pre-head feature), ADD.py:327-377."""
        first = self.exit_layers[0]
        state = self.run_cells(self.stem_state(x), 0, first)
        logits = self.exit_logits(state, first, tuple(x.shape[1:3]), class_leading)
        return logits, self.exit_feature(state, first)


@contextlib.contextmanager
def _stacked(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _checkpointed(cell: nn.Module, contexts=None):
    """``cell`` whose activations are recomputed in backward instead of
    kept (JAX: ``nn.remat``); the recomputation leaves the BN running
    statistics as the forward left them. ``contexts``, when given, makes
    a fresh (forward, recompute) context pair for each call, as
    ``torch.utils.checkpoint``'s ``context_fn`` does: a policy that keeps
    some outputs (models/supernet.py ``remat_policy``)."""

    def pair():
        fwd, rec = contexts() if contexts is not None else (contextlib.nullcontext(), contextlib.nullcontext())
        return fwd, _stacked(rec, frozen_running_stats())

    return lambda *args: checkpoint(cell, *args, use_reentrant=False, context_fn=pair)


class EDM(nn.Module):
    """Earlier-exit Decision Maker (ADD.py:502-525): relu → 3x3 s2 conv →
    relu → GAP → MLP(128→64→32→1, the last in fp32). Predicts the exit's
    normalized entropy from its NCHW pre-head feature."""

    def __init__(self, in_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_features, 128, 3, 2, 1, dtype=dtype)
        self.fc1 = Dense(128, 64, dtype=dtype)
        self.fc2 = Dense(64, 32, dtype=dtype)
        self.fc3 = Dense(32, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv(F.relu(x)))
        x = x.mean(dim=(2, 3))
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


# ------------------------------------------------------------ constructors


def ADD(network_arch, C_index, cell_arch, num_classes, F=20, B=5, low_level_layer=0, **kw):
    """Densely connected multi-exit ADD model (ADD.py:118)."""
    return DecodedNet(
        network_arch, C_index, as_genotype_rows(cell_arch), num_classes,
        F=F, B=B, low_level_layer=low_level_layer, dense=True, **kw,
    )


def BaselineModel(network_arch, C_index, cell_arch, num_classes, F=20, B=5, low_level_layer=0, **kw):
    """Non-dense multi-exit baseline (baseline_model.py:93)."""
    return DecodedNet(
        network_arch, C_index, as_genotype_rows(cell_arch), num_classes,
        F=F, B=B, low_level_layer=low_level_layer, dense=False, **kw,
    )


def AutoDeepLab(network_arch, cell_arch, num_classes, F=20, B=5, low_level_layer=2, **kw):
    """Canonical single-exit Auto-DeepLab (autodeeplab.py:94)."""
    return DecodedNet(
        network_arch, (), as_genotype_rows(cell_arch), num_classes,
        F=F, B=B, low_level_layer=low_level_layer, dense=False, **kw,
    )
