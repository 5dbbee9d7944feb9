"""Decoded (fixed-genotype) cell (models/cell.py of the JAX package; the
reference's ADD.py Cell, :14-116). The B-block DAG runs op by op, or in
eval mode by one of the JAX package's ``--cell-exec`` variants:

  * ``flat_eval``: through ``kernels.cell_ops.run_dag``, the hand-written
    cell kernels K3-K6 on a CUDA tensor, their plain versions on a CPU
    tensor (models/cell.py:172-203, without its batch-1 limit);
  * ``packed_eval``: the wave-packed schedule of ``ops/packed.py``, and the
    dense taps' projections as one block-diagonal 1x1 plus the fuse 1x1;
    with ``flat_eval`` too (``flat-packed``) the packed projections feed
    the flat DAG;
  * ``dense_sep_eval``: every SepConv as two composed dense convs
    (``SepConv(dense_form=True)``).

Training runs the per-op modules whatever ``packed_eval`` and
``dense_sep_eval`` say (the same parameters); ``flat_eval`` refuses it.
The packed weights are folded once per weight version and kept on the
cell (``packed_weights``). Every execution takes row bands (spatial
sharding): the flat DAG runs each block on a window of rows around the
band (``run_dag``), the packed convs and the dense-sep convs take the
band rules of ``ops/band.py``.

A cell is a B-block DAG over states [s0, s1, block_0, ..., block_{B-1}];
block i consumes edges offset..offset+len(states)-1 with
offset = sum_{j<i}(2+j). The genotype selects 2 edges per block and one
primitive per edge; the cell output is the channel concat of the B blocks.

Reference quirk kept for checkpoint parity: the op list is built in genotype
*row order* but consumed while iterating edges in *ascending* order, so the
op of row k lands on the k-th smallest selected edge (the shipped genotype's
rows [19,7],[18,5] are unsorted).

Submodules carry the flax names (``preprocess``, ``pre_preprocess`` or
``pre_{i}`` + ``pre_preprocess_1x1``, ``dense_process``, ``ops_{k}``) so the
weight bridge maps parameters one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels.cell_ops import run_dag
from ..nas.genotypes import PRIMITIVES
from ..ops import band
from ..ops.packed import packed_relu_conv_bn_1x1, pw_group, run_packed_dag, schedule_waves, wave_weights
from ..ops.primitives import OPS, FactorizedReduce, ReLUConvBN, weights_key
from ..ops.resize import resize_bilinear, scale_dimension

GenotypeRows = Tuple[Tuple[int, int], ...]


def as_genotype_rows(cell_arch) -> GenotypeRows:
    """Normalize a (k, 2) array/sequence to a tuple of int pairs."""
    return tuple((int(e), int(o)) for e, o in cell_arch)


def edge_op_assignment(rows: GenotypeRows) -> Tuple[Tuple[int, int], ...]:
    """(edge, op) pairs with ops in row order on the sorted edges."""
    edges = sorted(e for e, _ in rows)
    return tuple(zip(edges, [o for _, o in rows]))


class FixedCell(nn.Module):
    """One decoded cell.

    Args:
      genotype: ((edge, op), ...) rows as decoded (row order preserved).
      B: blocks per cell.
      C_out: per-block channels (F * fm[level]).
      downup_sample: +1 upsamples s1 2x before a 1x1 preprocess, -1 uses a
        FactorizedReduce preprocess, 0 a 1x1 preprocess.
      C_prev: channels of s1.
      C_prev_prev: channels of s0 (when not ``dense_in``).
      dense_in_channels: channels of each dense tap; non-empty means s0 is
        the list of earlier taps, each 1x1-projected, concatenated and fused
        by one more 1x1 (ADD.py:47-52,:87-93).
      dense_out: also return dense_process(concat) (ADD.py:56-57,:114).
      flat_eval: run the DAG through ``run_dag`` (same parameters); eval
        mode only, since the kernels fold eval-mode BN.
      packed_eval: in eval mode, the packed DAG and dense-tap projections.
      dense_sep_eval: in eval mode, the SepConvs in their dense form.
    """

    def __init__(
        self,
        genotype,
        B: int,
        C_out: int,
        downup_sample: int,
        C_prev: int,
        C_prev_prev: Optional[int] = None,
        dense_in_channels: Sequence[int] = (),
        dense_out: bool = False,
        affine: bool = True,
        dtype: Optional[torch.dtype] = None,
        flat_eval: bool = False,
        packed_eval: bool = False,
        dense_sep_eval: bool = False,
    ):
        super().__init__()
        self.B = B
        self.dtype = dtype
        self.flat_eval = flat_eval
        self.packed_eval = packed_eval
        self.downup_sample = downup_sample
        self.dense_in = len(dense_in_channels) > 0
        self.num_dense_in = len(dense_in_channels)
        self.dense_out = dense_out
        kw = dict(affine=affine, dtype=dtype)
        if downup_sample == -1:
            self.preprocess = FactorizedReduce(C_prev, C_out, **kw)
        else:
            self.preprocess = ReLUConvBN(C_prev, C_out, 1, **kw)
        if self.dense_in:
            for i, c in enumerate(dense_in_channels):
                self.add_module(f"pre_{i}", ReLUConvBN(c, C_out, 1, **kw))
            self.pre_preprocess_1x1 = ReLUConvBN(self.num_dense_in * C_out, C_out, 1, **kw)
        else:
            self.pre_preprocess = ReLUConvBN(C_prev_prev, C_out, 1, **kw)
        if dense_out:
            self.dense_process = ReLUConvBN(B * C_out, C_out, 1, **kw)
        self.assignment = edge_op_assignment(as_genotype_rows(genotype))
        self.selected = dict(self.assignment)
        for k, (_, op) in enumerate(self.assignment):
            name = PRIMITIVES[op]
            okw = dict(kw, dense_form=True) if dense_sep_eval and name.startswith("sep_conv") else kw
            self.add_module(f"ops_{k}", OPS[name](C_out, 1, **okw))
        self.waves = schedule_waves(self.assignment, B)

    def _ops(self):
        return [getattr(self, f"ops_{k}") for k in range(len(self.assignment))]

    def packed_weights(self, dtype: torch.dtype) -> dict:
        """The packed path's folded weights in ``dtype``: {"waves": the DAG's
        conv groups (unless ``flat_eval`` runs the DAG), "taps" and "fuse":
        the dense-tap projections}. Kept on the cell and folded again only
        when a weight or BN statistic changed (training, ``load_state_dict``,
        a move): folding is tens of small launches a cell."""
        key = weights_key(self, dtype)
        cached = getattr(self, "_packed", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            w = {}
            if not self.flat_eval:
                w["waves"] = wave_weights(self.waves, self._ops(), dtype)
            if self.dense_in:
                w["taps"] = pw_group([getattr(self, f"pre_{i}") for i in range(self.num_dense_in)], dtype)
                w["fuse"] = pw_group([self.pre_preprocess_1x1], dtype)
        self._packed = (key, w)
        return w

    def forward(self, s0, s1: torch.Tensor):
        """s0 is a tensor, or the list of dense taps with ``dense_in``.
        Returns (prev_input, concat) or (prev_input, concat, dense fmap)."""
        prev_input = s1
        if self.downup_sample == 1:
            h, w = band.shape(s1)[2:]
            s1 = resize_bilinear(s1, (scale_dimension(h, 2), scale_dimension(w, 2)), align_corners=False)
        s1 = self.preprocess(s1)
        hw = band.shape(s1)[2:]
        packed = self.packed_weights(self.dtype or s1.dtype) if self.packed_eval and not self.training else None
        if self.dense_in:
            if len(s0) != self.num_dense_in:
                raise ValueError(f"expected {self.num_dense_in} dense taps, got {len(s0)}")
            taps = [resize_bilinear(tap, hw, align_corners=False) for tap in s0]
            if packed is not None:
                # all the taps' projections as one block-diagonal 1x1, then the fuse 1x1
                projected = packed_relu_conv_bn_1x1(taps, packed["taps"], self.dtype)
                s0 = packed_relu_conv_bn_1x1([projected], packed["fuse"], self.dtype)
            else:
                projected = [getattr(self, f"pre_{i}")(tap) for i, tap in enumerate(taps)]
                s0 = self.pre_preprocess_1x1(torch.cat(projected, dim=1))
        else:
            if band.shape(s0)[2] != hw[0]:
                s0 = resize_bilinear(s0, hw, align_corners=False)
            s0 = self.pre_preprocess(s0)

        if self.flat_eval:
            if self.training:
                raise RuntimeError(
                    "flat_eval cells run the cell kernels, which fold eval-mode BN: "
                    "train with flat_eval=False (the same parameters)"
                )
            concat = run_dag(s0, s1, self.assignment, self.B, self._ops())
        elif packed is not None:
            concat = torch.cat(run_packed_dag(s0, s1, self.waves, packed["waves"], self.B, self.dtype), dim=1)
        else:
            states = [s0, s1]
            k = 0
            offset = 0
            for _ in range(self.B):
                block_inputs = []
                for j, h in enumerate(states):
                    if offset + j in self.selected:
                        block_inputs.append(getattr(self, f"ops_{k}")(h))
                        k += 1
                states.append(sum(block_inputs[1:], block_inputs[0]))
                offset += len(states) - 1
            concat = torch.cat(states[-self.B:], dim=1)
        if self.dense_out:
            return prev_input, concat, self.dense_process(concat)
        return prev_input, concat
