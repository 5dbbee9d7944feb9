"""Search-time cells: MixedOp and the three-branch trellis cell
(models/supernet_cell.py of the JAX package; the reference's
modeling/cell_level_search.py MixedOp :10-29, Cell :32-155, and
modeling/model_net_search.py Cell_fixed :10-132).

One op set per cell is shared by the down / same / up branch DAGs
(cell_level_search.py:144): each present branch calls the same modules, so
in training every BN inside blends its running statistics once per
branch, in the order down, same, up, as flax's sequential mutation does.
Every BN inside a search cell is affine-free.

The JAX package runs a mixed cell's edges in one of three forms (``edges``,
``banked``, ``scan``) that give the same numbers and only keep XLA's traced
graph small. The port has the per-edge form alone (``mixed_{e}``);
``bridge.load_jax_variables`` takes the other two layouts into it.

Submodules carry the flax names (``preprocess_down`` / ``_same`` / ``_up``,
``pre_preprocess``, ``mixed_{e}`` with ``ops_{i}`` and ``pool_bn_{i}``, or
``ops_{k}`` for a fixed cell), so the weight bridge maps them one to one.
A fixed cell holds only the ops its B blocks call (the genotype's rows on
edges below ``num_edges(B)``): flax creates a submodule's parameters when
it is first called, so a JAX supernet with fewer blocks than the genotype
has rows holds no others. Tensors are NCHW.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nas.genotypes import PRIMITIVES, num_edges
from ..ops.norm import BatchNorm
from ..ops.primitives import OPS, DoubleFactorizedReduce, FactorizedReduce, ReLUConvBN
from ..ops.resize import resize_bilinear, scale_dimension_search
from .cell import as_genotype_rows, edge_op_assignment


class MixedOp(nn.Module):
    """Weighted sum over the 8 primitives (cell_level_search.py:10-29).

    Training: sum_i w_i * op_i(x) over every primitive but ``none``, whose
    w * 0 is exactly 0; the pools get a trailing affine-free BN
    (``pool_bn_{i}``, :20-21). Eval runs only the argmax op, unweighted
    (:24-29), and an argmax of ``none`` gives exact zeros; the JAX package
    weights one-hot at the argmax, which gives the same numbers. The result
    is fp32 (the weights are), whatever the policy dtype.
    """

    def __init__(self, C: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.prims: List[int] = []
        for i, prim in enumerate(PRIMITIVES):
            if prim == "none":
                continue
            self.prims.append(i)
            self.add_module(f"ops_{i}", OPS[prim](C, 1, affine=False, dtype=dtype))
            if "pool" in prim:
                self.add_module(f"pool_bn_{i}", BatchNorm(C, affine=False, dtype=dtype))

    def _op(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"ops_{i}")(x)
        if "pool" in PRIMITIVES[i]:
            y = getattr(self, f"pool_bn_{i}")(y)
        return y.float()

    def forward(self, x: torch.Tensor, weights: torch.Tensor, choice: Optional[int] = None) -> torch.Tensor:
        """``weights``: this edge's (8,) softmaxed alphas. ``choice``: their
        argmax, when the caller has it on the host already (eval)."""
        if not self.training:
            k = int(torch.argmax(weights)) if choice is None else int(choice)
            if PRIMITIVES[k] == "none":
                return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            return self._op(k, x)
        out = None
        for i in self.prims:
            y = weights[i] * self._op(i, x)
            out = y if out is None else out + y
        return out


class TrellisCell(nn.Module):
    """One trellis cell with up to three input branches.

    Branch inputs (each optional, presence fixed at construction): s1_down
    (the level above, ``B * C_out / 2`` channels, reduced 2x by a
    FactorizedReduce), s1_same (``B * C_out``, 1x1 preprocess), s1_up (the
    level below, ``2 * B * C_out``, bilinear 2x by the search rule, then
    1x1). The previous-previous input s0 (``C_s0`` channels) is shared by
    all branches after ``pre_rate`` preprocessing (1 → 1x1, 0.5 →
    FactorizedReduce, 0.25 → DoubleFactorizedReduce), upsampled first when
    it is smaller than the branches.

    ``cell_kind`` 'mixed' runs the full 8-way MixedOp DAG on the softmaxed
    ``alphas``; 'fixed' runs the decoded genotype's ops (Cell_fixed, the
    reference's row-order quirk of ``models.cell.edge_op_assignment``).
    """

    def __init__(
        self,
        B: int,
        C_out: int,
        has_down: bool,
        has_same: bool,
        has_up: bool,
        C_s0: int,
        pre_rate: float = 1.0,
        cell_kind: str = "mixed",
        genotype=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.B = B
        self.has_down, self.has_same, self.has_up = has_down, has_same, has_up
        kw = dict(affine=False, dtype=dtype)
        if has_down:
            self.preprocess_down = FactorizedReduce(B * C_out // 2, C_out, **kw)
        if has_same:
            self.preprocess_same = ReLUConvBN(B * C_out, C_out, 1, **kw)
        if has_up:
            self.preprocess_up = ReLUConvBN(2 * B * C_out, C_out, 1, **kw)
        if pre_rate >= 1:
            self.pre_preprocess = ReLUConvBN(C_s0, C_out, 1, **kw)
        elif pre_rate == 0.5:
            self.pre_preprocess = FactorizedReduce(C_s0, C_out, **kw)
        elif pre_rate == 0.25:
            self.pre_preprocess = DoubleFactorizedReduce(C_s0, C_out, **kw)
        else:
            raise ValueError(f"pre_rate {pre_rate}: expected 1, 0.5 or 0.25")

        if cell_kind == "mixed":
            self.ops = [MixedOp(C_out, dtype) for _ in range(num_edges(B))]
            for e, op in enumerate(self.ops):
                self.add_module(f"mixed_{e}", op)
            self.selected = None
        elif cell_kind == "fixed":
            if genotype is None:
                raise ValueError("a fixed cell needs a genotype")
            assignment = [(e, op) for e, op in edge_op_assignment(as_genotype_rows(genotype)) if e < num_edges(B)]
            self.selected = dict(assignment)
            self.ops = [OPS[PRIMITIVES[op]](C_out, 1, **kw) for _, op in assignment]
            for k, op in enumerate(self.ops):
                self.add_module(f"ops_{k}", op)
        else:
            raise ValueError(f"cell_kind {cell_kind!r}: expected 'mixed' or 'fixed'")

    def _dag(self, s0, s1, alphas, choice) -> torch.Tensor:
        states = [s0, s1]
        offset = 0
        k = 0
        for _ in range(self.B):
            inputs = []
            for j, h in enumerate(states):
                e = offset + j
                if self.selected is None:
                    inputs.append(self.ops[e](h, alphas[e], None if choice is None else choice[e]))
                elif e in self.selected:
                    inputs.append(self.ops[k](h))
                    k += 1
            states.append(sum(inputs[1:], inputs[0]))
            offset += len(states) - 1
        return torch.cat(states[-self.B:], dim=1)

    def forward(
        self,
        s0: torch.Tensor,
        s1_down: Optional[torch.Tensor],
        s1_same: Optional[torch.Tensor],
        s1_up: Optional[torch.Tensor],
        alphas: Optional[torch.Tensor] = None,
        choice: Optional[Sequence[int]] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One concat output per present branch, ordered (down, same, up).
        ``alphas``: the (k, 8) softmaxed mixing weights of a mixed cell;
        ``choice``: their per-edge argmax on the host (eval)."""
        branches = []
        if self.has_down:
            branches.append(self.preprocess_down(s1_down))
        if self.has_same:
            branches.append(self.preprocess_same(s1_same))
        if self.has_up:
            target = (scale_dimension_search(s1_up.shape[2], 2), scale_dimension_search(s1_up.shape[3], 2))
            branches.append(self.preprocess_up(resize_bilinear(s1_up, target, align_corners=False)))
        hw = branches[-1].shape[2:]
        if s0.shape[2] < hw[0] or s0.shape[3] < hw[1]:
            s0 = resize_bilinear(s0, hw, align_corners=False)
        s0 = self.pre_preprocess(s0)
        return tuple(self._dag(s0, b, alphas, choice) for b in branches)
