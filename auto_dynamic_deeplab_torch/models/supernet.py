"""Two-level NAS supernets over the L-layer x 4-level trellis
(models/supernet.py of the JAX package).

One skeleton covers the reference's supernets:
  * cell_kind='mixed' → Model_search (modeling/model_search.py:10-655):
    cell-level alphas (k x 8 MixedOps) and network-level betas, exit
    stations with per-station ASPP heads;
  * cell_kind='fixed' → Model_net_search (modeling/model_net_search.py:135):
    cells frozen to a decoded genotype, betas-only search, exits at each
    C_index sharing one set of 4-level ASPP heads;
  * dense=False → the baseline trellis (model_baseline_path_search.py).

The architecture parameters ``alphas`` and ``betas`` are ``nn.Parameter``s
of the supernet (the flax ``arch`` collection); ``arch_parameters()`` and
``weight_parameters()`` split them from the weights for the bilevel
optimizers, as the reference's arch_parameters()/weight_parameters()
(model_search.py:651-655) do.

Images come in NHWC; the trellis runs NCHW; ``forward`` returns one fp32
logits tensor per exit, NHWC, or (N, C, H, W) with ``class_leading``.
``remat=True`` (the JAX default) recomputes each cell in backward instead
of keeping its activations, with the BN running statistics left as the
forward blended them. ``remat_policy`` (JAX :76-95) chooses what a
recomputed cell keeps: None nothing; ``'dots'`` the outputs of its convs
and matrix products (PyTorch's selective checkpointing, JAX
``dots_saveable``); ``'offload_dots'`` the same outputs in pinned host
memory, copied back for the recomputation. The level states are fp32 under a bf16 policy, as
in the JAX package (the fp32 betas promote them there).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..nas.genotypes import PRIMITIVES, num_edges
from ..ops.aspp import ASPPSearch
from ..ops.norm import BatchNorm
from ..ops.primitives import Conv2d, DoubleFactorizedReduce, FactorizedReduce, ReLUConvBN
from ..ops.resize import resize_bilinear
from .decoded import _checkpointed
from .supernet_cell import TrellisCell

NUM_LEVELS = 4
ARCH_NAMES = ("alphas", "betas")

# what 'dots' and 'offload_dots' keep: the cells' FLOPs are in their convs
_aten = torch.ops.aten
SAVED_OPS = (_aten.convolution.default, _aten.mm.default, _aten.addmm.default, _aten.bmm.default)


class _Offload(TorchDispatchMode):
    """Forward of a recomputed cell: a copy of each ``SAVED_OPS`` output
    goes to (pinned, for a CUDA tensor) host memory."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in SAVED_OPS:
            host = torch.empty_strided(out.size(), out.stride(), dtype=out.dtype, device="cpu",
                                       pin_memory=out.is_cuda)
            self.store.append((host.copy_(out, non_blocking=True), out.device))
        return out


class _Reload(TorchDispatchMode):
    """Recomputation: each ``SAVED_OPS`` call returns the kept output,
    copied back to its device, in the forward's order."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in SAVED_OPS:
            host, device = self.store.pop(0)
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(list(SAVED_OPS))


def _offload_contexts():
    store: list = []
    return _Offload(store), _Reload(store)


REMAT_POLICIES = {
    None: None,
    "dots": _dots_contexts,
    "offload_dots": _offload_contexts,
}


def normalize_betas(betas: torch.Tensor) -> torch.Tensor:
    """β logits (L, 4, 3) → transition probabilities with the 2/3
    boundary-edge correction (model_search.py:171-187), invalid entries 0.
    Built out of place from softmaxes, so that it is differentiable."""
    L = betas.shape[0]

    def rows(first: int, part: torch.Tensor, left: int, right: int, scale: float = 1.0):
        """(L, 3): zeros for layers < ``first``, then softmax(part) * scale
        padded with ``left`` / ``right`` zero columns."""
        body = F.pad(torch.softmax(part, dim=-1) * scale, (left, right))
        return torch.cat([body.new_zeros(min(first, L), 3), body], dim=0)

    return torch.stack([
        rows(0, betas[:, 0, 1:], 1, 0, 2 / 3),
        rows(1, betas[1:, 1, :], 0, 0),
        rows(2, betas[2:, 2, :], 0, 0),
        rows(3, betas[3:, 3, :2], 0, 1, 2 / 3),
    ], dim=1)


class TrellisSupernet(nn.Module):
    def __init__(
        self,
        num_classes: int,
        num_layers: int = 12,
        F: int = 8,
        B: int = 5,
        cell_kind: str = "mixed",
        genotype=None,
        exit_layers_cfg: Sequence[int] = (5,),
        shared_exit_heads: bool = True,
        dense: bool = True,
        remat: bool = True,
        dtype: Optional[torch.dtype] = None,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy={remat_policy!r}: expected one of "
                f"{sorted(k for k in REMAT_POLICIES if k)} or None"
            )
        if remat_policy is not None and not remat:
            raise ValueError(
                f"remat_policy={remat_policy!r} requires remat=True — "
                "without remat the policy is never applied and the expected "
                "memory savings silently do not happen"
            )
        self.remat_policy = remat_policy
        L = num_layers
        bad = [s for s in exit_layers_cfg if not 0 <= s < L]
        if bad:
            raise ValueError(
                f"exit station(s) {bad} outside the {L}-layer trellis — pass "
                "--exit-layers < num_layers (the default station 5 assumes the "
                "reference's 12-layer config)"
            )
        self.num_classes, self.num_layers = num_classes, L
        self.F, self.B = F, B
        self.cell_kind = cell_kind
        self.exit_layers_cfg = tuple(int(s) for s in exit_layers_cfg)
        self.shared_exit_heads = shared_exit_heads
        self.dense, self.remat = dense, remat
        FB = F * B
        half = FB // 2

        # stems (model_search.py:54-62)
        self.stem0_conv = Conv2d(3, half, 3, 2, 1, dtype=dtype)
        self.stem0_bn = BatchNorm(half, dtype=dtype)
        self.stem1_conv = Conv2d(half, FB, 3, 2, 1, dtype=dtype)
        self.stem1_bn = BatchNorm(FB, dtype=dtype)

        def out_ch(lv):  # a level's cell output: B blocks of F * 2^lv
            return FB * 2 ** lv

        def cell(i, lv, down, same, up, c_s0, pre_rate):
            self.add_module(f"l{i}_c{lv}", TrellisCell(
                B, F * 2 ** lv, down, same, up, c_s0, pre_rate, cell_kind, genotype, dtype))

        # s0 of each cell: the stem0 map at layer 0, the stem1 map at layer
        # 1, the layer-0 outputs at layer 2; then the dense taps' concat,
        # or (baseline) the same level two layers back.
        for i in range(L):
            if i == 0:
                cell(0, 0, False, True, False, half, 0.5)
                cell(0, 1, True, False, False, half, 0.25)
            elif i == 1:
                cell(1, 0, False, True, True, FB, 1.0)
                cell(1, 1, True, True, False, FB, 0.5)
                cell(1, 2, True, False, False, FB, 0.25)
            elif i == 2:
                cell(2, 0, False, True, True, out_ch(0), 1.0)
                cell(2, 1, True, True, True, out_ch(1), 1.0)
                cell(2, 2, True, True, False, out_ch(1), 0.5)
                cell(2, 3, True, False, False, out_ch(1), 0.25)
            else:
                if dense:
                    c_s0 = [(i - 1) * F * 2 ** lv for lv in range(NUM_LEVELS)]
                else:
                    c_s0 = [out_ch(lv) for lv in range(NUM_LEVELS)]
                    if i == 3:  # l32 has one entry: its s0 is l16 from layer 1
                        c_s0[3] = out_ch(2)
                # the reference constructs rate 0.25 at the baseline's i == 3
                # but feeds a stride-16 tensor (model_baseline_path_search.py:
                # 232-236 vs :444-448); the JAX package uses the coherent 0.5
                l32_pre = 0.5 if (not dense and i == 3) else 1.0
                cell(i, 0, False, True, True, c_s0[0], 1.0)
                cell(i, 1, True, True, True, c_s0[1], 1.0)
                cell(i, 2, True, True, True, c_s0[2], 1.0)
                cell(i, 3, True, True, False, c_s0[3], l32_pre)

        # dense taps (model_search.py:33-52): per layer 0..L-3, projections
        # of each level's output to F * 2^lv channels, the coarse levels
        # synthesized by reduction at layers 0 and 1
        nf = dict(affine=False, dtype=dtype)
        for i in range(L - 2 if dense else 0):
            if i == 0:
                mods = [ReLUConvBN(out_ch(0), F, 1, **nf), ReLUConvBN(out_ch(1), 2 * F, 1, **nf),
                        FactorizedReduce(out_ch(1), 4 * F, **nf), DoubleFactorizedReduce(out_ch(1), 8 * F, **nf)]
            elif i == 1:
                mods = [ReLUConvBN(out_ch(0), F, 1, **nf), ReLUConvBN(out_ch(1), 2 * F, 1, **nf),
                        ReLUConvBN(out_ch(2), 4 * F, 1, **nf), FactorizedReduce(out_ch(2), 8 * F, **nf)]
            else:
                mods = [ReLUConvBN(out_ch(lv), F * 2 ** lv, 1, **nf) for lv in range(NUM_LEVELS)]
            for lv, m in enumerate(mods):
                self.add_module(f"dense_preprocess_{i}_{lv}", m)

        # exit heads: 4 per station (dilations 24/12/6/3, model_search.py:138)
        prefixes = ["aspp"] if shared_exit_heads else [f"aspp_exit_{s}" for s in range(len(self.exit_stations))]
        for prefix in prefixes:
            for lv, dil in enumerate((24, 12, 6, 3)):
                self.add_module(f"{prefix}_{lv}", ASPPSearch(out_ch(lv), num_classes, dil, dtype=dtype))
        self._head_prefixes = prefixes

        # architecture parameters; init_params draws them (1e-3 * normal)
        if cell_kind == "mixed":
            self.alphas = nn.Parameter(torch.zeros(num_edges(B), len(PRIMITIVES)))
        self.betas = nn.Parameter(torch.zeros(L, NUM_LEVELS, 3))

    @property
    def exit_stations(self) -> Tuple[int, ...]:
        """The configured stations and the last layer, deduplicated."""
        out: List[int] = []
        for s in self.exit_layers_cfg + (self.num_layers - 1,):
            if s not in out:
                out.append(s)
        return tuple(out)

    def arch_parameters(self) -> List[nn.Parameter]:
        return [p for n, p in self.named_parameters() if n in ARCH_NAMES]

    def weight_parameters(self) -> Iterator[nn.Parameter]:
        return (p for n, p in self.named_parameters() if n not in ARCH_NAMES)

    # ------------------------------------------------------------- forward

    def forward(self, x: torch.Tensor, class_leading: bool = False) -> List[torch.Tensor]:
        """x: NHWC images → one fp32 logits tensor per exit station."""
        L = self.num_layers
        size = tuple(x.shape[1:3])
        # the search cell's upsample uses the even-dim rule
        # (scale_dimension_search): dims must stay odd down the whole
        # stride-4..32 chain, or the branch outputs disagree by one pixel
        for d in size:
            if (d - 1) % 64:
                raise ValueError(
                    f"supernet input dim {d} invalid: search crops need (d-1) % 64 == 0 "
                    "(e.g. 65, 129, 321) so every trellis level has odd spatial size"
                )
        x = x.permute(0, 3, 1, 2).contiguous()
        nb = normalize_betas(self.betas.float())
        alphas = choice = None
        if self.cell_kind == "mixed":
            alphas = torch.softmax(self.alphas.float(), dim=-1)
            if not self.training:
                choice = alphas.argmax(dim=-1).tolist()  # one readback a forward
        remat = self.remat and self.training and torch.is_grad_enabled()

        def run(i, lv, s0, down, same, up):
            cell = getattr(self, f"l{i}_c{lv}")
            if remat:
                cell = _checkpointed(cell, REMAT_POLICIES[self.remat_policy])
            return cell(s0, down, same, up, alphas, choice)

        def mix(*terms):  # sum of nb[idx] * branch in fp32
            out = None
            for idx, t in terms:
                y = nb[idx] * t.float()
                out = y if out is None else out + y
            return out

        temp = self.stem0_bn(self.stem0_conv(x))
        l4 = [self.stem1_bn(self.stem1_conv(F.relu(temp)))]
        l8: List = []
        l16: List = []
        l32: List = []
        taps: List[List] = [[], [], [], []]
        exit_outputs = []
        for i in range(L):
            if i == 0:
                (a,) = run(0, 0, temp, None, l4[-1], None)
                (b,) = run(0, 1, temp, l4[-1], None, None)
                news = [mix(((0, 0, 1), a)), mix(((0, 0, 2), b)), None, None]
            elif i == 1:
                a_same, a_up = run(1, 0, l4[-2], None, l4[-1], l8[-1])
                b_down, b_same = run(1, 1, l4[-2], l4[-1], l8[-1], None)
                (c_down,) = run(1, 2, l4[-2], l8[-1], None, None)
                news = [mix(((i, 0, 1), a_same), ((i, 1, 0), a_up)),
                        mix(((i, 0, 2), b_down), ((i, 1, 1), b_same)),
                        mix(((i, 1, 2), c_down)), None]
            else:
                if i == 2:
                    s0 = [l4[-2], l8[-2], l8[-2], l8[-2]]
                elif self.dense:
                    last = i == L - 1
                    s0 = [torch.cat(t if last else t[:-1], dim=1) for t in taps]
                else:
                    # baseline: the same level from two layers back
                    # (model_baseline_path_search.py:434-476); at i == 3
                    # l32 has one entry, so its s0 is l16 from layer 1
                    s0 = [l4[-2], l8[-2], l16[-2], l32[-2] if len(l32) >= 2 else l16[-2]]
                a_same, a_up = run(i, 0, s0[0], None, l4[-1], l8[-1])
                b_down, b_same, b_up = run(i, 1, s0[1], l4[-1], l8[-1], l16[-1])
                n4 = mix(((i, 0, 1), a_same), ((i, 1, 0), a_up))
                n8 = mix(((i, 0, 2), b_down), ((i, 1, 1), b_same), ((i, 2, 0), b_up))
                if i == 2:
                    c_down, c_same = run(i, 2, s0[2], l8[-1], l16[-1], None)
                    (e_down,) = run(i, 3, s0[3], l16[-1], None, None)
                    news = [n4, n8, mix(((i, 1, 2), c_down), ((i, 2, 1), c_same)), mix(((i, 2, 2), e_down))]
                else:
                    c_down, c_same, c_up = run(i, 2, s0[2], l8[-1], l16[-1], l32[-1])
                    e_down, e_same = run(i, 3, s0[3], l16[-1], l32[-1], None)
                    news = [n4, n8, mix(((i, 1, 2), c_down), ((i, 2, 1), c_same), ((i, 3, 0), c_up)),
                            mix(((i, 2, 2), e_down), ((i, 3, 1), e_same))]

            n4, n8, n16, n32 = news
            l4.append(n4)
            for hist, n in ((l8, n8), (l16, n16), (l32, n32)):
                if n is not None:
                    hist.append(n)

            # dense taps for layers 0..L-3 (model_search.py:205-208)
            if self.dense and i <= L - 3:
                src16 = n16 if n16 is not None else n8
                src32 = n32 if n32 is not None else src16
                for lv, src in enumerate((n4, n8, src16, src32)):
                    taps[lv].append(getattr(self, f"dense_preprocess_{i}_{lv}")(src))

            # history: the [-2] entries are read before layer 3 and, in the
            # baseline, at every layer
            keep = 2 if (i < 3 or not self.dense) else 1
            l4, l8, l16, l32 = l4[-keep:], l8[-keep:], l16[-keep:], l32[-keep:]

            if i in self.exit_stations:
                station = self.exit_stations.index(i)
                prefix = self._head_prefixes[0 if self.shared_exit_heads else station]
                levels = (l4[-1], l8[-1], l16[-1], l32[-1])
                exit_outputs.append([getattr(self, f"{prefix}_{lv}")(levels[lv]) for lv in range(NUM_LEVELS)])

        # sum each exit's 4 level maps after an fp32 upsample (model_search.py:600-614)
        results = []
        for outs in exit_outputs:
            summed = None
            for o in outs:
                o = resize_bilinear(o.float(), size, align_corners=True)
                summed = o if summed is None else summed + o
            results.append(summed if class_leading else summed.permute(0, 2, 3, 1))
        return results
