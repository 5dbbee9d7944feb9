"""Plain PyTorch reference of ADD and its EDM (the reference repo's
modeling/ADD.py:14-525), in float32 with TF32 off.

Written from the model's description alone: it imports nothing of the
program under test and takes nothing the program made. Weights come in as
one flat ``{name: tensor}`` dict of raw parameters (conv kernels, dense
kernels and biases, BN scale, bias and running statistics); every folding
or packing the program does at set-up is worked out again here as the
plain ops it stands for (``F.batch_norm`` in eval mode, one ``F.conv2d``
per conv). The names are the parameter names of the model as published
in this repo's configurations (``all_specs``), so one dict can be
loaded into any implementation that keeps them.

Tensors are NCHW; images come in NHWC, as the program takes them.

The model (dense ADD):
  * stems: conv3x3 s2 → BN → ReLU → conv3x3 → BN (= s0) → ReLU → conv3x3
    s2 → BN (= s1);
  * 12 cells on the level path; cell i's s1 is the previous cell's output,
    upsampled 2x first when the previous level is coarser, and projected by
    a FactorizedReduce (previous level finer) or a ReLU-conv1x1-BN; from
    cell 3 on, s0 is the 1x1 projections of the dense maps of cells
    0..i-2, resized to s1's size, concatenated and fused by one more 1x1;
    before, s0 is the cell before the previous (the stems' s0, s1 for cells
    0, 1), resized to s1's size and projected by a 1x1;
  * a cell is B blocks; block b sums the ops of its two selected edges over
    the states [s0, s1, block_0, ..., block_{b-1}]; the genotype's ops sit
    on the selected edges in row order over the edges sorted ascending;
    the output is the blocks' concat, and cells 0..n-3 also give a dense
    map, ReLU-conv1x1-BN of the concat to C channels;
  * an exit at layer i reads the cell's output (the concat of cell i),
    upsamples it to the head's stride when coarser, adapts it to the final
    level (FactorizedReduce, its stride-4 double, or a ReLU-conv1x1-BN),
    then the shared ASPP (1x1, three dilated 3x3, image pool; concat →
    1x1 → BN) and the DeepLabV3+ decoder (upsample to the low-level map,
    concat with ReLU-conv1x1(48)-BN of cell 0's output, ReLU, two 3x3
    ReLU-conv-BN, 1x1 classifier with bias, upsample to the image);
  * EDM: ReLU → conv3x3 s2 (→128) → ReLU → global mean → 128→64→32→1
    dense layers with ReLU between; an image exits at the first decision
    whose confidence is <= the threshold (rounded to float32).

Bilinear resizes are ``F.interpolate`` with align_corners=False, except the
ASPP image pool's upsample (align_corners=True); sizes scale by the
reference's rule int((d - 1) * s + 1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRIMITIVES = (
    "none", "max_pool_3x3", "avg_pool_3x3", "skip_connect",
    "sep_conv_3x3", "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5",
)
FM = (1, 2, 4, 8)  # level -> channel multiplier
ASPP_MULT = {0: 4.0, 1: 2.0, 2: 1.0, 3: 0.5}  # final level -> atrous-rate multiplier
BN_EPS = 1e-5

Weights = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str]]  # (name, shape, kind)


class Arch:
    """The structure a configuration's numbers give: the level path, the
    exits, the cells' widths and wiring, the edges' ops."""

    def __init__(self, cfg: dict):
        self.path = tuple(int(v) for v in cfg["network_path"])
        self.c_index = tuple(int(v) for v in cfg["C_index"])
        self.F, self.B = int(cfg["F"]), int(cfg["B"])
        self.num_classes = int(cfg["num_classes"])
        self.low_level_layer = int(cfg["low_level_layer"])
        n = len(self.path)
        self.n = n
        self.concat_ch = [self.B * self.F * FM[lv] for lv in self.path]
        rows = [(int(e), int(o)) for e, o in cfg["genotype"]]
        edges = sorted(e for e, _ in rows)
        self.assignment = list(zip(edges, [o for _, o in rows]))  # ops in row order on the sorted edges
        exits: List[int] = []
        for s in self.c_index + (n - 1,):
            if s not in exits:
                exits.append(s)
        self.exits = tuple(exits)
        self.final_ch = self.concat_ch[-1]

    def c_out(self, i: int) -> int:
        return self.F * FM[self.path[i]]

    def downup(self, i: int) -> int:
        return -self.path[0] if i == 0 else self.path[i - 1] - self.path[i]

    def dense_in(self, i: int) -> bool:
        return i >= 3

    def dense_out(self, i: int) -> bool:
        return i < self.n - 2

    def blocks(self) -> List[List[Tuple[int, int, str]]]:
        """Per block: (source state index, op index, primitive name) of
        its selected edges, in ascending edge order."""
        selected = dict(self.assignment)
        out, k, offset = [], 0, 0
        for b in range(self.B):
            rows = []
            for j in range(2 + b):
                if offset + j in selected:
                    rows.append((j, k, PRIMITIVES[selected[offset + j]]))
                    k += 1
            out.append(rows)
            offset += 2 + b
        return out


# ---------------------------------------------------------------- specs


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int, groups: int = 1, bias: bool = False):
    spec.append((f"{name}.kernel", (cout, cin // groups, k, k), "conv"))
    if bias:
        spec.append((f"{name}.bias", (cout,), "bias"))


def _bn(spec: Spec, name: str, c: int):
    for field in ("scale", "bias", "mean", "var"):
        spec.append((f"{name}.{field}", (c,), f"bn_{field}"))


def _rcb(spec: Spec, name: str, cin: int, cout: int, k: int = 1):
    _conv(spec, f"{name}.conv", cin, cout, k)
    _bn(spec, f"{name}.bn", cout)


def _fr(spec: Spec, name: str, cin: int, cout: int):
    _conv(spec, f"{name}.conv1", cin, cout // 2, 1)
    _conv(spec, f"{name}.conv2", cin, cout // 2, 1)
    _bn(spec, f"{name}.bn", cout)


def _op(spec: Spec, name: str, prim: str, c: int):
    if prim.startswith("sep_conv"):
        k = int(prim[-1])
        for s in (1, 2):
            _conv(spec, f"{name}.dw{s}", c, c, k, groups=c)
            _conv(spec, f"{name}.pw{s}", c, c, 1)
            _bn(spec, f"{name}.bn{s}", c)
    elif prim.startswith("dil_conv"):
        _conv(spec, f"{name}.conv", c, c, int(prim[-1]))
        _bn(spec, f"{name}.bn", c)


def model_specs(arch: Arch) -> Spec:
    """Every raw parameter of the model: (name, shape, kind)."""
    spec: Spec = []
    _conv(spec, "stems.stem0_conv", 3, 64, 3)
    _bn(spec, "stems.stem0_bn", 64)
    _conv(spec, "stems.stem1_conv", 64, 64, 3)
    _bn(spec, "stems.stem1_bn", 64)
    _conv(spec, "stems.stem2_conv", 64, 128, 3)
    _bn(spec, "stems.stem2_bn", 128)
    for i in range(arch.n):
        c = arch.c_out(i)
        c_prev = 128 if i == 0 else arch.concat_ch[i - 1]
        p = f"cell_{i}"
        if arch.downup(i) == -1:
            _fr(spec, f"{p}.preprocess", c_prev, c)
        else:
            _rcb(spec, f"{p}.preprocess", c_prev, c)
        if arch.dense_in(i):
            for j in range(i - 1):
                _rcb(spec, f"{p}.pre_{j}", arch.c_out(j), c)
            _rcb(spec, f"{p}.pre_preprocess_1x1", (i - 1) * c, c)
        else:
            _rcb(spec, f"{p}.pre_preprocess", (64, 128)[i] if i < 2 else arch.concat_ch[i - 2], c)
        if arch.dense_out(i):
            _rcb(spec, f"{p}.dense_process", arch.B * c, c)
        for k, (_, op) in enumerate(arch.assignment):
            _op(spec, f"{p}.ops_{k}", PRIMITIVES[op], c)
    _rcb(spec, "low_level_conv", arch.concat_ch[min(arch.low_level_layer, 2)], 48)
    fc = arch.final_ch
    for b, k in (("aspp1", 1), ("aspp2", 3), ("aspp3", 3), ("aspp4", 3), ("aspp5", 1)):
        _conv(spec, f"aspp.{b}_conv", fc, 256, k)
        _bn(spec, f"aspp.{b}_bn", 256)
    _conv(spec, "aspp.conv1", 5 * 256, 256, 1)
    _bn(spec, "aspp.bn1", 256)
    _conv(spec, "decoder.conv1", 256 + 48, 256, 3)
    _bn(spec, "decoder.bn1", 256)
    _conv(spec, "decoder.conv2", 256, 256, 3)
    _bn(spec, "decoder.bn2", 256)
    _conv(spec, "decoder.classifier", 256, arch.num_classes, 1, bias=True)
    for c in arch.c_index:
        diff = arch.path[c] - arch.path[-1]
        if diff == 0:
            continue
        if diff in (-1, -2):
            _fr(spec, f"conv_aspp_{c}", arch.concat_ch[c], fc)
        else:
            _rcb(spec, f"conv_aspp_{c}", arch.concat_ch[c], fc)
    return spec


def edm_specs(arch: Arch) -> Spec:
    spec: Spec = []
    _conv(spec, "conv", arch.concat_ch[arch.exits[0]], 128, 3)
    for name, cin, cout in (("fc1", 128, 64), ("fc2", 64, 32), ("fc3", 32, 1)):
        spec.append((f"{name}.kernel", (cout, cin), "dense"))
        spec.append((f"{name}.bias", (cout,), "bias"))
    return spec


# ---------------------------------------------------------------- ops


def scale_dimension(d: int, s: float) -> int:
    return int((float(d) - 1.0) * s + 1.0)


def resize(x: torch.Tensor, hw, align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(int(v) for v in hw), mode="bilinear", align_corners=align_corners)


def conv(w: Weights, name: str, x, stride=1, padding=0, dilation=1, groups=1):
    return F.conv2d(x, w[f"{name}.kernel"], w.get(f"{name}.bias"), stride, padding, dilation, groups)


def bn(w: Weights, name: str, x):
    return F.batch_norm(x, w[f"{name}.mean"], w[f"{name}.var"], w[f"{name}.scale"], w[f"{name}.bias"],
                        False, 0.0, BN_EPS)


def rcb(w: Weights, name: str, x, padding=0):
    return bn(w, f"{name}.bn", conv(w, f"{name}.conv", F.relu(x), padding=padding))


def factorized_reduce(w: Weights, name: str, x, stride: int = 2, shift: int = 1):
    x = F.relu(x)
    y = F.pad(x[:, :, shift:, shift:], (0, shift, 0, shift))
    return bn(w, f"{name}.bn", torch.cat([conv(w, f"{name}.conv1", x, stride),
                                          conv(w, f"{name}.conv2", y, stride)], dim=1))


def edge_op(w: Weights, name: str, prim: str, x):
    if prim == "none":
        return torch.zeros_like(x)
    if prim == "skip_connect":
        return x
    if prim == "max_pool_3x3":
        return F.max_pool2d(x, 3, 1, 1)
    if prim == "avg_pool_3x3":
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    k = int(prim[-1])
    if prim.startswith("sep_conv"):
        c = x.shape[1]
        for s in (1, 2):
            x = conv(w, f"{name}.dw{s}", F.relu(x), padding=k // 2, groups=c)
            x = bn(w, f"{name}.bn{s}", conv(w, f"{name}.pw{s}", x))
        return x
    return bn(w, f"{name}.bn", conv(w, f"{name}.conv", F.relu(x), padding=k - 1, dilation=2))


# ---------------------------------------------------------------- model


class Reference:
    """The plain ADD + EDM over raw weights ``model`` and ``edm``."""

    def __init__(self, cfg: dict, model: Weights, edm: Weights):
        self.arch = Arch(cfg)
        self.w, self.edm_w = model, edm

    # --- segments
    def stem(self, x_nhwc: torch.Tensor) -> dict:
        w = self.w
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(bn(w, "stems.stem0_bn", conv(w, "stems.stem0_conv", x, 2, 1)))
        s0 = bn(w, "stems.stem1_bn", conv(w, "stems.stem1_conv", x, 1, 1))
        s1 = bn(w, "stems.stem2_bn", conv(w, "stems.stem2_conv", F.relu(s0), 2, 1))
        return {"pp": s0, "p": s1, "x": None, "dense": [], "low": None}

    def cell(self, i: int, s0, s1):
        a, w, p = self.arch, self.w, f"cell_{i}"
        if a.downup(i) == 1:
            h, wd = s1.shape[2:]
            s1 = resize(s1, (scale_dimension(h, 2), scale_dimension(wd, 2)))
        s1 = factorized_reduce(w, f"{p}.preprocess", s1) if a.downup(i) == -1 else rcb(w, f"{p}.preprocess", s1)
        hw = s1.shape[2:]
        if a.dense_in(i):
            taps = [rcb(w, f"{p}.pre_{j}", resize(t, hw)) for j, t in enumerate(s0)]
            s0 = rcb(w, f"{p}.pre_preprocess_1x1", torch.cat(taps, dim=1))
        else:
            s0 = rcb(w, f"{p}.pre_preprocess", resize(s0, hw))
        states = [s0, s1]
        for rows in a.blocks():
            outs = [edge_op(w, f"{p}.ops_{k}", prim, states[j]) for j, k, prim in rows]
            states.append(sum(outs[1:], outs[0]))
        concat = torch.cat(states[-a.B:], dim=1)
        fmap = rcb(w, f"{p}.dense_process", concat) if a.dense_out(i) else None
        return concat, fmap

    def cells(self, st: dict, start: int, end: int) -> dict:
        a = self.arch
        st = dict(st, dense=list(st["dense"]))
        for i in range(start, end + 1):
            if a.dense_in(i):
                taps = st["dense"] if i == a.n - 1 else st["dense"][:-1]
                concat, fmap = self.cell(i, taps, st["x"])
                st["x"] = concat
            else:
                concat, fmap = self.cell(i, st["pp"], st["p"])
                st["pp"], st["p"] = st["p"], concat
                if i == 2:
                    st["x"] = concat
            if fmap is not None:
                st["dense"].append(fmap)
            if i == a.low_level_layer:
                st["low"] = rcb(self.w, "low_level_conv", st["p"])
        return st

    def feature(self, st: dict, i: int) -> torch.Tensor:
        return st["x"] if i > 2 else st["p"]

    def head(self, st: dict, i: int, size) -> torch.Tensor:
        """Logits (N, classes, H, W) at exit layer i."""
        a, w = self.arch, self.w
        scale = 2.0 ** -(a.path[-1] + 2)
        hw = (scale_dimension(size[0], scale), scale_dimension(size[1], scale))
        y = self.feature(st, i)
        if y.shape[2] < hw[0] or y.shape[3] < hw[1]:
            y = resize(y, hw)
        diff = a.path[i] - a.path[-1]
        if i in a.c_index and diff != 0:
            if diff == -1:
                y = factorized_reduce(w, f"conv_aspp_{i}", y)
            elif diff == -2:
                y = factorized_reduce(w, f"conv_aspp_{i}", y, stride=4, shift=2)
            else:
                y = rcb(w, f"conv_aspp_{i}", y)
        y = self.aspp(y)
        y = resize(y, st["low"].shape[2:])
        y = F.relu(torch.cat([y, st["low"]], dim=1))
        y = F.relu(bn(w, "decoder.bn1", conv(w, "decoder.conv1", y, padding=1)))
        y = F.relu(bn(w, "decoder.bn2", conv(w, "decoder.conv2", y, padding=1)))
        y = conv(w, "decoder.classifier", y)
        return resize(y, size)

    def aspp(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        mult = ASPP_MULT[self.arch.path[-1]]
        x = F.relu(x)
        out = [F.relu(bn(w, "aspp.aspp1_bn", conv(w, "aspp.aspp1_conv", x)))]
        for name, r in (("aspp2", 6), ("aspp3", 12), ("aspp4", 18)):
            d = int(r * mult)
            out.append(F.relu(bn(w, f"aspp.{name}_bn", conv(w, f"aspp.{name}_conv", x, padding=d, dilation=d))))
        pool = F.relu(bn(w, "aspp.aspp5_bn", conv(w, "aspp.aspp5_conv", x.mean(dim=(2, 3), keepdim=True))))
        out.append(resize(pool, x.shape[2:], align_corners=True))
        return bn(w, "aspp.bn1", conv(w, "aspp.conv1", torch.cat(out, dim=1)))

    def edm(self, feature: torch.Tensor) -> torch.Tensor:
        """The EDM's confidence, one per image."""
        w = self.edm_w
        x = F.relu(conv(w, "conv", F.relu(feature), 2, 1)).mean(dim=(2, 3))
        x = F.relu(F.linear(x, w["fc1.kernel"], w["fc1.bias"]))
        x = F.relu(F.linear(x, w["fc2.kernel"], w["fc2.bias"]))
        return F.linear(x, w["fc3.kernel"], w["fc3.bias"])[:, 0]

    # --- the engine's segments
    def decide(self, k: int, carry, size=None) -> Tuple[dict, torch.Tensor]:
        """decide_k: (the stem and) the cells up to exit k, and the EDM's
        confidence there."""
        e = self.arch.exits[k]
        st = self.stem(carry) if k == 0 else carry
        st = self.cells(st, 0 if k == 0 else self.arch.exits[k - 1] + 1, e)
        return st, self.edm(self.feature(st, e))

    def final(self, carry: dict, size) -> torch.Tensor:
        a = self.arch
        st = self.cells(carry, a.exits[-2] + 1, a.exits[-1])
        return self.head(st, a.exits[-1], size)

    @torch.no_grad()
    def infer(self, x_nhwc: torch.Tensor, threshold: float):
        """(logits (1, classes, H, W), exit index, every confidence taken)
        for one image, stopping at the first decision whose confidence is
        <= the threshold rounded to float32."""
        a = self.arch
        size = tuple(x_nhwc.shape[1:3])
        thr = float(np.float32(threshold))
        carry, confs = x_nhwc, []
        for k in range(len(a.exits) - 1):
            carry, conf = self.decide(k, carry)
            confs.append(conf)
            if float(conf[0]) <= thr:
                return self.head(carry, a.exits[k], size), k, confs
        return self.final(carry, size), len(a.exits) - 1, confs


def reference_numerics():
    """float32 with TF32 off, for every conv and matmul that follows."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def segment_names(arch: Arch) -> List[str]:
    k = len(arch.exits) - 1
    return [f"decide_{i}" for i in range(k)] + [f"head_{i}" for i in range(k)] + ["final"]


def image_segments(arch: Arch, exit_index: int) -> List[str]:
    """The segments an image that exits at ``exit_index`` runs."""
    last = len(arch.exits) - 1
    decides = [f"decide_{i}" for i in range(min(exit_index, last - 1) + 1)]
    return decides + ([f"head_{exit_index}"] if exit_index < last else ["final"])


def split_weights(flat: Weights) -> Tuple[Weights, Weights]:
    """The flat dict's ``model.`` and ``edm.`` parts."""
    model = {k[len("model."):]: v for k, v in flat.items() if k.startswith("model.")}
    edm = {k[len("edm."):]: v for k, v in flat.items() if k.startswith("edm.")}
    return model, edm


def all_specs(arch: Arch) -> Spec:
    return ([(f"model.{n}", s, k) for n, s, k in model_specs(arch)]
            + [(f"edm.{n}", s, k) for n, s, k in edm_specs(arch)])

