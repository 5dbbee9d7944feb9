"""The port's cell kernels' plain versions (kernels/cell_ops.py) and the
``--cell-exec flat`` path against the JAX package, on the CPU, at small odd
sizes (C=8, 13x17; the tiny ADD at F=4), with the same numpy inputs and
weights. On a CPU tensor every wrapper runs its plain version; the kernels
themselves are held against those on the card by tests/test_torch_gpu.py
and chip_smoke.py.

Tolerances: single ops and blocks |Δ| ≤ 2e-5 (fp32); a cell's DAG
|Δ| ≤ 3e-5·max(1, max|ref|) (fp32): tests/test_cell_ops.py holds the
Pallas path to 3e-5 where its states stay below ~10, and these seeded
weights take one DAG's last block to ~200, where fp32 rounding alone
reaches 5e-5 (the port's unfused cell misses an absolute 3e-5 there too);
whole-model fp32 per-exit logits |Δ| ≤ 1e-3·max|ref|; bf16: the port's
relative error vs the JAX fp32 oracle ≤ 2x the JAX bf16 path's own plus
1e-3; the bf16 DAG against the Pallas kernels in interpret mode (the one
interpret case, C=8): ≥ 95% of values bitwise equal and |Δ| ≤ 2^-7·max|ref|
(one bf16 unit where a sum taken in another order moves a rounding);
engine exit indices exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.cli import evaluate as pt_cli
from auto_dynamic_deeplab_torch.kernels import cell_ops as pt_cell
from auto_dynamic_deeplab_torch.ops.primitives import OPS as PT_OPS
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine as PtEngine
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.kernels.cell_ops import FlatSpec, from_flat, run_dag_flat, to_flat
from auto_dynamic_deeplab_tpu.models.cell import as_genotype_rows, edge_op_assignment
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.nas.genotypes import PRIMITIVES
from auto_dynamic_deeplab_tpu.ops.packed import _block_edges
from auto_dynamic_deeplab_tpu.ops.primitives import OPS as JX_OPS

from torch_port_helpers import (
    assert_bf16_within_jax,
    assert_close_fp32_model,
    flax_variables,
    jx,
    nchw,
    nhwc_np,
    port_module,
    tf32,
)

C, H, W = 8, 13, 17
CONV_OPS = ["sep_conv_3x3", "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5"]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ops(names, seed):
    """(JAX op, its seeded variables, the port op with them) per name."""
    out = []
    for i, name in enumerate(names):
        jm = JX_OPS[name](C, 1)
        v = flax_variables(jm, jnp.zeros((1, H, W, C)), False, seed=seed + i)
        out.append((jm, v, port_module(PT_OPS[name](C, 1), v)))
    return out


def _close(out, ref, atol):
    np.testing.assert_allclose(nhwc_np(out), np.asarray(ref), atol=atol, rtol=0)


# ------------------------------------------------------------ single ops


@pytest.mark.parametrize("name", CONV_OPS)
def test_plain_ops_match_jax_op(name):
    """sep_fused, two sep_stage passes and dense_stage (plain versions on
    the CPU) against the JAX primitive."""
    x = _x((1, H, W, C), seed=1)
    ((jm, v, pm),) = _ops([name], seed=3)
    ref = jm.apply(v, jx(x), False)
    w = pt_cell.edge_weights(pm, name, torch.float32)
    xt = nchw(x)
    launches = {f: getattr(pt_cell, f).launches for f in ("sep_fused", "sep_stage", "dense_stage")}
    if name.startswith("dil"):
        _close(pt_cell.dense_stage(xt, name, w), ref, 2e-5)
    else:
        _close(pt_cell.sep_fused(xt, name, w), ref, 2e-5)
        mid = pt_cell.sep_stage(xt, name, w[0], in_relu=True, out_relu=True)
        _close(pt_cell.sep_stage(mid, name, w[1], in_relu=False, out_relu=False), ref, 2e-5)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert launches == {f: getattr(pt_cell, f).launches for f in launches}


@pytest.mark.parametrize("names", [("dil_conv_5x5",), ("dil_conv_5x5", "sep_conv_3x3"),
                                   ("skip_connect", "sep_conv_5x5")])
def test_block_stage_matches_jax_ops(names):
    """A one- and two-edge block, each edge on its own source, summed."""
    xs = [_x((1, H, W, C), seed=10 + i) for i in range(len(names))]
    ref = 0.0
    edges = []
    for x, name, op in zip(xs, names, _ops(names, seed=20)):
        jm, v, pm = op
        ref = ref + (jx(x) if name == "skip_connect" else jm.apply(v, jx(x), False))
        edges.append((nchw(x), name, pt_cell.edge_weights(pm, name, torch.float32)))
    _close(pt_cell.block_stage(edges), ref, 2e-5)
    out = torch.zeros(1, H, W, 3 * C).permute(0, 3, 1, 2)
    got = pt_cell.block_stage(edges, out=out[:, C:2 * C])
    assert got.data_ptr() == out[:, C:2 * C].data_ptr()
    _close(out[:, C:2 * C], ref, 2e-5)


def test_edge_weights_fold_in_fp32_and_refold_on_change():
    (_, _, pm), = _ops(["sep_conv_3x3"], seed=5)
    w1, w2 = pt_cell.edge_weights(pm, "sep_conv_3x3", torch.bfloat16)
    s, _ = pm.bn1.folded()
    want = (pm.pw1.kernel[:, :, 0, 0] * s[:, None]).to(torch.bfloat16).t()
    assert w1.pw.dtype == torch.bfloat16 and torch.equal(w1.pw[:, :C], want)
    assert w1.pw.shape == (C, 8) and w1.dwk.dtype == w1.bias.dtype == torch.float32
    assert pt_cell.edge_weights(pm, "sep_conv_3x3", torch.bfloat16)[0] is w1  # kept
    with torch.no_grad():
        pm.bn2.var.mul_(2.0)  # a statistic changes in place: folded again
    assert not torch.equal(pt_cell.edge_weights(pm, "sep_conv_3x3", torch.bfloat16)[1].pw, w2.pw)


def test_pixel_layout_takes_channels_last_and_slices_only():
    buf = torch.zeros(2, 5, 7, 24).permute(0, 3, 1, 2)
    assert pt_cell._pixel_layout(buf[:, 8:16], buf[:, :8], "x") == (5 * 7 * 24, 24)
    with pytest.raises(ValueError, match="channels_last"):
        pt_cell._pixel_layout(torch.zeros(2, 8, 5, 7), buf[:, :8], "x")
    with pytest.raises(ValueError, match="does not match"):
        pt_cell._pixel_layout(buf[:, :8].to(torch.bfloat16), buf[:, :8], "x")


# ------------------------------------------------------------- cell DAG


def _random_genotype(seed: int, B: int = 5):
    """As tests/test_cell_ops.py builds them: 2 edges a block, any op."""
    rng = np.random.RandomState(seed)
    rows = []
    for edges in _block_edges(B):
        for e in rng.choice(edges, size=2, replace=False):
            rows.append([int(e), int(rng.randint(0, 8))])
    return np.array(rows, dtype=np.int64)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_run_dag_matches_jax_dag(seed):
    """run_dag (K3 routes and the per-op branch with pools, skip and none)
    against the JAX primitives run as the unfused FixedCell DAG."""
    assignment = edge_op_assignment(as_genotype_rows(_random_genotype(seed)))
    names = [PRIMITIVES[o] for _, o in assignment]
    assert {"skip_connect", "none"} & set(names) and any("pool" in n for n in names)
    s0, s1 = _x((1, H, W, C), seed=seed), _x((1, H, W, C), seed=seed + 10)
    ops = _ops(names, seed=100 * seed)
    selected, states, it, offset = dict(assignment), [jx(s0), jx(s1)], iter(ops), 0
    for _ in range(5):
        outs = []
        for j in range(len(states)):
            if offset + j in selected:
                jm, v, _ = next(it)
                outs.append(jm.apply(v, states[j], False))
        states.append(sum(outs))
        offset += len(states) - 1
    want = jnp.concatenate(states[2:], axis=-1)
    got = pt_cell.run_dag(nchw(s0), nchw(s1), assignment, 5, [pm for _, _, pm in ops])
    assert got.shape == (1, 5 * C, H, W) and got.is_contiguous(memory_format=torch.channels_last)
    _close(got, want, 3e-5 * max(1.0, float(jnp.abs(want).max())))


def test_run_dag_bf16_matches_pallas_interpret():
    """The flagship genotype's DAG in bf16 against the Pallas kernels
    themselves (interpret mode): the port rounds where they round."""
    assignment = edge_op_assignment(as_genotype_rows(AUTODEEPLAB_GENOTYPE))
    ops = _ops([PRIMITIVES[o] for _, o in assignment], seed=50)
    s0, s1 = _x((1, H, W, C), seed=7), _x((1, H, W, C), seed=8)
    spec = FlatSpec(H=H, W=W, chunk=256)
    flat = [to_flat(jnp.asarray(s, jnp.bfloat16), spec) for s in (s0, s1)]
    blocks = run_dag_flat(*flat, assignment, 5, [v for _, v, _ in ops], PRIMITIVES, spec, interpret=True)
    want = np.asarray(jnp.concatenate([from_flat(b, C, spec) for b in blocks], axis=-1), np.float32)
    got = pt_cell.run_dag(nchw(s0).to(torch.bfloat16), nchw(s1).to(torch.bfloat16), assignment, 5,
                          [pm for _, _, pm in ops])
    diff = np.abs(nhwc_np(got) - want)
    assert (diff == 0).mean() >= 0.95
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max()


# (dtype, C) -> the kernels each flagship block launches, as block_route plans them
K3 = ("block_stage",)
FLAGSHIP_ROUTES = {
    ("fp32", 40): [K3] * 5,
    ("fp32", 80): [K3] * 5,
    ("fp32", 160): [K3] * 3 + [("sep_stage",) * 4, ("dense_stage", "sep_stage", "sep_stage")],
    ("bf16", 40): [K3] * 5,
    ("bf16", 80): [K3] * 5,
    ("bf16", 160): [K3] * 5,
}


@pytest.mark.parametrize("key", sorted(FLAGSHIP_ROUTES))
def test_routes_at_flagship_widths(key):
    """The plans at the DAG widths of the flagship at 1025x2049: every
    block is one K3 launch, except (sep5, sep5) and (dil5, sep5) at C=160
    in fp32, whose sep5 needs 266 KB on K3's 8x8 tile at its narrowest
    slice; there each sep5 is two K5 passes and the dil5 one K6."""
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[key[0]]
    assignment = edge_op_assignment(as_genotype_rows(AUTODEEPLAB_GENOTYPE))
    routes = [pt_cell.block_route([PRIMITIVES[p] for _, _, p in rows], key[1], dtype)
              for rows in pt_cell.dag_blocks(assignment, 5)]
    assert routes == FLAGSHIP_ROUTES[key]
    for names in (("dil_conv_5x5", "sep_conv_5x5"), ("sep_conv_3x3",), ("skip_connect", "dil_conv_3x3")):
        plan = pt_cell.plan_block(names, key[1], dtype)
        assert plan is None or plan.smem <= pt_cell.SMEM_LIMIT
    assert pt_cell.plan_sep_fused("sep_conv_5x5", 160, torch.float32) is None
    plan = pt_cell.plan_sep_stage("sep_conv_5x5", 160, torch.float32)
    assert (plan.tile, plan.ns) == ((8, 8), 40) and plan.smem <= pt_cell.SMEM_LIMIT
    plan = pt_cell.plan_dense_stage("dil_conv_5x5", 320, torch.float32)
    assert (plan.tile, plan.ns) == ((2, 8), 8) and plan.smem <= pt_cell.SMEM_LIMIT


# ------------------------------------------------- K6 (tensor-core) host side


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [5, 12, 40])
def test_k6_packed_weights_unpack_exactly(c, dtype):
    """K6's packed B operand (k*k, O8, Cpad) holds q and the folded conv
    weight exactly, with zeros in the padded rows and channels."""
    torch.manual_seed(c)
    pm = PT_OPS["dil_conv_5x5"](c, 1)
    with torch.no_grad():
        for p in pm.parameters():
            p.normal_()
        pm.bn.mean.normal_()
        pm.bn.var.uniform_(0.5, 2.0)
    w = pt_cell.edge_weights(pm, "dil_conv_5x5", dtype)
    o8, cpad = -(-c // 8) * 8, pt_cell.dense_cpad(c, dtype)
    assert w.packed.shape == (25, o8, cpad) and w.packed.dtype == dtype and w.packed.is_contiguous()
    assert cpad * torch.finfo(dtype).bits // 8 % 32 == 0
    assert torch.equal(w.packed[:, :, :c].transpose(1, 2), w.q)
    s, _ = pm.bn.folded()
    conv = (pm.conv.kernel.float() * s[:, None, None, None]).to(dtype)  # (O, C, k, k)
    assert torch.equal(w.packed[:, :c, :c].reshape(5, 5, c, c).permute(2, 3, 0, 1), conv)
    assert not w.packed[:, c:].any() and not w.packed[:, :, c:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [40, 80, 160])
def test_k6_plans_at_flagship_widths(c, dtype):
    """At the flagship's DAG widths K6 fits 227 KB, keeps an 8x8 tile, and
    at level 3 (C=160, 33x65) splits its output channels so that the
    grid fills the 132 SMs."""
    hw = {40: (129, 257), 80: (65, 129), 160: (33, 65)}[c]
    for name in ("dil_conv_3x3", "dil_conv_5x5"):
        plan = pt_cell.plan_dense_stage(name, c, dtype, hw, 1)
        assert plan.tile == (8, 8) and plan.smem <= pt_cell.SMEM_LIMIT
        assert plan.ns % 8 == 0 and (-(-c // 8) * 8) % plan.ns == 0 and plan.ns <= pt_cell.DENSE_NS_MAX
        assert pt_cell.dense_blocks(plan, c, 1, *hw) >= pt_cell.SM_COUNT
        assert plan.smem == pt_cell._dense_smem(name, c, dtype, 8, 8, plan.ns)
    plan = pt_cell.plan_dense_stage("dil_conv_5x5", 160, dtype, (33, 65), 1)
    assert plan.ns < 160 and pt_cell.dense_blocks(plan, 160, 1, 33, 65) == 45 * (160 // plan.ns)


def test_k6_plans_cover_the_cuda_core_kernels_widths():
    """Every width the CUDA-core K6 (one window of (C|1)-pitched pixels on
    a STAGE_TILES tile) took still has a plan: the new K6 refuses nothing new."""
    for dtype in (torch.float32, torch.bfloat16):
        eb = torch.finfo(dtype).bits // 8
        for name in ("dil_conv_3x3", "dil_conv_5x5"):
            reach = 2 * (int(name[-1]) // 2)
            old = [c for c in range(1, 1200)
                   if any((th + 2 * reach) * (tw + 2 * reach) * (c | 1) * eb <= pt_cell.SMEM_LIMIT
                          for th, tw in pt_cell.STAGE_TILES)]
            assert old and all(pt_cell.plan_dense_stage(name, c, dtype) is not None for c in old), name


def test_k6_3xtf32_split_holds_fp32_tolerance():
    """K6's fp32 scheme, emulated: ReLU'd inputs and weights split into
    tf32 hi + lo, the products lo*hi + hi*lo + hi*hi accumulated in fp32,
    at dil5, C=160, 9x11, against an fp64 conv. It holds relative 1e-4;
    plain TF32 (hi*hi alone) is two orders of magnitude further off."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 160, 9, 11).astype(np.float32)).relu()
    w = torch.from_numpy((rng.randn(160, 160, 5, 5) / 40).astype(np.float32))
    ref = torch.nn.functional.conv2d(x.double(), w.double(), dilation=2, padding=4)

    def conv(a, b):
        return torch.nn.functional.conv2d(a, b, dilation=2, padding=4)

    xh, wh = tf32(x), tf32(w)
    xl, wl = tf32(x - xh), tf32(w - wh)
    assert torch.equal(tf32(xh), xh) and (xh.view(torch.int32) & 0x1FFF).eq(0).all()
    three = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    scale = ref.abs().max().item()
    err3 = (three.double() - ref).abs().max().item() / scale
    err1 = (conv(xh, wh).double() - ref).abs().max().item() / scale
    assert err3 <= 1e-4 and err3 * 100 <= err1


# ------------------------------------------- K3/K4 (tensor-core) host side


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [5, 12, 40])
def test_k3_packed_pw_weights_unpack_exactly(c, dtype):
    """A SepConv stage's packed B operand (1, O8, Cpad) holds pw and the
    folded pointwise weight exactly, zeros in the padded rows and channels."""
    torch.manual_seed(c)
    pm = PT_OPS["sep_conv_3x3"](c, 1)
    with torch.no_grad():
        for p in pm.parameters():
            p.normal_()
        for bn in (pm.bn1, pm.bn2):
            bn.mean.normal_()
            bn.var.uniform_(0.5, 2.0)
    o8, cpad = -(-c // 8) * 8, pt_cell.dense_cpad(c, dtype)
    for st, pw, bn in zip(pt_cell.edge_weights(pm, "sep_conv_3x3", dtype), (pm.pw1, pm.pw2), (pm.bn1, pm.bn2)):
        assert st.packed.shape == (1, o8, cpad) and st.packed.dtype == dtype and st.packed.is_contiguous()
        assert torch.equal(st.packed[0, :, :c].t(), st.pw)
        s, _ = bn.folded()
        assert torch.equal(st.packed[0, :c, :c], (pw.kernel[:, :, 0, 0].float() * s[:, None]).to(dtype))
        assert not st.packed[:, c:].any() and not st.packed[:, :, c:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [40, 80, 160])
def test_k3_plans_at_flagship_widths(c, dtype):
    """Every flagship block K3 takes fits 227 KB with the grid weighed at
    its level's size; at levels 2 and 3 its output channels split so that
    the grid has at least one block for each of the 132 SMs. K4's plan is
    K3's for its one sep edge."""
    hw = {40: (129, 257), 80: (65, 129), 160: (33, 65)}[c]
    assignment = edge_op_assignment(as_genotype_rows(AUTODEEPLAB_GENOTYPE))
    taken = 0
    for rows in pt_cell.dag_blocks(assignment, 5):
        names = [PRIMITIVES[p] for _, _, p in rows]
        plan = pt_cell.plan_block(names, c, dtype, hw, 1)
        if plan is None:
            assert pt_cell.block_route(names, c, dtype) != ("block_stage",)
            continue
        taken += 1
        assert plan.tile == (8, 8) and plan.smem <= pt_cell.SMEM_LIMIT and plan.ng in (1, 2)
        assert plan.ns % 8 == 0 and (-(-c // 8) * 8) % plan.ns == 0 and plan.ns <= pt_cell.DENSE_NS_MAX
        assert plan.smem == pt_cell._mma_smem(names, c, dtype, 8, 8, plan.ns, plan.ng)
        if c >= 80:
            assert pt_cell.dense_blocks(plan, c, 1, *hw) >= pt_cell.SM_COUNT
    assert taken == (3 if (c, dtype) == (160, torch.float32) else 5)
    assert pt_cell.plan_sep_fused("sep_conv_3x3", c, dtype, hw) == pt_cell.plan_block(["sep_conv_3x3"], c, dtype, hw)


def test_k3_plans_cover_the_cuda_core_kernels_widths():
    """Every block and width the CUDA-core K3 (an fp32 sum tile plus the
    largest edge's (C|1)-pitched windows on an 8x16 or 8x8 tile) took
    still has a plan: the new K3 refuses nothing new."""

    def window(h, w, c, eb):
        return -(-h * w * (c | 1) * eb // 16) * 16

    def old_edge(name, c, eb, th, tw):
        kind, k, dil = pt_cell.EDGE_KINDS[name]
        if kind == "sep":
            r = k // 2
            return window(th + 4 * r, tw + 4 * r, c, eb) + window(th + 2 * r, tw + 2 * r, c, eb)
        return window(th + 2 * dil * (k // 2), tw + 2 * dil * (k // 2), c, eb) if kind == "dil" else 0

    names = list(pt_cell.EDGE_KINDS)
    blocks = [(a,) for a in names] + [(a, b) for i, a in enumerate(names) for b in names[i:]]
    for dtype in (torch.float32, torch.bfloat16):
        eb = torch.finfo(dtype).bits // 8
        for block in blocks:
            old = [c for c in range(1, 1200, 3)
                   if any(-(-th * tw * c * 4 // 16) * 16 + max(old_edge(n, c, eb, th, tw) for n in block)
                          <= pt_cell.SMEM_LIMIT for th, tw in ((8, 16), (8, 8)))]
            assert old and all(pt_cell.plan_block(block, c, dtype) is not None for c in old), block


def test_k3_3xtf32_split_holds_fp32_tolerance_on_a_pointwise_product():
    """K3's fp32 pointwise product, emulated: a depthwise output (either
    sign, not ReLU'd) and the weights split into tf32 hi + lo, lo*hi +
    hi*lo + hi*hi summed in fp32, one tap at K = C = 160 over 9x11 pixels,
    against fp64. It holds relative 1e-4; plain TF32 is far further off."""
    rng = np.random.RandomState(1)
    d = torch.from_numpy(rng.randn(99, 160).astype(np.float32))
    w = torch.from_numpy((rng.randn(160, 160) / 13).astype(np.float32))
    ref = d.double() @ w.double().t()
    dh, wh = tf32(d), tf32(w)
    dl, wl = tf32(d - dh), tf32(w - wh)
    three = dl @ wh.t() + dh @ wl.t() + dh @ wh.t()
    scale = ref.abs().max().item()
    err3 = (three.double() - ref).abs().max().item() / scale
    err1 = (dh @ wh.t()).double().sub(ref).abs().max().item() / scale
    assert err3 <= 1e-4 and err3 * 100 <= err1


# ------------------------------------------------ K5 (tensor-core) host side


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k5_plans_at_flagship_widths(dtype):
    """At the flagship's DAG widths K5's plan fits 227 KB, and its grid
    (tiles x N-slices) has at least one block for each of the 132 SMs, at
    level 3 (C=160, 33x65) too; its shared memory does not grow with C."""
    for c, hw in ((40, (129, 257)), (80, (65, 129)), (160, (33, 65))):
        for name in ("sep_conv_3x3", "sep_conv_5x5"):
            plan = pt_cell.plan_sep_stage(name, c, dtype, hw, 1)
            assert plan.tile in pt_cell.SEP_STAGE_TILES and plan.ng in (1, 2)
            assert plan.smem == pt_cell._stage_smem(name, *plan.tile, plan.ns) <= pt_cell.SMEM_LIMIT
            assert plan.ns % 8 == 0 and (-(-c // 8) * 8) % plan.ns == 0 and plan.ns <= pt_cell.DENSE_NS_MAX
            assert pt_cell.dense_blocks(plan, c, 1, *hw) >= pt_cell.SM_COUNT, (c, name)
        wide, narrow = (pt_cell.plan_sep_stage("sep_conv_5x5", cc, dtype) for cc in (1160, c))
        assert wide.smem == narrow.smem


def test_k5_plans_cover_the_cuda_core_kernels_widths():
    """Every width and k the CUDA-core K5 (its input window with a k//2
    halo plus the depthwise tile, both at a (C|1) pitch, on a STAGE_TILES
    tile) took still has a plan, in both dtypes: the new K5 refuses
    nothing new."""

    def window(h, w, c, eb):
        return -(-h * w * (c | 1) * eb // 16) * 16

    for dtype in (torch.float32, torch.bfloat16):
        eb = torch.finfo(dtype).bits // 8
        for name in ("sep_conv_3x3", "sep_conv_5x5"):
            r = int(name[-1]) // 2
            old = [c for c in range(1, 1200)
                   if any(window(th + 2 * r, tw + 2 * r, c, eb) + window(th, tw, c, eb) <= pt_cell.SMEM_LIMIT
                          for th, tw in pt_cell.STAGE_TILES)]
            assert old and all(pt_cell.plan_sep_stage(name, c, dtype) is not None for c in old), (name, dtype)
            assert all(pt_cell.plan_sep_stage(name, c, dtype, (33, 65), 2) is not None for c in old[::37])


def _k5_emulated(x, w, plan, in_relu, out_relu, three=True):
    """K5's fp32 arithmetic as the kernel runs it, in torch: for each th x
    tw tile and N-slice, the input channels in 128-byte chunks (32 fp32):
    the chunk's raw window (tile plus a k//2 halo, 0 outside the image and
    past C, ReLU'd at the read), its depthwise in fp32, then its 3xTF32
    product with the chunk's packed weights (lo*hi + hi*lo and hi*hi in two
    fp32 sums; plain TF32, hi*hi alone, without ``three``), added once to
    the bias at the end, ReLU'd by flag."""
    N, C, H, W = x.shape
    (th, tw), ns, r = plan.tile, plan.ns, w.k // 2
    ch, cpad = pt_cell.STAGE_CHUNK // 4, pt_cell.dense_cpad(C, torch.float32)
    src = x.relu() if in_relu else x
    xp = torch.nn.functional.pad(src, (r, r + tw, r, r + th, 0, cpad - C))  # halo, ragged tiles, pad channels
    dwk = torch.nn.functional.pad(w.dwk, (0, 0, 0, cpad - C)).view(cpad, 1, w.k, w.k)
    packed = w.packed[0]
    out = torch.zeros(N, packed.shape[0], -(-H // th) * th, -(-W // tw) * tw)
    for ty in range(0, H, th):
        for tx in range(0, W, tw):
            for n0 in range(0, packed.shape[0], ns):
                acc = acc_lo = torch.zeros(N, th * tw, ns)
                for ch0 in range(0, cpad, ch):
                    cw = min(ch, cpad - ch0)
                    win = xp[:, ch0:ch0 + cw, ty:ty + th + 2 * r, tx:tx + tw + 2 * r]
                    a = torch.nn.functional.conv2d(win, dwk[ch0:ch0 + cw], groups=cw).flatten(2).transpose(1, 2)
                    b = packed[n0:n0 + ns, ch0:ch0 + cw]
                    ah, bh = tf32(a), tf32(b)
                    al, bl = (tf32(a - ah), tf32(b - bh)) if three else (0 * a, 0 * b)
                    acc_lo = acc_lo + al @ bh.t() + ah @ bl.t()
                    acc = acc + ah @ bh.t()
                y = acc_lo + acc + w.bias[n0:n0 + ns]
                y = y.relu() if out_relu else y
                out[:, n0:n0 + ns, ty:ty + th, tx:tx + tw] = y.transpose(1, 2).reshape(N, ns, th, tw)
    return out[:, :C, :H, :W]


@pytest.mark.parametrize("relus", [(True, True), (False, False)], ids=["relu", "norelu"])
@pytest.mark.parametrize("name,tile,ns", [("sep_conv_5x5", (8, 8), 40), ("sep_conv_3x3", (4, 8), 8),
                                          ("sep_conv_5x5", (8, 8), 8)])
def test_k5_chunked_3xtf32_emulated_matches_plain(name, tile, ns, relus):
    """K5's fp32 scheme emulated (chunked depthwise, 3xTF32 pointwise) at
    C=37 (chunks of 32 + 8 channels, O8 = 40), 13 x 17 at N=2 (tiles run
    past the image on both axes), against the plain version: relative
    1e-4; plain TF32 products are two orders of magnitude further off."""
    c = 37
    torch.manual_seed(7)
    pm = PT_OPS[name](c, 1)
    with torch.no_grad():
        for p in pm.parameters():
            p.normal_()
        pm.bn1.mean.normal_()
        pm.bn1.var.uniform_(0.5, 2.0)
    w = pt_cell.edge_weights(pm, name, torch.float32)[0]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, c, 13, 17).astype(np.float32))
    plan = pt_cell.Plan(tile, pt_cell._stage_smem(name, *tile, ns), ns)
    ref = pt_cell.sep_stage_reference(x, w, *relus)
    err3, err1 = ((_k5_emulated(x, w, plan, *relus, three=t) - ref).abs().max().item() / ref.abs().max().item()
                  for t in (True, False))
    assert err3 <= 1e-4 and err3 * 100 <= err1


# ----------------------------------------------------------- whole model

PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)


def _pt_add(variables, dtype=None, flat_eval=True):
    return port_module(
        pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, dtype=dtype,
                      flat_eval=flat_eval),
        variables,
    )


def _jx_forward(dtype, v, x):
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, dtype=dtype)
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jx(x))


@pytest.fixture(scope="module")
def tiny():
    """Seeded variables of the tiny JAX ADD, an input and its fp32 logits."""
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=15)
    x = _x((1, *HW, 3), seed=16)
    return v, x, _jx_forward(None, v, x)


def test_add_flat_eval_fp32_matches_jax(tiny):
    v, x, refs = tiny
    outs = _pt_add(v)(torch.from_numpy(x))
    assert len(outs) == len(refs) == 2
    for o, r in zip(outs, refs):
        assert_close_fp32_model(o.numpy(), r)


def test_add_flat_eval_bf16_within_jax(tiny):
    v, x, refs = tiny
    refs16 = _jx_forward(jnp.bfloat16, v, x)
    outs = _pt_add(v, torch.bfloat16)(torch.from_numpy(x))
    for o, r16, r32 in zip(outs, refs16, refs):
        assert o.dtype == torch.bfloat16
        assert_bf16_within_jax(o.float().numpy(), np.asarray(r16, np.float32), r32)


def test_flat_eval_keeps_the_parameter_set():
    kw = dict(F=F, B=5)
    flat = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, flat_eval=True, **kw).state_dict()
    plain = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, **kw).state_dict()
    assert list(flat) == list(plain)
    assert all(flat[k].shape == plain[k].shape for k in flat)
    assert all(cell.flat_eval for cell in pt_models.ADD(
        PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, flat_eval=True, **kw).modules()
        if isinstance(cell, pt_models.FixedCell))


@pytest.mark.parametrize("thr,exit_index", [(2.0, 0), (-1.0, 1)])
def test_engine_exit_unchanged_under_flat_eval(tiny, thr, exit_index):
    v, x, _ = tiny
    flat = PtEngine(_pt_add(v), num_classes=NCLS, device="cpu")
    plain = PtEngine(_pt_add(v, flat_eval=False), num_classes=NCLS, device="cpu")
    l_f, k_f, _, c_f = flat.infer(torch.from_numpy(x), threshold=thr, confidence="entropy")
    l_p, k_p, _, c_p = plain.infer(torch.from_numpy(x), threshold=thr, confidence="entropy")
    assert k_f == k_p == exit_index and abs(c_f - c_p) <= 1e-4
    assert_close_fp32_model(l_f.numpy(), l_p.numpy())


@pytest.mark.parametrize("extra", [[], ["--dynamic", "--confidence", "entropy", "--threshold", "0.5"]])
def test_cli_cell_exec_flat_cpu(extra, capsys):
    stats = pt_cli.main(["--device", "cpu", "--cell-exec", "flat", "--F", "4", "--synthetic-crop", "33",
                         "65", "--synthetic-length", "8", "--workers", "1"] + extra)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"] == "cpu"
    if extra:
        assert stats["n_images"] == 8 and sum(stats["exit_histogram"]) == 8
    else:
        assert len(stats["miou"]) == 2 and all(0.0 <= m <= 1.0 for m in stats["miou"])
