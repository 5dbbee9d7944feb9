"""K1-K6 against their plain versions on the card; one search iteration
and the device augmentation against the CPU.

This file imports neither jax nor the JAX package, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which configures jax). Without a
GPU the kernel tests skip. Tolerances: K1 relative max error ≤ 1e-4 in
fp32 (TF32 off; 3xTF32 products) and ≤ 2e-2 in bf16 (bf16 rounds at
other points than cuDNN, and the BN scale is folded into the bf16
weights); K2 entropy |Δ| ≤ 1e-5 in fp32 and ≤ 1e-4 in bf16, argmax exact;
K3-K6 and the flat DAG relative max error ≤ 1e-4 in fp32 (TF32 off) and
≤ 2e-2 in bf16 (a sum taken in another order can move a bf16 rounding of
the depthwise result or the mid by one unit).
"""
import ctypes

import pytest
import torch

from auto_dynamic_deeplab_torch.kernels import _build
from auto_dynamic_deeplab_torch.kernels import cell_ops as pt_cell
from auto_dynamic_deeplab_torch.kernels import confidence as pt_conf
from auto_dynamic_deeplab_torch.kernels import stems as pt_stems
from auto_dynamic_deeplab_torch.models.cell import as_genotype_rows, edge_op_assignment
from auto_dynamic_deeplab_torch.models.decoded import _Stems
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_torch.ops.primitives import OPS
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

needs_gpu = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="launches a CUDA/Triton kernel: needs a GPU"
)


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double().cpu(), ref.double().cpu()
    assert ref.abs().max() > 0 and torch.isfinite(a).all()  # two zero outputs prove nothing
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _stems(dtype):
    g = torch.Generator().manual_seed(0)
    return randomize_bn(init_params(_Stems(dtype), g), g).cuda().eval(), g


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,n", [((65, 97), 1), ((66, 98), 2), ((33, 33), 1), ((135, 263), 2), ((9, 13), 1)])
def test_k1_matches_plain_on_gpu(hw, n, dtype):
    """Through the module, at the plan's tile; the last tiles are ragged in
    both directions at every shape but (33, 33) (s1 17 x 25 and 34 x 66
    on 7 x 8 or 4 x 8 tiles)."""
    torch.backends.cudnn.allow_tf32 = False
    stems, g = _stems(dtype)
    x = torch.randn(n, *hw, 3, generator=g).cuda().permute(0, 3, 1, 2)  # channels_last
    before = pt_stems.fused_stems.launches
    with torch.inference_mode():
        outs = stems(x)
        refs = pt_stems.stems_reference(stems, x)
    torch.cuda.synchronize()
    assert pt_stems.fused_stems.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert _rel_err(o, r) <= tol


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_sharded_windows_match_whole_image_on_gpu(dtype):
    """K1 on each rank's row window (spatial sharding, ``_Stems._on_band``):
    windows from input rows 0, 4, 8 and 88 (the last band) of a 129-row
    image, each one K1 launch, against the rows of K1 on the whole image
    (the same products in the same order: relative max error ≤ 1e-6 in
    fp32, one bf16 rounding in bf16)."""
    import sys

    from auto_dynamic_deeplab_torch.ops import band

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from torch_sharded_ranks import WindowBands

    torch.backends.cudnn.allow_tf32 = False
    stems, g = _stems(dtype)
    x = torch.randn(1, 3, 129, 97, generator=g).cuda()
    points = (0, 12, 16, 96, 129)
    with torch.inference_mode():
        s0, s1 = stems(x)
        for rank in range(len(points) - 1):
            bands = WindowBands(129, points, rank, x)
            lo, hi = bands.band(129)
            before = pt_stems.fused_stems.launches
            b0, b1 = stems(band.wrap(x[:, :, lo:hi], 129, bands))
            assert pt_stems.fused_stems.launches == before + 1
            (a0, e0), (a1, e1) = bands.band(65), bands.band(33)
            tol = 1e-6 if dtype == torch.float32 else 1e-2
            assert _rel_err(band.local(b0), s0[:, :, a0:e0]) <= tol
            assert _rel_err(band.local(b1), s1[:, :, a1:e1]) <= tol


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", pt_stems.STEM_TILES)
def test_k1_every_tile_on_gpu(tile, dtype):
    """Every tile of STEM_TILES, at batch 2 with ragged last tiles, from a
    bf16 input too."""
    torch.backends.cudnn.allow_tf32 = False
    stems, g = _stems(dtype)
    plan = pt_stems.StemPlan(tile, pt_stems.stem_smem(*tile, dtype), 1)
    for x_dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 3, 131, 195, generator=g).cuda().to(x_dtype)
        with torch.inference_mode():
            outs = pt_stems.fused_stems(x, pt_stems.stem_weights(stems, dtype), dtype, plan)
            refs = pt_stems.stems_reference(stems, x.float())
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for o, r in zip(outs, refs):
            assert o.shape == r.shape and o.dtype == dtype
            assert _rel_err(o, r) <= tol, (tile, x_dtype)


def test_k1_plans_match_the_kernels_carveup():
    """The host's K1 plans grant exactly the shared memory the kernel
    carves, and the ctypes argument structure has the C structure's size."""
    if not torch.cuda.is_available():
        pytest.skip("builds csrc/stems.cu with nvcc: needs the GPU machine")
    lib = pt_stems.library()
    assert lib.add_stems_args_size() == ctypes.sizeof(pt_stems._StemArgs)
    for dtype in (torch.float32, torch.bfloat16):
        for tile in pt_stems.STEM_TILES:
            a = pt_stems._StemArgs()
            (a.tq, a.tw), a.is_bf16 = tile, int(dtype == torch.bfloat16)
            assert lib.add_stems_smem_bytes(ctypes.byref(a)) == pt_stems.stem_smem(*tile, dtype), (tile, dtype)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "channels_last"])
def test_k2_matches_plain_on_gpu(layout, dtype):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(3, 19, 65, 97, generator=g) * 3).round()  # many exact ties
    if layout == "nhwc":
        x, axis = x.permute(0, 2, 3, 1).contiguous(), -1
    elif layout == "channels_last":
        x, axis = x.contiguous(memory_format=torch.channels_last), 1
    else:
        axis = 1
    x = x.cuda().to(dtype)
    before = pt_conf.entropy_argmax_triton.launches
    ent, arg = pt_conf.entropy_argmax(x, 19, class_axis=axis)
    torch.cuda.synchronize()
    assert pt_conf.entropy_argmax_triton.launches == before + 1
    ent_r, arg_r = pt_conf.entropy_argmax_reference(x, 19, class_axis=axis)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert (ent - ent_r).abs().max().item() <= tol
    assert torch.equal(arg, arg_r)


def _device_kernels(fn, tries=5):
    """Names of the device kernels (memsets and copies included) one call
    of ``fn`` launches, by torch.profiler. A session now and then records
    fewer kernels than were launched (chip_smoke.py::device_ms), so the
    largest of a few sessions' lists is taken."""
    seen = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = max(seen, names, key=len)
    return seen


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw", [(3, (65, 97)), (2, (513, 1025))])
def test_k2_one_launch_deterministic_on_gpu(n, hw, dtype):
    """K2 launches exactly one device kernel per call (no memset, no
    reduction after it), gives bitwise-equal results on repeated calls, and
    stays right over repeated calls at N > 1 (each image's counter is reset
    by the launch that used it). At 513 x 1025 a program walks about four
    blocks; at 65 x 97 an image has fewer blocks than an SM has programs."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(n, 19, *hw, generator=g) * 3).cuda().to(dtype)
    first = pt_conf.entropy_argmax_triton(x, 19, class_axis=1)
    kernels = _device_kernels(lambda: pt_conf.entropy_argmax_triton(x, 19, class_axis=1))
    assert kernels == ["entropy_argmax_kernel"], kernels
    ent_r, arg_r = pt_conf.entropy_argmax_reference(x, 19, class_axis=1)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    for _ in range(3):
        ent, arg = pt_conf.entropy_argmax_triton(x, 19, class_axis=1)
        torch.cuda.synchronize()
        assert torch.equal(ent, first[0]) and torch.equal(arg, first[1])
        assert (ent - ent_r).abs().max().item() <= tol and torch.equal(arg, arg_r)


def _state(n, c, hw, dtype, seed, width=None):
    """A seeded channels_last state; with ``width`` > c, a channel slice of
    a wider buffer (pixel stride ``width``), as the cell's concat hands out."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(n, *hw, width or c, generator=g).cuda().to(dtype)
    return buf[..., :c].permute(0, 3, 1, 2)


def _op(name, c, seed):
    g = torch.Generator().manual_seed(seed)
    return randomize_bn(init_params(OPS[name](c, 1), g), g).cuda().eval()


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


# (C, (H, W), N, source pixel stride): odd sizes, C not a multiple of 8,
# a strided source, and a width where tiles run past the image on both axes
CELL_SHAPES = [(12, (13, 17), 2, None), (40, (21, 35), 1, 56), (5, (9, 7), 1, None)]


# the flagship genotype's five blocks, and K3's cases at small odd sizes
FLAGSHIP_BLOCKS = [
    ("dil_conv_5x5", "sep_conv_3x3"), ("sep_conv_3x3", "dil_conv_3x3"), ("sep_conv_3x3", "sep_conv_3x3"),
    ("sep_conv_5x5", "sep_conv_5x5"), ("dil_conv_5x5", "sep_conv_5x5"),
]
K3_CASES = [(names, shape, dtype) for names in [
    ("dil_conv_5x5", "sep_conv_3x3"), ("skip_connect", "sep_conv_5x5"),
    ("sep_conv_3x3", "dil_conv_3x3"), ("dil_conv_3x3",),
] for shape in CELL_SHAPES for dtype in (torch.float32, torch.bfloat16)] + [
    # the flagship's level-2 and level-3 widths and sizes at 1025x2049,
    # written into a concat slice; in fp32 at C=160 no K3 plan fits a
    # block with a sep5 edge (266 KB), which goes per-op
    (names, shape, dtype) for shape in [(80, (65, 129), 1, None), (160, (33, 65), 1, None)]
    for names in FLAGSHIP_BLOCKS for dtype in (torch.float32, torch.bfloat16)
    if not (dtype == torch.float32 and shape[0] == 160 and "sep_conv_5x5" in names)
]


@needs_gpu
@pytest.mark.parametrize("names,shape,dtype", K3_CASES, ids=str)
def test_k3_block_matches_plain_on_gpu(names, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    c, hw, n, width = shape
    if c >= 80:  # at the flagship's levels 2 and 3 the grid fills the SMs
        plan = pt_cell.plan_block(names, c, dtype, hw, n)
        assert pt_cell.dense_blocks(plan, c, n, *hw) >= pt_cell.SM_COUNT
    edges = []
    for i, name in enumerate(names):
        x = _state(n, c, hw, dtype, seed=i, width=width)
        w = pt_cell.edge_weights(_op(name, c, 10 + i), name, dtype) if name != "skip_connect" else None
        edges.append((x, name, w))
    out = torch.zeros(n, *hw, 2 * c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
    before = pt_cell.block_stage.launches
    with torch.inference_mode():
        got = pt_cell.block_stage(edges, out=out[:, c:])
        ref = pt_cell.block_stage_reference(edges)
    torch.cuda.synchronize()
    assert pt_cell.block_stage.launches == before + 1
    assert got.data_ptr() == out[:, c:].data_ptr() and torch.all(out[:, :c] == 0)
    assert _rel_err(got, ref) <= _tol(dtype)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=str)
@pytest.mark.parametrize("name", ["sep_conv_3x3", "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5"])
def test_k4_k5_k6_match_plain_on_gpu(name, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    c, hw, n, width = shape
    x = _state(n, c, hw, dtype, seed=3, width=width)
    w = pt_cell.edge_weights(_op(name, c, 20), name, dtype)
    with torch.inference_mode():
        if name.startswith("dil"):
            before = pt_cell.dense_stage.launches
            got, ref = pt_cell.dense_stage(x, name, w), pt_cell.dense_stage_reference(x, w)
            torch.cuda.synchronize()
            assert pt_cell.dense_stage.launches == before + 1
            assert _rel_err(got, ref) <= _tol(dtype)
            return
        before = pt_cell.sep_fused.launches
        got, ref = pt_cell.sep_fused(x, name, w), pt_cell.sep_fused_reference(x, *w)
        torch.cuda.synchronize()
        assert pt_cell.sep_fused.launches == before + 1
        assert _rel_err(got, ref) <= _tol(dtype)
        before = pt_cell.sep_stage.launches
        for in_relu, out_relu in ((True, True), (False, False), (True, False)):
            got = pt_cell.sep_stage(x, name, w[0], in_relu, out_relu)
            ref = pt_cell.sep_stage_reference(x, w[0], in_relu, out_relu)
            torch.cuda.synchronize()
            assert _rel_err(got, ref) <= _tol(dtype), (in_relu, out_relu)
        assert pt_cell.sep_stage.launches == before + 3


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_at_flagship_level3_matches_plain_on_gpu(dtype):
    """K6 on dil5 at the flagship's level-3 width and size (C=160, 33x65),
    where its plan splits the output channels over blocks to fill the SMs."""
    torch.backends.cudnn.allow_tf32 = False
    name, c, hw = "dil_conv_5x5", 160, (33, 65)
    plan = pt_cell.plan_dense_stage(name, c, dtype, hw, 1)
    assert pt_cell.dense_blocks(plan, c, 1, *hw) >= pt_cell.SM_COUNT and plan.ns < c
    x = _state(1, c, hw, dtype, seed=6)
    w = pt_cell.edge_weights(_op(name, c, 21), name, dtype)
    before = pt_cell.dense_stage.launches
    with torch.inference_mode():
        got, ref = pt_cell.dense_stage(x, name, w), pt_cell.dense_stage_reference(x, w)
    torch.cuda.synchronize()
    assert pt_cell.dense_stage.launches == before + 1
    assert _rel_err(got, ref) <= _tol(dtype)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,ns,ng", [((8, 8), 8, 1), ((8, 8), 16, 1), ((8, 8), 16, 2), ((4, 8), 16, 2),
                                         ((2, 4), 8, 1), ((1, 4), 16, 1)])
def test_k6_every_tile_on_gpu(tile, ns, ng, dtype):
    """Each tile K6's plans may choose, N-slices of one and two n8
    fragments, one or two warp groups, on a strided C=12 source."""
    torch.backends.cudnn.allow_tf32 = False
    name, c, hw = "dil_conv_5x5", 12, (13, 17)
    x = _state(2, c, hw, dtype, seed=7, width=20)
    w = pt_cell.edge_weights(_op(name, c, 22), name, dtype)
    plan = pt_cell.Plan(tile, pt_cell._dense_smem(name, c, dtype, *tile, ns), ns, ng)
    out = torch.empty(2, *hw, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
    with torch.inference_mode():
        pt_cell._launch("dense_stage", x, [(x, name, w)], plan, out)
        ref = pt_cell.dense_stage_reference(x, w)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= _tol(dtype)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns,ng", [(8, 1), (8, 2), (16, 1), (16, 2)])
@pytest.mark.parametrize("names", [("dil_conv_5x5", "sep_conv_3x3"), ("skip_connect", "sep_conv_5x5"),
                                   ("sep_conv_5x5",)])
def test_k3_every_slice_on_gpu(names, ns, ng, dtype):
    """K3 (and, with one sep edge, K4) under each N-slice and warp-group
    count, on a strided C=12 source (O8 = 16: one and two slices) at N=2."""
    torch.backends.cudnn.allow_tf32 = False
    c, hw = 12, (13, 17)
    edges = []
    for i, name in enumerate(names):
        x = _state(2, c, hw, dtype, seed=8 + i, width=20)
        w = pt_cell.edge_weights(_op(name, c, 23 + i), name, dtype) if name != "skip_connect" else None
        edges.append((x, name, w))
    (th, tw), = pt_cell.BLOCK_TILES
    plan = pt_cell.Plan((th, tw), pt_cell._mma_smem(names, c, dtype, th, tw, ns, ng), ns, ng)
    out = torch.empty(2, *hw, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
    with torch.inference_mode():
        pt_cell._launch("sep_fused" if len(names) == 1 else "block", edges[0][0], edges, plan, out)
        ref = pt_cell.block_stage_reference(edges)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= _tol(dtype)


def _k5_plans(c):
    """Every plan K5's model can pick at width c: tile x N-slice, with one
    and (for slices of two or more fragments) two warp groups."""
    return [pt_cell.Plan(tile, pt_cell._stage_smem("sep_conv_5x5", *tile, ns), ns, ng)
            for tile in pt_cell.SEP_STAGE_TILES for ns in pt_cell._slices(c) for ng in ((1, 2) if ns >= 16 else (1,))]


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", _k5_plans(75), ids=lambda p: f"{p.tile}-{p.ns}-{p.ng}")
def test_k5_every_plan_on_gpu(plan, dtype):
    """K5 under each plan its model may pick, sep3 and sep5, with and
    without ReLU on input and output, on a strided C=75 source at N=2:
    C is not a multiple of the 128-byte chunk (fp32: 32 + 32 + 16 channels,
    bf16: 64 + 16), and the tiles run past the 13 x 17 image on both axes."""
    torch.backends.cudnn.allow_tf32 = False
    c, hw = 75, (13, 17)
    x = _state(2, c, hw, dtype, seed=9, width=88)
    out = torch.empty(2, *hw, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
    for i, name in enumerate(("sep_conv_3x3", "sep_conv_5x5")):
        w = pt_cell.edge_weights(_op(name, c, 24 + i), name, dtype)[i]
        p = plan._replace(smem=pt_cell._stage_smem(name, *plan.tile, plan.ns))
        for in_relu, out_relu in ((True, True), (False, False)):
            with torch.inference_mode():
                pt_cell._launch("sep_stage", x, [(x, name, (w,))], p, out, in_relu, out_relu)
                ref = pt_cell.sep_stage_reference(x, w, in_relu, out_relu)
            torch.cuda.synchronize()
            assert _rel_err(out, ref) <= _tol(dtype), (name, in_relu, out_relu)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sep_conv_3x3", "sep_conv_5x5"])
def test_k5_at_flagship_level3_matches_plain_on_gpu(name, dtype):
    """K5 at the flagship's level-3 width and size (C=160, 33x65), where
    fp32's (sep5, sep5) and (dil5, sep5) blocks run it per op: its plan's
    grid fills the 132 SMs; both stages of a SepConv."""
    torch.backends.cudnn.allow_tf32 = False
    c, hw = 160, (33, 65)
    plan = pt_cell.plan_sep_stage(name, c, dtype, hw, 1)
    assert pt_cell.dense_blocks(plan, c, 1, *hw) >= pt_cell.SM_COUNT
    x = _state(1, c, hw, dtype, seed=10)
    w1, w2 = pt_cell.edge_weights(_op(name, c, 26), name, dtype)
    before = pt_cell.sep_stage.launches
    with torch.inference_mode():
        mid = pt_cell.sep_stage(x, name, w1, True, True)
        ref_mid = pt_cell.sep_stage_reference(x, w1, True, True)
        got, ref = pt_cell.sep_stage(mid, name, w2, False, False), pt_cell.sep_stage_reference(mid, w2, False, False)
    torch.cuda.synchronize()
    assert pt_cell.sep_stage.launches == before + 2
    assert _rel_err(mid, ref_mid) <= _tol(dtype) and _rel_err(got, ref) <= _tol(dtype)


def _sass_functions(name: str, kernel: str):
    """The SASS of every instance of ``kernel`` in the built csrc/<name>.cu."""
    import os
    import shutil
    import subprocess

    lib = _build.build(name)
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    assert tool, "cuobjdump ships with the CUDA toolkit"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    return [f for f in sass.split("Function : ")[1:] if kernel in f.splitlines()[0]]


@needs_gpu
def test_k6_runs_on_the_tensor_cores():
    """The built library's K6 kernels (bf16, fp32) and K3's (which K4
    launches; bf16, fp32, each with one and two warp groups) hold HMMA
    instructions."""
    for kernel, instances in (("dense_stage_kernel", 2), ("block_kernel", 4)):
        found = _sass_functions("cell_ops", kernel)
        assert len(found) == instances, [f.splitlines()[0] for f in found]
        assert all("HMMA" in f for f in found), kernel


@needs_gpu
def test_k5_runs_on_the_tensor_cores():
    """The built library's two K5 kernels (bf16, fp32) hold HMMA
    instructions: their pointwise products run on the tensor cores."""
    found = _sass_functions("cell_ops", "sep_stage_kernel")
    assert len(found) == 2, [f.splitlines()[0] for f in found]
    assert all("HMMA" in f for f in found)


@needs_gpu
def test_k1_runs_on_the_tensor_cores():
    """Every K1 instance (fp32 or bf16 input, times fp32 or bf16 storage)
    holds HMMA instructions: its products run on the tensor cores."""
    found = _sass_functions("stems", "stems_kernel")
    assert len(found) == 4, [f.splitlines()[0] for f in found]
    assert all("HMMA" in f for f in found)


# (kernel, a block whose route runs it, C, dtype): K3-K6 at the flagship's
# widths and sizes; K5 takes the per-op sep5 only in fp32 at C=160
SHARDED_BLOCKS = [
    (kernel, names, c, dtype) for kernel, names, c in (
        ("block_stage", ("dil_conv_5x5", "sep_conv_3x3"), 40), ("sep_fused", ("max_pool_3x3", "sep_conv_3x3"), 40),
        ("dense_stage", ("avg_pool_3x3", "dil_conv_5x5"), 80))
    for dtype in (torch.float32, torch.bfloat16)
] + [("sep_stage", ("sep_conv_5x5", "none"), 160, torch.float32)]
SHARDED_HW = {40: (129, 257), 80: (65, 129), 160: (33, 65)}


@needs_gpu
@pytest.mark.parametrize("kernel,names,c,dtype", SHARDED_BLOCKS, ids=str)
def test_k3_k6_sharded_windows_match_whole_map_on_gpu(kernel, names, c, dtype):
    """The flat DAG's block rule on the card: the block's kernel on the
    window of rows ``band.block_windows`` fetches for bands from row 0,
    mid-map and the last band, its route's launches each time; the band's
    rows against the whole map's kernel output (relative max error ≤ 1e-6
    in fp32, one bf16 rounding in bf16) and against the plain versions on
    the same window (the K3-K6 bound)."""
    import copy
    import sys

    from auto_dynamic_deeplab_torch.ops import band

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from torch_sharded_ranks import WindowBands

    torch.backends.cudnn.allow_tf32 = False
    route = pt_cell.block_route(names, c, dtype)
    assert kernel in route
    rows, w = SHARDED_HW[c]
    points = (0, rows // 4, rows // 2 + 3, rows)
    ops = [_op(n, c, 40 + i) for i, n in enumerate(names)]
    cpu_ops = [copy.deepcopy(op).cpu() for op in ops]
    xs = [_state(1, c, (rows, w), dtype, seed=50 + i) for i in range(len(names))]
    fn = getattr(pt_cell, kernel)
    with torch.inference_mode():
        whole = _state(1, c, (rows, w), dtype, seed=0)
        pt_cell._run_block(xs, names, ops, whole)
        for rank in range(len(points) - 1):
            bands = WindowBands(rows, points, rank, xs)
            lo, hi = bands.band(rows)
            wins, start = band.block_windows([x[:, :, lo:hi] for x in xs], rows, bands, names)
            assert all(t.is_contiguous(memory_format=torch.channels_last) for t in wins)
            dst = _state(1, c, (hi - lo, w), dtype, seed=1)
            before = fn.launches
            pt_cell._run_block(wins, names, ops, dst, start)
            torch.cuda.synchronize()
            assert fn.launches == before + route.count(kernel)
            plain = torch.empty(1, c, hi - lo, w, dtype=dtype)
            pt_cell._run_block([t.cpu() for t in wins], names, cpu_ops, plain, start)
            assert _rel_err(dst, whole[:, :, lo:hi]) <= (1e-6 if dtype == torch.float32 else 1e-2)
            assert _rel_err(dst, plain) <= _tol(dtype)


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("genotype", [
    AUTODEEPLAB_GENOTYPE,
    [[0, 1], [1, 4], [2, 3], [3, 7], [5, 2], [8, 6], [11, 0], [13, 5], [18, 3], [19, 4]],
], ids=["flagship", "mixed"])
def test_run_dag_on_gpu_matches_cpu(genotype, dtype):
    """The DAG on the card (kernels) against the same DAG on the CPU (plain
    versions), with the launches the routes predict. C=160 sends the
    flagship's (sep5, sep5) and (dil5, sep5) blocks per-op in fp32."""
    torch.backends.cudnn.allow_tf32 = False
    c, hw = 160, (11, 19)
    assignment = edge_op_assignment(as_genotype_rows(genotype))
    ops = [_op(pt_cell.PRIMITIVES[o], c, 30 + k) for k, (_, o) in enumerate(assignment)]
    s0, s1 = _state(1, c, hw, dtype, seed=4), _state(1, c, hw, dtype, seed=5)
    fns = [pt_cell.block_stage, pt_cell.sep_fused, pt_cell.sep_stage, pt_cell.dense_stage]
    before = {f.__name__: f.launches for f in fns}
    with torch.inference_mode():
        got = pt_cell.run_dag(s0, s1, assignment, 5, ops)
        torch.cuda.synchronize()
        launched = {f.__name__: f.launches - before[f.__name__] for f in fns}
        ref = pt_cell.run_dag(s0.cpu(), s1.cpu(), assignment, 5, [op.cpu() for op in ops])
    want = pt_cell.dag_launches(assignment, 5, c, dtype)
    assert launched == {name: want.get(name, 0) for name in launched}
    assert got.shape == ref.shape == (1, 5 * c, *hw)
    assert _rel_err(got, ref) <= _tol(dtype)


def test_cell_plans_match_the_kernels_carveup():
    """The host's plans grant exactly the shared memory each kernel carves,
    and the ctypes argument structure has the C structure's size."""
    if not torch.cuda.is_available():
        pytest.skip("builds csrc/cell_ops.cu with nvcc: needs the GPU machine")
    lib = pt_cell.library()
    assert lib.add_cell_args_size() == ctypes.sizeof(pt_cell._Args)
    for dtype in (torch.float32, torch.bfloat16):
        for c in (5, 40, 80, 160, 320):
            a = pt_cell._Args()
            a.C, a.is_bf16 = c, int(dtype == torch.bfloat16)
            blocks = (("dil_conv_5x5", "sep_conv_5x5"), ("skip_connect", "sep_conv_3x3"), ("dil_conv_3x3",),
                      ("sep_conv_3x3", "sep_conv_3x3"))
            for names in blocks:
                # K3 on its own and with the grid weighed at 33x65 (N-slices included)
                for plan in (pt_cell.plan_block(names, c, dtype), pt_cell.plan_block(names, c, dtype, (33, 65))):
                    if plan is None:
                        continue
                    a.n_edges, (a.th, a.tw), a.ns, a.ng = len(names), plan.tile, plan.ns, plan.ng
                    for e, name in zip(a.e, names):
                        kind, e.k, e.dil = pt_cell.EDGE_KINDS[name]
                        e.kind = pt_cell._KIND_CODE[kind]
                    assert lib.add_cell_smem_bytes(0, ctypes.byref(a)) == plan.smem, (names, c, dtype)
            # K5 and K6 on their own and with the grid weighed at 33x65 (N-split included)
            k5_at_level3 = lambda *p: pt_cell.plan_sep_stage(*p, (33, 65))  # noqa: E731
            k6_at_level3 = lambda *p: pt_cell.plan_dense_stage(*p, (33, 65))  # noqa: E731
            for which, plan_fn, name in ((1, pt_cell.plan_sep_fused, "sep_conv_5x5"),
                                         (2, pt_cell.plan_sep_stage, "sep_conv_5x5"),
                                         (2, k5_at_level3, "sep_conv_5x5"),
                                         (2, k5_at_level3, "sep_conv_3x3"),
                                         (3, pt_cell.plan_dense_stage, "dil_conv_5x5"),
                                         (3, k6_at_level3, "dil_conv_5x5"),
                                         (3, pt_cell.plan_dense_stage, "dil_conv_3x3")):
                plan = plan_fn(name, c, dtype)
                if plan is None:
                    continue
                kind, a.e[0].k, a.e[0].dil = pt_cell.EDGE_KINDS[name]
                a.n_edges, a.e[0].kind, (a.th, a.tw), a.ns, a.ng = 1, pt_cell._KIND_CODE[kind], plan.tile, plan.ns, plan.ng
                assert lib.add_cell_smem_bytes(which, ctypes.byref(a)) == plan.smem, (name, c, dtype)


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    """The build cache key changes with the nvcc flags, the source and the
    shared header (tap_gemm.cuh, which both sources include), so a stale
    library is never loaded; the build directory lies inside the checkout."""
    import shutil

    name = _build.library_path("stems")
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = {lib: _build.library_path(lib) for lib in ("stems", "cell_ops")}
    assert names["stems"] == name
    for edited in ("tap_gemm.cuh", "stems.cu"):
        (csrc / edited).write_text((csrc / edited).read_text() + "\n// edited\n")
        now = {lib: _build.library_path(lib) for lib in names}
        assert now["stems"] != names["stems"]
        assert (now["cell_ops"] != names["cell_ops"]) == (edited == "tap_gemm.cuh")
        names = now
    assert '#include "tap_gemm.cuh"' in (csrc / "stems.cu").read_text()
    assert '#include "tap_gemm.cuh"' in (csrc / "cell_ops.cu").read_text()
    name = _build.library_path("stems")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path("stems") != name
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ------------------------------------------------- engine: CUDA graphs


def _engine(dtype, cell_exec, seed=0):
    """The flagship topology (C=2, F=20, 19 classes) with seeded weights
    and an EDM, at the engine's small test size; ``cell_exec`` is a
    ``cli.evaluate --cell-exec`` value."""
    from auto_dynamic_deeplab_torch.cli.evaluate import CELL_EXEC
    from auto_dynamic_deeplab_torch.models import ADD, EDM
    from auto_dynamic_deeplab_torch.nas import NETWORK_ARCH
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    cfg = NETWORK_ARCH[2]
    g = torch.Generator().manual_seed(seed)
    model = randomize_bn(init_params(ADD(
        cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=20, B=5,
        low_level_layer=cfg["low_level_layer"], dtype=dtype, **CELL_EXEC[cell_exec]), g), g)
    edm = init_params(EDM(model.feature_channels(model.exit_layers[0]), dtype=dtype), g)
    return DynamicInferenceEngine(model, edm=edm, num_classes=19)


ENGINE_HW = (65, 129)
ENGINE_CASES = [(dtype, cell_exec) for dtype in (torch.float32, torch.bfloat16) for cell_exec in ("xla", "flat")]
VARIANT_CASES = [(dtype, cell_exec) for dtype in (torch.float32, torch.bfloat16)
                 for cell_exec in ("packed", "flat-packed", "dense-sep")]


def _images(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, *ENGINE_HW, 3, generator=g).cuda()


@needs_gpu
@pytest.mark.parametrize("dtype,cell_exec", ENGINE_CASES, ids=str)
def test_fused_graphs_match_segment_loop_on_gpu(dtype, cell_exec):
    """Replayed graphs against the eager segment loop, bitwise: the same
    kernels on the same inputs. Each signal at a threshold on each side of
    the image's first confidence, so both exits and EDM's head graph run."""
    engine = _engine(dtype, cell_exec)
    x = _images(1, 3)
    for confidence in ("entropy", "max", "edm"):
        # the max signal's value depends on the threshold: 0.05 exits (every
        # pixel's top probability is at least 1/19), 0.999 hardly ever
        conf = engine.infer(x, 0.0, confidence)[3]
        for thr in ((0.05, 0.999) if confidence == "max" else (conf - 1e-3, conf + 1e-3)):
            want, k_want, _, c_want = engine.infer(x, thr, confidence)
            got, k_got, _, c_got = engine.infer_fused(x, thr, confidence)
            assert k_got == k_want and c_got == c_want
            assert got.dtype == want.dtype and torch.equal(got, want), (confidence, thr)
    assert engine.replays > 0


@needs_gpu
@pytest.mark.parametrize("dtype,cell_exec", VARIANT_CASES, ids=str)
def test_variant_fused_graphs_match_segment_loop_on_gpu(dtype, cell_exec):
    """The other --cell-exec values: replayed graphs against the eager
    segment loop, bitwise, on each side of the image's exit-0 entropy."""
    engine = _engine(dtype, cell_exec)
    x = _images(1, 3)
    conf = engine.infer(x, 0.0, "entropy")[3]
    for thr in (conf - 1e-3, conf + 1e-3):
        want, k_want, _, c_want = engine.infer(x, thr, "entropy")
        got, k_got, _, c_got = engine.infer_fused(x, thr, "entropy")
        assert k_got == k_want and c_got == c_want
        assert got.dtype == want.dtype and torch.equal(got, want), thr
    assert engine.replays > 0


@needs_gpu
@pytest.mark.parametrize("cell_exec", ["packed", "flat-packed", "dense-sep"])
def test_variant_folded_weights_follow_load_state_dict_on_gpu(cell_exec):
    """The packed and composed weights are folded again after a
    load_state_dict: the model then gives a fresh model's logits for the
    new weights, bitwise, and keeps one folding until the next change."""
    torch.backends.cudnn.allow_tf32 = False
    engine, fresh = _engine(torch.float32, cell_exec), _engine(torch.float32, cell_exec, seed=1)
    model = engine.model
    x = _images(1, 6)
    with torch.inference_mode():
        before = model(x, class_leading=True)
        model.load_state_dict(fresh.model.state_dict())
        after, want = model(x, class_leading=True), fresh.model(x, class_leading=True)
    assert not torch.equal(after[-1], before[-1])
    for a, w in zip(after, want):
        assert torch.equal(a, w)
    cell = model.cell_3
    folded = cell.packed_weights(torch.float32) if cell.packed_eval else cell.ops_1.composed(torch.float32)
    again = cell.packed_weights(torch.float32) if cell.packed_eval else cell.ops_1.composed(torch.float32)
    assert again is folded


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_new_threshold_reuses_graphs_on_gpu(dtype):
    """A new threshold captures nothing: the max signal reads it inside its
    graphs (a 0-d device tensor), so its confidence changes with it."""
    engine = _engine(dtype, "xla")
    x = _images(1, 4)
    engine.infer_fused(x, 0.5, "max")
    captures = engine.captures
    assert captures == 2  # decide_0 and final
    for thr in (0.1, 0.9, 0.5, 0.99):
        _, k, _, conf = engine.infer_fused(x, thr, "max")
        _, k_want, _, conf_want = engine.infer(x, thr, "max")
        assert (k, conf) == (k_want, conf_want)
    assert engine.captures == captures


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_results_do_not_alias_on_gpu(dtype):
    """Two successive results are two tensors: the second replay does not
    overwrite the first image's logits."""
    engine = _engine(dtype, "flat")
    x = _images(2, 5)
    a, _, _, _ = engine.infer_fused(x[:1], 1.01, "entropy")
    kept = a.clone()
    b, _, _, _ = engine.infer_fused(x[1:], 1.01, "entropy")
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, kept) and not torch.equal(a, b)


@needs_gpu
@pytest.mark.parametrize("dtype,cell_exec", ENGINE_CASES, ids=str)
def test_fused_replays_launch_the_kernels_on_gpu(dtype, cell_exec):
    """A replay calls no wrapper; torch.profiler sees K1, K2 and, on the
    flat path, the cell kernels inside the replayed graph. The session
    holds a fresh engine's warm-up (every segment once), its capture
    (which launches nothing) and one early-exit replay (cells 0-5): a
    session that began after the capture lost the replay's first kernel
    in some runs on the card."""
    from auto_dynamic_deeplab_torch.kernels import DEVICE_KERNELS, count_device_kernels
    from auto_dynamic_deeplab_torch.nas import NETWORK_ARCH
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    engine = _engine(dtype, cell_exec)
    x = _images(1, 6)
    wrappers = [pt_stems.fused_stems, pt_conf.entropy_argmax_triton, pt_cell.block_stage, pt_cell.sep_fused,
                pt_cell.sep_stage, pt_cell.dense_stage]
    engine.warmup(x.shape, "entropy", 1.01)  # builds the kernels outside the sessions
    before = [f.launches for f in wrappers]

    def capture_and_replay():
        DynamicInferenceEngine(engine.model, num_classes=19).infer_fused(x, 1.01, "entropy")

    counts = count_device_kernels(_device_kernels(capture_and_replay))
    sessions = [f.launches - b for f, b in zip(wrappers, before)]

    def per_cells(cells):
        want = {"stems_kernel": 1, "entropy_argmax_kernel": 1, "block_kernel": 0, "sep_stage_kernel": 0,
                "dense_stage_kernel": 0}
        if cell_exec == "flat":
            assignment = edge_op_assignment(as_genotype_rows(AUTODEEPLAB_GENOTYPE))
            path = NETWORK_ARCH[2]["path"]
            for i in range(cells):
                for name, v in pt_cell.dag_launches(assignment, 5, 20 * (1, 2, 4, 8)[path[i]], dtype).items():
                    want[DEVICE_KERNELS[name]] += v
        return want

    full, early = per_cells(12), per_cells(6)
    assert counts == {k: full[k] + early[k] for k in full}
    # each session's wrappers: the warm-up and the capture, none for the replay
    n_sessions = sessions[0] // 2
    assert sessions[0] == 2 * n_sessions and sessions[1] == 2 * n_sessions
    assert sum(sessions[2:]) == 2 * n_sessions * sum(full[k] for k in ("block_kernel", "sep_stage_kernel",
                                                                         "dense_stage_kernel"))


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_infer_batch_matches_per_image_on_gpu(dtype):
    """N = 3 with a threshold between the images' first confidences: one
    image exits at exit 0 and the other two are compacted into bucket 2.
    Exits equal; logits within the kernels' tolerance (a batch of three
    changes cuDNN's choices and the kernels' grids)."""
    engine = _engine(dtype, "flat")
    x = _images(3, 7)
    confs = [engine.infer(x[i:i + 1], 0.0, "edm")[3] for i in range(3)]
    lo = sorted(confs)[0]
    thr = (lo + sorted(confs)[1]) / 2
    logits, exit_index = engine.infer_batch(x, thr, "edm")
    assert logits.shape == (3, 19, *ENGINE_HW) and logits.dtype == torch.float32
    assert sorted(exit_index.tolist()) == [0, 1, 1]
    for i in range(3):
        want, k, _, _ = engine.infer(x[i:i + 1], thr, "edm")
        assert k == int(exit_index[i])
        assert _rel_err(logits[i], want[0].float()) <= _tol(dtype)


@needs_gpu
def test_train_step_on_gpu_matches_cpu():
    """One fp32 step (TF32 off) of a small ADD (path [1,2,2,2,3,2], F=4, 7
    classes, batch 2 at 33x65) on the card against the same step on the
    CPU, from the same weights: the loss ≤ 1e-5 relative, the parameters
    and BN statistics after it |Δ| ≤ 1e-3·max(1, max|ref|) per tensor (the
    step's gradient is ill-conditioned at batch 2: the ASPP image-pool BN
    normalizes over two values), and validation on the card afterwards
    reads the new weights (K1's packed weights are rebuilt)."""
    from auto_dynamic_deeplab_torch import models as pt_models
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer

    resolve_device("cuda")  # TF32 off
    g = torch.Generator().manual_seed(0)
    path, hw = [1, 2, 2, 2, 3, 2], (33, 65)
    image = torch.randn(2, *hw, 3, generator=g)
    label = torch.randint(0, 7, (2, *hw), generator=g)
    label[:, :2] = 255
    models, losses = [], []
    for device in ("cpu", "cuda"):
        model = pt_models.ADD(path, [1], AUTODEEPLAB_GENOTYPE, 7, F=4, B=5)
        randomize_bn(init_params(model, torch.Generator().manual_seed(1)), torch.Generator().manual_seed(2))
        model.to(device)
        if device == "cuda":  # K1 packs the stems' weights before the step
            with torch.inference_mode():
                model.eval().stems(image.cuda().permute(0, 3, 1, 2))
        step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule("poly", 0.02, 1, 4))
        losses.append(step(image.to(device), label.to(device)).item())
        models.append(model)
    assert abs(losses[1] - losses[0]) <= 1e-5 * losses[0], losses
    want = models[0].state_dict()
    for name, t in models[1].state_dict().items():
        err = (t.cpu().double() - want[name].double()).abs().max().item()
        assert err <= 1e-3 * max(1.0, want[name].abs().max().item()), (name, err)
    gpu = models[1].eval()
    with torch.inference_mode():
        before = pt_stems.fused_stems.launches
        s0, s1 = gpu.stems(image.cuda().permute(0, 3, 1, 2))
        assert pt_stems.fused_stems.launches == before + 1
        ref0, ref1 = pt_stems.stems_reference(gpu.stems, image.cuda().permute(0, 3, 1, 2))
    assert _rel_err(s1, ref1) <= 1e-4 and _rel_err(s0, ref0) <= 1e-4  # not the packing from before the step


@needs_gpu
@pytest.mark.parametrize("shape", [(1, 6, 1, 1), (2, 6, 5, 7)], ids=["n1", "n70"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_on_gpu_matches_cpu(shape, dtype):
    """Training-mode BN on the card (cuDNN) against the CPU, n = 1 (the
    ASPP image-pool branch at batch 1) included: output, input and
    parameter gradients, and the blended statistics. fp32 |Δ| ≤ 1e-5·max(1,
    max|ref|) (2e-4 at n = 1, where x − mean is scaled by rsqrt(eps));
    bf16 within one bf16 unit."""
    from auto_dynamic_deeplab_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(5)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dtype)
    grad = torch.randn(*shape, generator=g)
    outs = []
    for device in ("cpu", "cuda"):
        bn = randomize_bn(BatchNorm(shape[1], dtype=dtype), torch.Generator().manual_seed(6)).to(device).train()
        xi = x.to(device).clone().requires_grad_()
        y = bn(xi)
        (y.float() * grad.to(device)).sum().backward()
        outs.append([t.detach().float().cpu() for t in (y, xi.grad, bn.scale.grad, bn.bias.grad, bn.mean, bn.var)])
    tol = (1e-5 if shape[0] > 1 else 2e-4) if dtype == torch.float32 else 2.0 ** -7
    for name, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"), outs[1], outs[0]):
        assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item()), name


@needs_gpu
def test_search_iteration_on_gpu_matches_cpu():
    """One bilevel iteration (a weight step, then an arch step) of a tiny
    ModelNetSearch (4 layers, F=2, B=2, 5 classes, batch 4 at 65x65, fp32,
    TF32 off) on the card against the CPU, from the same weights,
    statistics and arch: the losses ≤ 1e-5 relative, the arch gradient ≤
    1e-4 (L2, relative, as tests/test_torch_search.py holds it to JAX), the
    weight gradients ≤ 5e-4 (cuDNN's fp32 algorithms sum in another order
    than the CPU's: chip_smoke.py phase 11 reads 4.6e-5 and 9.6e-5 on the
    H100, where the CPU and JAX agree within 1.0e-5), the weights and
    statistics after the iteration |Δ| ≤
    1e-5·max(1, max|ref|) per tensor, and the arch after Adam's first step
    |Δ| ≤ 1e-6 where its decayed gradient exceeds 1e-2 of the largest
    (Adam's first step is about -lr·sign(g))."""
    from auto_dynamic_deeplab_torch.models import ModelNetSearch
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import SearchSteps, make_arch_optimizer, make_optimizer

    resolve_device("cuda")  # TF32 off
    g = torch.Generator().manual_seed(0)
    image = torch.randn(4, 65, 65, 3, generator=g)
    label = torch.randint(0, 5, (4, 65, 65), generator=g)
    label[:, :2] = 255
    runs = []
    for device in ("cpu", "cuda"):
        model = ModelNetSearch(5, [[1, 6], [0, 3], [4, 5], [2, 1]], num_layers=4, F=2, B=2, C_index=(2,))
        randomize_bn(init_params(model, torch.Generator().manual_seed(1)), torch.Generator().manual_seed(2))
        with torch.no_grad():
            model.betas.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(3))
        model.to(device)
        steps = SearchSteps(model, make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=8e-4),
                            make_arch_optimizer(model.arch_parameters(), 1e-3),
                            lr_schedule("cos", 0.05, 1, 2, min_lr=0.003))
        w_loss = steps.weight_step(image.to(device), label.to(device)).item()
        w_grads = {n: p.grad.cpu().double() for n, p in model.named_parameters() if n != "betas"}
        beta0 = model.betas.detach().cpu().double().clone()
        a_loss = steps.arch_step(image.to(device), label.to(device)).item()
        runs.append((w_loss, a_loss, w_grads, model.betas.grad.cpu().double(), beta0, model))
    (w0, a0, wg0, bg0, beta0, cpu), (w1, a1, wg1, bg1, _, card) = runs
    assert abs(w1 - w0) <= 1e-5 * w0 and abs(a1 - a0) <= 1e-5 * a0, (w0, w1, a0, a1)
    num = sum(float(((wg1[k] - wg0[k]) ** 2).sum()) for k in wg0)
    assert (num / sum(float((v ** 2).sum()) for v in wg0.values())) ** 0.5 <= 5e-4
    assert ((bg1 - bg0).norm() / bg0.norm()).item() <= 1e-4
    want = cpu.state_dict()
    for name, t in card.state_dict().items():
        if name == "betas":
            decayed = (bg0 + 1e-3 * beta0).abs()
            big = decayed > 1e-2 * decayed.max()
            err = (t.cpu().double() - want[name].double())[big].abs().max().item()
            assert big.sum() >= 8 and err <= 1e-6, err
            continue
        err = (t.cpu().double() - want[name].double()).abs().max().item()
        assert err <= 1e-5 * max(1.0, want[name].abs().max().item()), (name, err)


@needs_gpu
def test_device_augment_on_gpu_matches_cpu():
    """``make_train_augment`` on the card against the same function on CPU
    tensors (crop 65x65 from 96x128 and from 40x60, scales {0.5, 1, 1.7,
    2}, both flips): images |Δ| ≤ 1e-5·max(1, max|ref|), labels equal;
    ``make_eval_preprocess`` equal."""
    import numpy as np

    from auto_dynamic_deeplab_torch.data.device_transforms import make_eval_preprocess, make_train_augment

    rng = np.random.RandomState(0)
    crop = (65, 65)
    for hw in ((96, 128), (40, 60)):
        images = rng.randint(0, 256, (8, *hw, 3)).astype(np.uint8)
        masks = rng.choice([0, 3, 7, 18, 255], size=(8, *hw)).astype(np.uint8)
        scales = np.repeat(np.float32([0.5, 1.0, 1.7, 2.0]), 2)
        flips = np.tile([False, True], 4)
        offs = [[rng.randint(0, max(int(round(n * s)), c) - c + 1) for s in scales] for n, c in zip(hw, crop)]
        args = (images, masks, scales, flips, np.int32(offs[0]), np.int32(offs[1]))
        got = make_train_augment(hw, crop, device="cuda")(*args)
        want = make_train_augment(hw, crop, device="cpu")(*args)
        assert got[0].device.type == "cuda" and got[0].dtype == torch.float32 and got[1].dtype == torch.int64
        tol = 1e-5 * max(1.0, want[0].abs().max().item())
        assert (got[0].cpu() - want[0]).abs().max().item() <= tol
        assert torch.equal(got[1].cpu(), want[1])
        got = make_eval_preprocess(hw, (97, 129), device="cuda")(images, masks)
        want = make_eval_preprocess(hw, (97, 129), device="cpu")(images, masks)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@needs_gpu
def test_raw_cache_trains_with_device_augment_on_gpu(tmp_path):
    """A RawArrayCache built from seeded uint8 frames feeds ``Trainer`` with
    ``device_augment`` on the card: one step at 33x65 from 96x128 frames,
    the augmented batch on the card and a finite loss."""
    import numpy as np

    from auto_dynamic_deeplab_torch import models as pt_models
    from auto_dynamic_deeplab_torch.data import DataLoader, RawArrayCache, peek_batch
    from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.RandomState(1)
    frames = [{"image_u8": rng.randint(0, 256, (96, 128, 3)).astype(np.uint8),
               "label_u8": rng.choice([0, 5, 18, 255], size=(96, 128)).astype(np.uint8)} for _ in range(2)]
    cache = RawArrayCache.build(frames, str(tmp_path / "cache"))
    loader = DataLoader(cache, 2, num_workers=1)
    model = pt_models.ADD([1, 2, 2, 2, 3, 2], [1], AUTODEEPLAB_GENOTYPE, 19, F=4, B=5)
    init_params(model, torch.Generator().manual_seed(0))
    cfg = TrainConfig(epochs=1, eval_interval=0, run_dir=str(tmp_path), device_augment=True, crop_size=(33, 65))
    trainer = Trainer(model, loader, None, cfg, device="cuda", seed=3)
    image, label = trainer._device_augment(peek_batch(loader), epoch=0, b=0)
    assert image.is_cuda and image.shape == (2, 33, 65, 3) and label.shape == (2, 33, 65)
    loss = trainer.training(0)
    assert np.isfinite(loss) and len(trainer.step_ms) == 1 and trainer.train_step.step == 1
