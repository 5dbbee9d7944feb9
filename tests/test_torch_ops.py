"""The port's ops/ layer against the JAX package's, on the same numpy inputs
and weights (CPU, fp32). Tolerance: |Δ| ≤ 1e-4·max(1, max|ref|)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auto_dynamic_deeplab_torch.nas.genotypes as pt_genotypes
import auto_dynamic_deeplab_tpu.nas.genotypes as jx_genotypes
from auto_dynamic_deeplab_torch.models.decoded import EDM as PtEDM
from auto_dynamic_deeplab_torch.ops import aspp as pt_aspp
from auto_dynamic_deeplab_torch.ops import confidence as pt_conf
from auto_dynamic_deeplab_torch.ops import heads as pt_heads
from auto_dynamic_deeplab_torch.ops import norm as pt_norm
from auto_dynamic_deeplab_torch.ops import primitives as pt_prim
from auto_dynamic_deeplab_torch.ops import resize as pt_resize
from auto_dynamic_deeplab_tpu.models.decoded import EDM as JxEDM
from auto_dynamic_deeplab_tpu.ops import aspp as jx_aspp
from auto_dynamic_deeplab_tpu.ops import confidence as jx_conf
from auto_dynamic_deeplab_tpu.ops import heads as jx_heads
from auto_dynamic_deeplab_tpu.ops import norm as jx_norm
from auto_dynamic_deeplab_tpu.ops import primitives as jx_prim
from auto_dynamic_deeplab_tpu.ops import resize as jx_resize

from torch_port_helpers import (
    assert_close_fp32_module,
    flax_variables,
    jx,
    nchw,
    nhwc_np,
    port_module,
)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((7, 9), (13, 17)), ((13, 17), (7, 9)), ((9, 5), (4, 11))])
def test_resize_bilinear(align_corners, src, dst):
    x = _x((2, *src, 3))
    ref = jx_resize.resize_bilinear(jx(x), dst, align_corners=align_corners)
    out = pt_resize.resize_bilinear(nchw(x), dst, align_corners=align_corners)
    assert_close_fp32_module(nhwc_np(out), ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_class_leading(align_corners):
    x = _x((1, 9, 13, 5))
    ref = jx_resize.resize_bilinear_cl(jx(x), (33, 49), align_corners=align_corners)
    out = pt_resize.resize_bilinear_cl(torch.from_numpy(x), (33, 49), align_corners)
    assert_close_fp32_module(out.numpy(), ref)


# the up cells' 2x, the decoder's head upsample and a downscale
@pytest.mark.parametrize("src,dst", [((5, 6), (9, 11)), ((9, 17), (33, 65)), ((13, 17), (7, 9))])
def test_resize_bilinear_bf16_rounds_as_jax(src, dst):
    """bf16 rounds after each axis as the JAX package's gather path does:
    within one bf16 step of the largest value of JAX's bf16 resize, and
    equal to it on all but 2% of the elements (the fp32 sums' own order).
    Rounded once over both axes, 22-24% of the elements of the two
    upscales differ. (JAX's banded path for large upscales also rounds its
    interpolation weights to bf16; the port keeps them fp32.)"""
    x = _x((1, *src, 6), seed=3)
    ref = np.asarray(jx_resize.resize_bilinear(jnp.asarray(x, jnp.bfloat16), dst), np.float32)
    out = nhwc_np(pt_resize.resize_bilinear(nchw(x).bfloat16(), dst))
    assert np.abs(out - ref).max() <= 2.0 ** -8 * np.abs(ref).max()
    assert np.mean(out != ref) <= 0.02, np.mean(out != ref)


@pytest.mark.parametrize("dim,scale", [(1025, 0.25), (2049, 0.0625), (65, 2), (33, 0.5)])
def test_scale_dimension(dim, scale):
    assert pt_resize.scale_dimension(dim, scale) == jx_resize.scale_dimension(dim, scale)


# ---------------------------------------------------------------- BN eval


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_eval(affine):
    x = _x((2, 5, 7, 6), scale=2.0)
    jm = jx_norm.BatchNorm(affine=affine)
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pt_norm.BatchNorm(6, affine=affine), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)
    s, b = pm.folded()  # the folding K1's wrapper uses
    folded = nchw(x) * s.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    assert_close_fp32_module(nhwc_np(folded), ref)


# ------------------------------------------------------------- primitives


@pytest.mark.parametrize("name", jx_genotypes.PRIMITIVES)
def test_ops_primitive(name):
    C = 6
    x = _x((1, 9, 11, C))
    jm = jx_prim.OPS[name](C, 1)
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pt_prim.OPS[name](C, 1), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)


@pytest.mark.parametrize("hw", [(9, 11), (10, 12)])
@pytest.mark.parametrize("double", [False, True])
def test_factorized_reduce(hw, double):
    x = _x((1, *hw, 5))
    jcls = jx_prim.DoubleFactorizedReduce if double else jx_prim.FactorizedReduce
    pcls = pt_prim.DoubleFactorizedReduce if double else pt_prim.FactorizedReduce
    jm = jcls(features=8)
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pcls(5, 8), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)


def test_relu_conv_bn_strided():
    x = _x((1, 9, 11, 4))
    jm = jx_prim.ReLUConvBN(features=6, kernel_size=3, stride=2, padding=1)
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pt_prim.ReLUConvBN(4, 6, 3, 2, 1), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)


# ------------------------------------------------------------------- ASPP


# (h, w, mult): all three dilated branches in the JAX package's shifted
# form, with shifts larger than the map; exactly one shifted; two shifted.
@pytest.mark.parametrize("h,w,mult", [(9, 13, 1.0), (57, 61, 0.5), (33, 35, 0.5)])
def test_aspp_train(h, w, mult):
    x = _x((1, h, w, 8))
    jm = jx_aspp.ASPPTrain(out=32, depth=16, mult=mult)
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pt_aspp.ASPPTrain(8, out=32, depth=16, mult=mult), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)


# ------------------------------------------------------------------ heads


@pytest.mark.parametrize("class_leading", [False, True])
def test_decoder_head(class_leading):
    x = _x((1, 5, 9, 256), seed=1)
    low = _x((1, 9, 17, 48), seed=2)
    size = (33, 65)
    jm = jx_heads.DecoderHead(num_classes=7)
    v = flax_variables(jm, jx(x), jx(low), size, False)
    ref = jm.apply(v, jx(x), jx(low), size, False, class_leading)
    pm = port_module(pt_heads.DecoderHead(7), v)
    out = pm(nchw(x), nchw(low), size, class_leading)
    assert_close_fp32_module(out.numpy(), ref)


def test_low_level_conv():
    x = _x((1, 9, 11, 20))
    jm = jx_heads.LowLevelConv()
    v = flax_variables(jm, jx(x), False)
    ref = jm.apply(v, jx(x), False)
    pm = port_module(pt_heads.LowLevelConv(20), v)
    assert_close_fp32_module(nhwc_np(pm(nchw(x))), ref)


def test_edm():
    x = _x((2, 9, 17, 40))
    jm = JxEDM()
    v = flax_variables(jm, jx(x))
    ref = jm.apply(v, jx(x))
    pm = port_module(PtEDM(40), v)
    assert_close_fp32_module(pm(nchw(x)).detach().numpy(), ref)


# ------------------------------------------------------------- confidence


@pytest.mark.parametrize("class_axis", [-1, 1])
def test_confidence_signals(class_axis):
    x = _x((2, 9, 11, 7), scale=3.0)
    xt = torch.from_numpy(x)
    if class_axis == 1:
        x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
        xt = torch.from_numpy(x)
    ent = pt_conf.normalized_shannon_entropy(xt, 7, class_axis)
    ent_ref = jx_conf.normalized_shannon_entropy(jx(x), 7, class_axis)
    assert np.abs(ent.numpy() - np.asarray(ent_ref)).max() <= 1e-5
    cm = pt_conf.confidence_max(xt, 0.5, class_axis)
    cm_ref = jx_conf.confidence_max(jx(x), 0.5, class_axis)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(cm_ref))


# -------------------------------------------------------------- genotypes


def test_genotype_copies_equal():
    assert pt_genotypes.PRIMITIVES == jx_genotypes.PRIMITIVES
    assert pt_genotypes.NETWORK_ARCH == jx_genotypes.NETWORK_ARCH
    assert pt_genotypes.SEARCH_C_INDEX == jx_genotypes.SEARCH_C_INDEX
    np.testing.assert_array_equal(
        pt_genotypes.AUTODEEPLAB_GENOTYPE, jx_genotypes.AUTODEEPLAB_GENOTYPE
    )


def test_genotype_record_matches_jax():
    """``nas.Genotype``: the JAX package's NamedTuple, field for field."""
    assert pt_genotypes.Genotype._fields == jx_genotypes.Genotype._fields == ("cell", "cell_concat")
    rows, concat = [[0, 1], [2, 3]], range(2, 7)
    assert tuple(pt_genotypes.Genotype(rows, concat)) == tuple(jx_genotypes.Genotype(rows, concat))
