"""K1 (stems) and K2 (entropy + argmax) of the port.

On the CPU the plain versions are held against the JAX package: the stems
against its ``_Stems`` module, entropy-argmax against
``entropy_argmax_reference`` and against ``entropy_argmax_pallas`` in
interpret mode. The kernels themselves are held against the plain versions
on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: stems fp32 |Δ| ≤ 1e-4·max(1, max|ref|); stems bf16 relative
error vs the JAX fp32 oracle ≤ 2x the JAX bf16 path's own plus 1e-3;
entropy |Δ| ≤ 1e-5 (fp32); argmax exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from auto_dynamic_deeplab_torch.kernels import confidence as pt_conf
from auto_dynamic_deeplab_torch.kernels import stems as pt_stems
from auto_dynamic_deeplab_torch.models.decoded import _Stems as PtStems
from auto_dynamic_deeplab_tpu.kernels.confidence import (
    entropy_argmax_pallas,
    entropy_argmax_reference,
)
from auto_dynamic_deeplab_tpu.models.decoded import _Stems as JxStems

from torch_port_helpers import (
    assert_bf16_within_jax,
    assert_close_fp32_module,
    flax_variables,
    jx,
    nchw,
    nhwc_np,
    port_module,
)


def _image(hw, n=1, seed=0):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def stem_vars():
    return flax_variables(JxStems(), jnp.zeros((1, 33, 33, 3)), False, seed=3)


# ------------------------------------------------------------------ stems


@pytest.mark.parametrize("hw", [(65, 97), (33, 33), (66, 98)])
def test_stems_plain_matches_jax_fp32(hw, stem_vars):
    x = _image(hw)
    ref = JxStems().apply(stem_vars, jx(x), False)
    outs = port_module(PtStems(), stem_vars)(nchw(x))
    for o, r in zip(outs, ref):
        assert_close_fp32_module(nhwc_np(o), r)


@pytest.mark.parametrize("hw", [(65, 97), (33, 33), (66, 98)])
def test_stems_plain_matches_jax_bf16(hw, stem_vars):
    x = _image(hw)
    ref32 = JxStems().apply(stem_vars, jx(x), False)
    ref16 = JxStems(dtype=jnp.bfloat16).apply(stem_vars, jx(x), False)
    outs = port_module(PtStems(dtype=torch.bfloat16), stem_vars)(nchw(x))
    for o, r16, r32 in zip(outs, ref16, ref32):
        assert o.dtype == torch.bfloat16
        assert_bf16_within_jax(nhwc_np(o), np.asarray(r16, np.float32), r32)


def test_stems_cpu_dispatch_uses_plain_version(stem_vars):
    before = pt_stems.fused_stems.launches
    port_module(PtStems(), stem_vars)(nchw(_image((17, 19))))
    assert pt_stems.fused_stems.launches == before == 0


def test_fused_stems_refuses_cpu_tensors(stem_vars):
    m = port_module(PtStems(), stem_vars)
    args = []
    for i in range(3):
        args += [getattr(m, f"stem{i}_conv").kernel, *getattr(m, f"stem{i}_bn").folded()]
    with pytest.raises(ValueError, match="CUDA"):
        pt_stems.fused_stems(nchw(_image((17, 19))), *args)


def test_stems_train_mode_not_ported(stem_vars):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_module(PtStems(), stem_vars)(nchw(_image((9, 9))), train=True)


# --------------------------------------------------------- entropy-argmax


def _logits(n, hw=(37, 53), c=19, seed=0, ties=False):
    x = np.random.RandomState(seed).randn(n, *hw, c).astype(np.float32) * 3
    return np.round(x) if ties else x  # integer logits: many exact ties


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_entropy_argmax_plain_matches_jax_reference(layout, n, ties):
    x = _logits(n, ties=ties)
    ent_r, arg_r = entropy_argmax_reference(jx(x), 19)
    xt = torch.from_numpy(x) if layout == "nhwc" else nchw(x)
    axis = -1 if layout == "nhwc" else 1
    ent, arg = pt_conf.entropy_argmax_reference(xt, 19, class_axis=axis)
    assert ent.shape == (n,) and arg.dtype == torch.int32
    assert np.abs(ent.numpy() - np.asarray(ent_r)).max() <= 1e-5
    np.testing.assert_array_equal(arg.numpy(), np.asarray(arg_r))


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_entropy_argmax_plain_matches_pallas_interpret(layout):
    x = _logits(1, hw=(33, 41), seed=1)
    with pltpu.force_tpu_interpret_mode():
        ent_p, arg_p = entropy_argmax_pallas(jx(x), 19)
    xt = torch.from_numpy(x) if layout == "nhwc" else nchw(x)
    ent, arg = pt_conf.entropy_argmax(xt, 19, class_axis=-1 if layout == "nhwc" else 1)
    assert abs(float(ent[0]) - float(ent_p[0])) <= 1e-5
    np.testing.assert_array_equal(arg.numpy(), np.asarray(arg_p))


def test_entropy_argmax_cpu_dispatch_uses_plain_version():
    before = pt_conf.entropy_argmax_triton.launches
    pt_conf.entropy_argmax(torch.from_numpy(_logits(1)), 19)
    assert pt_conf.entropy_argmax_triton.launches == before == 0


def test_entropy_argmax_triton_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pt_conf.entropy_argmax_triton(torch.from_numpy(_logits(1)), 19)
