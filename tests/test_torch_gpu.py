"""K1 and K2 against their plain versions on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which configures jax). Without a
GPU the kernel tests skip. Tolerances: K1 relative max error ≤ 1e-4 in
fp32 (TF32 off) and ≤ 2e-2 in bf16 (bf16 rounds at other points than
cuDNN); K2 entropy |Δ| ≤ 1e-5 in fp32 and ≤ 1e-4 in bf16, argmax exact.
"""
import pytest
import torch

from auto_dynamic_deeplab_torch.kernels import _build
from auto_dynamic_deeplab_torch.kernels import confidence as pt_conf
from auto_dynamic_deeplab_torch.kernels import stems as pt_stems
from auto_dynamic_deeplab_torch.models.decoded import _Stems
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

needs_gpu = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="launches a CUDA/Triton kernel: needs a GPU"
)


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double().cpu(), ref.double().cpu()
    return ((a - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,n", [((65, 97), 1), ((66, 98), 2), ((33, 33), 1)])
def test_k1_matches_plain_on_gpu(hw, n, dtype):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    stems = randomize_bn(init_params(_Stems(dtype), g), g).cuda().eval()
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


def test_library_name_tracks_source_and_flags(monkeypatch):
    """The build cache key changes with the nvcc flags, so a stale library
    is never loaded; the build directory lies inside the checkout."""
    name = _build.library_path("stems")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path("stems") != name
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
