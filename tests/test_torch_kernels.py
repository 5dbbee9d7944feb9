"""K1 (stems) and K2 (entropy + argmax) of the port.

On the CPU the plain versions are held against the JAX package: the stems
against its ``_Stems`` module, entropy-argmax against
``entropy_argmax_reference`` and against ``entropy_argmax_pallas`` in
interpret mode. K1's host side (packed weights, plans) is checked here, and
its scheme emulated in torch against the plain version. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: stems fp32 |Δ| ≤ 1e-4·max(1, max|ref|); stems bf16 relative
error vs the JAX fp32 oracle ≤ 2x the JAX bf16 path's own plus 1e-3;
entropy |Δ| ≤ 1e-5 (fp32); argmax exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from auto_dynamic_deeplab_torch.kernels import confidence as pt_conf
from auto_dynamic_deeplab_torch.kernels import stems as pt_stems
from auto_dynamic_deeplab_torch.models.decoded import _Stems as PtStems
from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn
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
    tf32,
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
    with pytest.raises(ValueError, match="CUDA"):
        pt_stems.fused_stems(nchw(_image((17, 19))), pt_stems.stem_weights(m, torch.float32))


def test_stems_train_mode_not_ported(stem_vars):
    """Training mode runs the plain stems with batch statistics (K1 folds
    eval BN), as the JAX ``_Stems(train=True)``: s0, s1 and the updated
    BN statistics at the stems' fp32 tolerance."""
    x = _image((9, 9), n=2)
    ref, mutated = JxStems().apply(stem_vars, jx(x), True, mutable=["batch_stats"])
    m = port_module(PtStems(), stem_vars).train()
    for o, r in zip(m(nchw(x)), ref):
        assert_close_fp32_module(nhwc_np(o), r)
    for name, stats in mutated["batch_stats"].items():
        bn = getattr(m, name)
        for k in ("mean", "var"):
            assert_close_fp32_module(getattr(bn, k).numpy(), stats[k])


# ----------------------------------------------- K1 (tensor-core) host side


def _random_stems(dtype=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    return randomize_bn(init_params(PtStems(dtype), g), g).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k1_packed_weights_unpack_exactly(dtype):
    """K1's B operands hold the conv weights times the BN scale, folded in
    fp32 and then cast: pk0 (1, 64, 32) with inputs in (kh, kw, ci) order
    and 5 zeros, pk1 (9, 64, 64) and pk2 (9, 128, 64) by tap (kh, kw);
    the biases are the folded BN biases in fp32."""
    m = _random_stems(dtype)
    w = pt_stems.stem_weights(m, dtype)
    for i, pk in enumerate((w.pk0, w.pk1, w.pk2)):
        conv, bn = getattr(m, f"stem{i}_conv"), getattr(m, f"stem{i}_bn")
        s, b = bn.folded()
        want = (conv.kernel.float() * s[:, None, None, None]).to(dtype)  # (out, in, 3, 3)
        o, c = want.shape[:2]
        assert pk.dtype == dtype and pk.is_contiguous()
        if i == 0:
            assert pk.shape == (1, 64, 32) and not pk[:, :, 27:].any()
            got = pk[0, :, :27].reshape(64, 3, 3, 3).permute(0, 3, 1, 2)
        else:
            assert pk.shape == (9, o, c)
            got = pk.reshape(3, 3, o, c).permute(2, 3, 0, 1)
        assert torch.equal(got, want)
        bias = getattr(w, f"b{i}")
        assert bias.dtype == torch.float32 and torch.equal(bias, b.float())


def test_k1_weights_pack_once_and_repack_on_change():
    m = _random_stems()
    w = pt_stems.stem_weights(m, torch.float32)
    assert pt_stems.stem_weights(m, torch.float32) is w  # kept on the module
    assert pt_stems.stem_weights(m, torch.bfloat16).pk1.dtype == torch.bfloat16  # another dtype: packed anew
    with torch.no_grad():
        m.stem2_bn.var.mul_(2.0)  # a statistic changes in place: packed again
    w2 = pt_stems.stem_weights(m, torch.float32)
    assert w2 is not w and torch.equal(w2.pk1, w.pk1) and not torch.equal(w2.pk2, w.pk2)
    with torch.no_grad():
        m.stem1_conv.kernel.add_(1.0)
    assert not torch.equal(pt_stems.stem_weights(m, torch.float32).pk1, w.pk1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,n", [((1025, 2049), 1), ((33, 65), 2), ((65, 97), 1)])
def test_k1_plans_fit_shared_memory_and_residency(hw, n, dtype):
    """K1's plan fits 227 KB a block with at most 64 s1 pixels a tile;
    bf16 keeps two blocks an SM and fp32 one; at 1025x2049 the flagship
    tile is 7 x 8, 2405 blocks, over 9 (bf16) or 18 (fp32) waves of the
    132 SMs. Every tile of STEM_TILES fits."""
    plan = pt_stems.plan_stems(dtype, hw, n)
    tq, tw = plan.tile
    assert tq * tw <= 64 and plan.smem == pt_stems.stem_smem(tq, tw, dtype) <= pt_stems.SMEM_LIMIT
    assert plan.resident == pt_stems.MAX_RESIDENT[dtype]
    assert plan.resident * (plan.smem + 1024) <= pt_stems.SM_SMEM
    if hw == (1025, 2049):
        assert plan.tile == (7, 8) and pt_stems.stem_blocks(plan.tile, n, *hw) == 37 * 65
    for tile in pt_stems.STEM_TILES:
        assert pt_stems.stem_smem(*tile, dtype) <= pt_stems.SMEM_LIMIT


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T as the fp32 kernels do it: both split into tf32 hi + lo,
    lo*hi + hi*lo + hi*hi in fp32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def _emulate_k1(x: torch.Tensor, w, tile, halves: bool):
    """K1's fp32 arithmetic and addressing, block by block, in torch: the
    a0 window from stem0's im2col (inputs in (kh, kw, ci) order), stem1's
    taps as pixel offsets in the flat a0 window, the epilogue's ownership
    and padding, and stem2's taps as offsets in the flat ReLU(s0) window,
    whose rows hold their even columns before their odd ones (``halves``)
    or keep their order (A rows at stride 2)."""
    n_img, _, h, w_ = x.shape
    h0, w0 = (h - 1) // 2 + 1, (w_ - 1) // 2 + 1
    h1, w1 = (h0 - 1) // 2 + 1, (w0 - 1) // 2 + 1
    tq, tw = tile
    r0, c0, r1, c1 = 2 * tq + 3, 2 * tw + 3, 2 * tq + 1, 2 * tw + 1
    cp = 2 * tw + 2 if halves else c1
    s0 = torch.full((n_img, h0, w0, 64), float("nan"))
    s1 = torch.full((n_img, h1, w1, 128), float("nan"))
    m = 4 * max(tile) + 8  # margin of zeros around the image: the last tiles reach past it
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, m, m, m, m))

    def col(j):
        return (j % 2) * (tw + 1) + j // 2 if halves else j

    for n in range(n_img):
        for q0 in range(0, h1, tq):
            for p0 in range(0, w1, tw):
                ra, ca, rb, cb = 2 * q0 - 2, 2 * p0 - 2, 2 * q0 - 1, 2 * p0 - 1
                i, j = torch.meshgrid(torch.arange(r0), torch.arange(c0), indexing="ij")
                rows = [xp[n, m + 2 * (ra + i) - 1 + kh, m + 2 * (ca + j) - 1 + kw] for kh in range(3) for kw in range(3)]
                im2col = F.pad(torch.stack(rows, 2).reshape(r0 * c0, 27), (0, 5))
                inside = ((ra + i >= 0) & (ra + i < h0) & (ca + j >= 0) & (ca + j < w0)).reshape(-1, 1)
                a0 = torch.where(inside, F.relu(_mm_3xtf32(im2col, w.pk0[0]) + w.b0), 0.0)
                i, j = torch.meshgrid(torch.arange(r1), torch.arange(c1), indexing="ij")
                i, j = i.reshape(-1), j.reshape(-1)
                y = sum(_mm_3xtf32(a0[i * c0 + j + t // 3 * c0 + t % 3], w.pk1[t]) for t in range(9)) + w.b1
                gr, gc = rb + i, cb + j
                inside = (gr >= 0) & (gr < h0) & (gc >= 0) & (gc < w0)
                own = inside & (i > 0) & (j > 0)
                s0[n, gr[own], gc[own]] = y[own]
                p = torch.zeros(r1 * cp, 64)
                p[i * cp + col(j)] = torch.where(inside[:, None], F.relu(y), 0.0)
                lq, lp = torch.meshgrid(torch.arange(tq), torch.arange(tw), indexing="ij")
                lq, lp = lq.reshape(-1), lp.reshape(-1)
                base = 2 * lq * cp + (lp if halves else 2 * lp)
                z = sum(_mm_3xtf32(p[base + t // 3 * cp + col(t % 3)], w.pk2[t]) for t in range(9)) + w.b2
                keep = (q0 + lq < h1) & (p0 + lp < w1)
                s1[n, (q0 + lq)[keep], (p0 + lp)[keep]] = z[keep]
    return s0.permute(0, 3, 1, 2), s1.permute(0, 3, 1, 2)


@pytest.mark.parametrize("halves", [True, False], ids=["parity-columns", "stride-2"])
@pytest.mark.parametrize("tile", [(7, 8), (4, 16)])
@pytest.mark.parametrize("hw,n", [((33, 65), 2), ((66, 97), 1)])
def test_k1_addressing_and_3xtf32_emulated_match_plain(hw, n, tile, halves):
    """K1's scheme (tiles, halo, ownership, padding, im2col and tap order,
    stem2's stride-2 rows, 3xTF32 products), emulated in torch, matches
    the plain version within the fp32 tolerance at odd and ragged shapes,
    and writes every output pixel."""
    m = _random_stems(seed=hw[0])
    x = torch.from_numpy(_image(hw, n, seed=1)).permute(0, 3, 1, 2)
    got = _emulate_k1(x, pt_stems.stem_weights(m, torch.float32), tile, halves)
    with torch.no_grad():
        refs = pt_stems.stems_reference(m, x)
    for o, r in zip(got, refs):
        assert not o.isnan().any()
        assert_close_fp32_module(o.numpy(), r.numpy())


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


@pytest.mark.parametrize("n,hw,sms", [(1, 1025 * 2049, 132), (3, 65 * 97, 132), (2, 257 * 513, 132),
                                       (1, 37 * 53, 132), (8, 33 * 65, 16)])
def test_k2_plan_covers_every_block_once(n, hw, sms):
    """K2's persistent grid: per_sm programs for each SM shared among the
    images (at the main path's 1025x2049, 132 * 4 programs), at least one
    an image, never more than its blocks; the stride walk covers each
    block once; the partials' reduction width is the power of two at or
    above the program count."""
    cfg = pt_conf.K2_CONFIG
    p = pt_conf.plan(n, hw, sms)
    assert p.n_blocks == -(-hw // cfg.block_p) and 1 <= p.programs <= p.n_blocks
    assert p.programs == min(p.n_blocks, -(-sms * cfg.per_sm // n))
    assert p.r_block >= p.programs > p.r_block // 2 and p.r_block & (p.r_block - 1) == 0
    walked = sorted(b for pid in range(p.programs) for b in range(pid, p.n_blocks, p.programs))
    assert walked == list(range(p.n_blocks))
    if (n, hw) == (1, 1025 * 2049):
        assert p.programs == 132 * cfg.per_sm


def test_k2_scratch_is_kept_per_stream_and_grown(monkeypatch):
    """The partials and counters are allocated once per (device, stream)
    and reused while they suffice (a call then allocates nothing), grown
    when a call needs more, and the counters start at 0."""
    monkeypatch.setattr(pt_conf, "_SCRATCH", {})
    dev = torch.device("cpu")
    parts, counts = pt_conf._scratch(dev, 7, 1, 528)
    assert parts.numel() == 528 and counts.numel() == 1 and not counts.any()
    assert all(a is b for a, b in zip(pt_conf._scratch(dev, 7, 1, 100), (parts, counts)))
    grown = pt_conf._scratch(dev, 7, 3, 176)
    assert grown[0].numel() == 528 and grown[1].numel() == 3 and not grown[1].any()
    assert grown[0] is not parts
    other = pt_conf._scratch(dev, 8, 1, 528)
    assert other[0] is not grown[0] and len(pt_conf._SCRATCH) == 2
