"""The port's other eval executions of the cells (``--cell-exec packed``,
``flat-packed``, ``dense-sep``), ``cli.evaluate --flops``, the signal
study and the API leftovers, against the JAX package on the CPU.

Sizes: the cells of tests/test_torch_model.py (C_out=4, B=5) and its tiny
ADD (path [1,2,2,2,3,2], F=4, B=5, 7 classes, 33x65). Weights are seeded
numpy draws with BN statistics away from their initial values
(``flax_variables``). Tolerances: cells fp32 |Δ| ≤ 1e-4·max(1, max|ref|);
the ADD's logits fp32 |Δ| ≤ 1e-3·max|ref|; bf16 the files' policy (2x the
JAX bf16 path's own error against JAX fp32, plus 1e-3); the study's
cosines and entropies 1e-5; metrics, params and schedules exact.

JAX's flat-packed program at batch 1 runs its Pallas kernels in interpret
mode (about 70 s to compile here); at batch 2 its flat path steps aside
(batch-1 only) and the packed DAG runs, while the port's flat path takes
any batch. So flat-packed is held to JAX's same flags at batch 2.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.cli import evaluate as pt_cli
from auto_dynamic_deeplab_torch.data import DataLoader as PtLoader
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation as PtSynthetic
from auto_dynamic_deeplab_torch.models.path_supernet import ModelSearch as PtModelSearch
from auto_dynamic_deeplab_torch.nas.genotypes import load_genotype as pt_load_genotype
from auto_dynamic_deeplab_torch.ops import packed as pt_packed
from auto_dynamic_deeplab_torch.ops import primitives as pt_prim
from auto_dynamic_deeplab_torch.ops.aspp import ASPPLite as PtASPPLite
from auto_dynamic_deeplab_torch.train import analysis as pt_analysis
from auto_dynamic_deeplab_torch.train.loss import multi_exit_cross_entropy
from auto_dynamic_deeplab_torch.train.step import make_eval_step as pt_make_eval_step
from auto_dynamic_deeplab_torch.utils import flops as pt_flops
from auto_dynamic_deeplab_torch.utils import profiling as pt_profiling
from auto_dynamic_deeplab_torch.utils.initialize import init_params
from auto_dynamic_deeplab_torch.utils.metrics import Evaluator as PtEvaluator
from auto_dynamic_deeplab_torch.utils.restore import copy_state_dict as pt_copy_state_dict
from auto_dynamic_deeplab_torch.utils.summaries import TrainingSummary as PtSummary
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.data import DataLoader as JxLoader
from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation as JxSynthetic
from auto_dynamic_deeplab_tpu.models.cell import FixedCell as JxCell
from auto_dynamic_deeplab_tpu.models.cell import edge_op_assignment
from auto_dynamic_deeplab_tpu.models.path_supernet import ModelSearch as JxModelSearch
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.nas.genotypes import load_genotype as jx_load_genotype
from auto_dynamic_deeplab_tpu.ops import packed as jx_packed
from auto_dynamic_deeplab_tpu.ops import primitives as jx_prim
from auto_dynamic_deeplab_tpu.ops.aspp import ASPPLite as JxASPPLite
from auto_dynamic_deeplab_tpu.train import analysis as jx_analysis
from auto_dynamic_deeplab_tpu.train.step import make_eval_step as jx_make_eval_step
from auto_dynamic_deeplab_tpu.utils.flops import count_params as jx_count_params
from auto_dynamic_deeplab_tpu.utils.metrics import Evaluator as JxEvaluator
from auto_dynamic_deeplab_tpu.utils.restore import copy_state_dict as jx_copy_state_dict

from test_torch_model import CELL_CASES, RANDOM_GENOTYPE
from torch_port_helpers import (
    assert_bf16_within_jax,
    assert_close_fp32_model,
    assert_close_fp32_module,
    flax_variables,
    jx,
    nchw,
    nhwc_np,
    port_module,
)

PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)
VARIANTS = {
    "packed": dict(packed_eval=True),
    "flat-packed": dict(flat_eval=True, packed_eval=True),
    "dense-sep": dict(dense_sep_eval=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests are small: one intra-op thread keeps them from competing
    for the cores with the other test files' workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rows(genotype):
    return tuple((int(e), int(o)) for e, o in genotype)


# --------------------------------------------------------------- schedule


def _random_genotype(seed):
    """B=5: two distinct edges a block, any of the 8 ops, rows shuffled."""
    rng = np.random.RandomState(seed)
    rows, offset = [], 0
    for b in range(5):
        for e in sorted(rng.choice(2 + b, 2, replace=False)):
            rows.append([offset + int(e), int(rng.randint(8))])
        offset += 2 + b
    return [rows[i] for i in rng.permutation(len(rows))]


@pytest.mark.parametrize("genotype", ["shipped", 11, 12, 13])
def test_schedule_waves_matches_jax(genotype):
    g = AUTODEEPLAB_GENOTYPE if genotype == "shipped" else _random_genotype(genotype)
    assignment = edge_op_assignment(_rows(g))
    assert pt_packed.schedule_waves(assignment, 5) == jx_packed.schedule_waves(assignment, 5)


# ------------------------------------------------------------------ cells


_CELL_REFS = {}


def _cell_case(case):
    """(inputs, port ctor kwargs, JAX module factory, variables, JAX packed
    fp32 outputs) of one CELL_CASES entry, built once."""
    if case in _CELL_REFS:
        return _CELL_REFS[case]
    genotype, downup, s1_hw, s0_spec, dense_out = CELL_CASES[case]
    s1 = _x((1, *s1_hw, 8), seed=1)
    if isinstance(s0_spec, list):
        s0 = [_x((1, *hw, c), seed=2 + i) for i, (c, hw) in enumerate(s0_spec)]
        kw_jx = dict(dense_in=True, num_dense_in=len(s0))
        kw_pt = dict(dense_in_channels=[c for c, _ in s0_spec])
    else:
        s0 = _x((1, 9, 11, s0_spec), seed=2)
        kw_jx, kw_pt = {}, dict(C_prev_prev=s0_spec)
    s0_jx = [jx(t) for t in s0] if isinstance(s0, list) else jx(s0)

    def jmod(dtype=None):
        return JxCell(genotype=_rows(genotype), B=5, C_out=4, downup_sample=downup,
                      dense_out=dense_out, packed_eval=True, dtype=dtype, **kw_jx)

    v = flax_variables(jmod(), s0_jx, jx(s1), False)
    ref = jax.jit(lambda v, a, b: jmod().apply(v, a, b, False))(v, s0_jx, jx(s1))
    pt_args = (genotype, 5, 4, downup, 8)
    pt_kw = dict(dense_out=dense_out, packed_eval=True, **kw_pt)
    _CELL_REFS[case] = ((s0, s1, s0_jx), (pt_args, pt_kw), jmod, v, ref)
    return _CELL_REFS[case]


def _port_inputs(s0, s1):
    return [nchw(t) for t in s0] if isinstance(s0, list) else nchw(s0), nchw(s1)


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_packed_cell_fp32(case):
    (s0, s1, _), (args, kw), _, v, ref = _cell_case(case)
    out = port_module(pt_models.FixedCell(*args, **kw), v)(*_port_inputs(s0, s1))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert_close_fp32_module(nhwc_np(o), r)


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_packed_cell_bf16(case):
    (s0, s1, s0_jx), (args, kw), jmod, v, ref = _cell_case(case)
    ref16 = jax.jit(lambda v, a, b: jmod(jnp.bfloat16).apply(v, a, b, False))(v, s0_jx, jx(s1))
    out = port_module(pt_models.FixedCell(*args, dtype=torch.bfloat16, **kw), v)(*_port_inputs(s0, s1))
    for o, r16, r32 in zip(out, ref16, ref):
        assert_bf16_within_jax(nhwc_np(o), np.asarray(r16, np.float32), r32)


def test_packed_flags_change_nothing_in_training():
    """Training runs the per-op modules with either flag: the same loss,
    gradients and BN statistics as the plain cell, and the same
    parameter set (JAX test_packed_flag_does_not_change_params_or_train)."""
    genotype, downup, s1_hw, s0_spec, dense_out = CELL_CASES["random-up-dense-in"]
    s0 = [nchw(_x((2, *hw, c), seed=2 + i)) for i, (c, hw) in enumerate(s0_spec)]
    s1 = nchw(_x((2, *s1_hw, 8), seed=1))
    runs = []
    for flags in ({}, dict(packed_eval=True), dict(dense_sep_eval=True)):
        cell = pt_models.FixedCell(genotype, 5, 4, downup, 8, dense_in_channels=[c for c, _ in s0_spec], **flags)
        init_params(cell, torch.Generator().manual_seed(3))
        cell.train()
        loss = cell(s0, s1)[1].square().mean()
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in cell.named_parameters()},
                     {k: b.clone() for k, b in cell.named_buffers()}))
    for loss, grads, bufs in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert grads.keys() == runs[0][1].keys() and all(torch.equal(grads[k], runs[0][1][k]) for k in grads)
        assert all(torch.equal(bufs[k], runs[0][2][k]) for k in bufs)


def test_packed_and_composed_weights_kept_until_a_weight_changes():
    """Folded once per weight version: the same objects on the next call,
    new ones (and the new weights' outputs) after load_state_dict."""
    _, (args, kw), _, v, _ = _cell_case("shipped-up-dense-in-out")
    cell = port_module(pt_models.FixedCell(*args, **kw), v)
    first = cell.packed_weights(torch.float32)
    assert cell.packed_weights(torch.float32) is first
    sep = next(m for m in cell.modules() if isinstance(m, pt_prim.SepConv))
    sep.dense_form = True
    composed = sep.composed(torch.float32)
    assert sep.composed(torch.float32) is composed
    state = {k: t * 1.5 if t.is_floating_point() else t for k, t in cell.state_dict().items()}
    cell.load_state_dict(state)
    again = cell.packed_weights(torch.float32)
    assert again is not first and not torch.equal(again["taps"].w, first["taps"].w)
    assert sep.composed(torch.float32) is not composed
    assert torch.allclose(sep.composed(torch.float32)[0], composed[0] * 1.5 ** 2)


# --------------------------------------------------------------- dense sep


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2), (5, 2)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_form_sepconv_matches_jax(k, stride, dtype):
    x = _x((1, 13, 17, 6), seed=k + stride)
    jdt = jnp.bfloat16 if dtype == "bf16" else None

    def jmod(dt):
        return jx_prim.SepConv(features=6, kernel_size=k, stride=stride, padding=k // 2, dense_form=True, dtype=dt)

    v = flax_variables(jmod(None), jx(x), False)
    ref = jmod(None).apply(v, jx(x), False)
    pm = port_module(pt_prim.SepConv(6, 6, k, stride, k // 2, dense_form=True,
                                     dtype=torch.bfloat16 if jdt else None), v)
    out = nhwc_np(pm(nchw(x)))
    if jdt is None:
        assert_close_fp32_module(out, ref)
    else:
        ref16 = jmod(jdt).apply(v, jx(x), False)
        assert_bf16_within_jax(out, np.asarray(ref16, np.float32), ref)


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module")
def tiny():
    """Seeded variables of the tiny JAX ADD and two images."""
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=5)
    return v, _x((2, *HW, 3), seed=4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_add_variant_fp32_matches_jax(tiny, variant):
    v, x = tiny
    flags = VARIANTS[variant]
    x = x if variant == "flat-packed" else x[:1]  # see the module docstring
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, **flags)
    refs = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jx(x))
    pm = port_module(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, **flags), v)
    outs = pm(torch.from_numpy(x))
    assert len(outs) == len(refs) == 2
    for o, r in zip(outs, refs):
        assert_close_fp32_model(o.numpy(), r)


# -------------------------------------------------------------------- CLI


_CLI = ["--device", "cpu", "--F", "4", "--synthetic-crop", "33", "65", "--synthetic-length", "4",
        "--workers", "1"]


def _jax_params_of_cli_model(nclass):
    """JAX ``count_params`` of the ADD the CLI builds at --F 4 (C=2)."""
    from auto_dynamic_deeplab_tpu.nas import NETWORK_ARCH

    cfg = NETWORK_ARCH[2]
    jm = jx_models.ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, nclass, F=4, B=5,
                       low_level_layer=cfg["low_level_layer"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))
    return jx_count_params(shapes["params"])


_MODES = {
    "static-flops": ["--flops"],
    "dynamic": ["--dynamic", "--confidence", "entropy", "--threshold", "0.5"],
    "pipelined": ["--dynamic", "--confidence", "entropy", "--threshold", "0.5", "--pipeline-devices", "2"],
}


@pytest.mark.parametrize("cell_exec", sorted(VARIANTS))
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cli_cell_exec_and_flops(cell_exec, mode, capsys):
    stats = pt_cli.main(_CLI + ["--cell-exec", cell_exec] + _MODES[mode])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"] == "cpu"
    if mode != "static-flops":
        assert sum(stats["exit_histogram"]) == stats["n_images"] > 0
        return
    assert len(stats["miou"]) == 2 and all(0.0 <= m <= 1.0 for m in stats["miou"])
    c = stats["complexity"]
    assert c["params"] == _jax_params_of_cli_model(19)
    assert c["flops"] > 0 and c["bytes_accessed"] > 0


def test_model_complexity_counts_the_convolutions():
    """FlopCounterMode's count of a small ADD equals 2 x the multiply-adds
    of its convolutions (summed here from hooks), and the model is left
    untouched (same parameters, same mode, no cached weights)."""
    m = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    init_params(m, torch.Generator().manual_seed(0))
    macs = []

    def hook(mod, args, out):
        w = mod.kernel
        macs.append(out.numel() * w.shape[1] * w.shape[2] * w.shape[3])

    hooks = [mod.register_forward_hook(hook) for mod in m.modules() if isinstance(mod, pt_prim.Conv2d)]
    with torch.no_grad():
        m.eval()(torch.zeros(1, *HW, 3))
    for h in hooks:
        h.remove()
    before = {k: t.clone() for k, t in m.state_dict().items()}
    m.train()
    c = pt_flops.model_complexity(m, (1, *HW, 3))
    assert c["flops"] == 2 * sum(macs)
    assert c["params"] == pt_flops.count_params(m) == sum(p.numel() for p in m.parameters())
    assert m.training and all(torch.equal(t, before[k]) for k, t in m.state_dict().items())


def test_profiling_helpers(tmp_path):
    lin = torch.nn.Linear(8, 4)
    x = torch.ones(3, 8)
    assert pt_profiling.flops_of(lin, x) == 2 * 3 * 8 * 4
    assert pt_profiling.device_time(lin, x, iters=3, warmup=1) > 0
    with pt_profiling.trace(str(tmp_path)):
        lin(x)
    trace = json.loads((tmp_path / pt_profiling.TRACE_FILE).read_text())
    assert trace["traceEvents"]


# --------------------------------------------------------------- analysis


def test_entropy_signal_study_matches_jax(tiny):
    v, _ = tiny
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    pm = port_module(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v)

    def loader(synthetic, data_loader):
        return data_loader(synthetic(4, HW, NCLS), 2, shuffle=False, drop_last=False, num_workers=1)

    ref = jx_analysis.entropy_signal_study(jm, v, loader(JxSynthetic, JxLoader), NCLS, 0.5)
    out = pt_analysis.entropy_signal_study(pm, loader(PtSynthetic, PtLoader), NCLS, 0.5)
    assert out["n"] == ref["n"] == 4
    for key in ("cos_entropy_loss", "cos_max_loss", "cos_pool_loss"):
        assert abs(out[key] - ref[key]) <= 1e-5, key
    np.testing.assert_allclose(out["entropy"], np.asarray(ref["entropy"]), atol=1e-5)
    np.testing.assert_allclose(out["loss"], np.asarray(ref["loss"]), rtol=1e-5)
    assert pt_analysis.cosine_similarity([1, 2], [2, 4]) == pytest.approx(1.0)


# ---------------------------------------------------------- API leftovers


def test_metric_leftovers_match_jax():
    rng = np.random.RandomState(3)
    gt = rng.randint(0, NCLS, (2, 9, 11))
    gt[0, :2] = 255
    pred = rng.randint(0, NCLS - 1, (2, 9, 11))
    ref, out = JxEvaluator(NCLS), PtEvaluator(NCLS)
    ref.add_batch(gt, pred)
    out.add_batch(gt, torch.from_numpy(pred))
    assert out.Pixel_Accuracy_Class() == ref.Pixel_Accuracy_Class()
    assert out.Frequency_Weighted_Intersection_over_Union() == ref.Frequency_Weighted_Intersection_over_Union()


def test_copy_state_dict_matches_jax():
    """One entry missing from the source, one extra, one of another shape:
    the same report as JAX's over the same tree, the matching entries
    copied, the others kept."""
    m = pt_models.FixedCell(RANDOM_GENOTYPE, 5, 4, 0, 8, C_prev_prev=5)
    init_params(m, torch.Generator().manual_seed(1))
    target = {k: t.numpy().copy() for k, t in m.state_dict().items()}
    source = {k: t + 1.0 for k, t in target.items()}
    keys = sorted(source)
    del source[keys[0]]
    source[keys[1]] = np.zeros((3, 3), np.float32)
    source["bogus.kernel"] = np.zeros(2, np.float32)

    def tree(flat):
        out = {}
        for k, a in flat.items():
            d = out
            *head, leaf = k.split(".")
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = a
        return out

    def names(report_keys):  # "['a']['b']" -> "a.b"
        return sorted(k.replace("']['", ".").strip("[]'") for k in report_keys)

    _, jrep = jx_copy_state_dict(tree(target), tree(source), verbose=False)
    updated, rep = pt_copy_state_dict(m, {k: torch.from_numpy(a) for k, a in source.items()}, verbose=False)
    assert rep["missing"] == names(jrep["missing"]) == [keys[0]]
    assert sorted(rep["unexpected"]) == names(jrep["unexpected"]) == ["bogus.kernel"]
    assert len(rep["mismatched"]) == len(jrep["mismatched"]) == 1 and rep["mismatched"][0].startswith(keys[1])
    state = updated.state_dict()
    for k in keys:
        want = target[k] + 1.0 if k not in (keys[0], keys[1]) else target[k]
        np.testing.assert_array_equal(state[k].numpy(), want)


def test_load_genotype_matches_jax(tmp_path):
    good, bad = tmp_path / "g.npy", tmp_path / "bad.npy"
    np.save(good, np.asarray(RANDOM_GENOTYPE, np.int32))
    np.save(bad, np.zeros((4, 3), np.int64))
    out = pt_load_genotype(str(good))
    np.testing.assert_array_equal(out, jx_load_genotype(str(good)))
    assert out.dtype == np.int64
    with pytest.raises(ValueError, match="bad genotype shape"):
        pt_load_genotype(str(bad))
    with pytest.raises(AssertionError, match="bad genotype shape"):
        jx_load_genotype(str(bad))


def test_make_eval_step_matches_jax(tiny):
    v, x = tiny
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    ref = jx_make_eval_step(jm)(v, jx(x))
    pm = port_module(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v).train()
    out = pt_make_eval_step(pm)(torch.from_numpy(x))
    assert len(out) == len(ref) == 2 and not pm.training
    for o, r in zip(out, ref):
        assert o.shape == (2, *HW)
        assert np.mean(o.numpy() == np.asarray(r)) >= 0.999  # argmax ties at fp32 rounding


def test_aspp_lite_matches_jax():
    x, low = _x((1, 65, 81, 8), seed=21), _x((1, 129, 161, 4), seed=22)
    jm = JxASPPLite(mid_channels=6, num_classes=NCLS)
    v = flax_variables(jm, jx(x), jx(low), False)
    ref = jm.apply(v, jx(x), jx(low), False)
    out = port_module(PtASPPLite(8, 4, 6, NCLS), v)(nchw(x), nchw(low))
    assert_close_fp32_module(nhwc_np(out), ref)


def test_visualize_image_writes_png_grids(tmp_path):
    from PIL import Image

    summary = PtSummary(str(tmp_path))
    rng = np.random.RandomState(0)
    image = rng.randn(4, 9, 11, 3).astype(np.float32)
    target = rng.randint(0, 19, (4, 9, 11))
    pred = rng.randint(0, 19, (4, 9, 11))
    paths = summary.visualize_image(image, target, pred, step=7)
    summary.close()
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["image_7.png", "pred_7.png", "gt_7.png"]
    for p in paths:
        assert np.asarray(Image.open(p)).shape == (9, 33, 3)  # 3 images side by side


# ----------------------------------------------------------- remat policy


def _conv_calls_in_backward(policy):
    """(gradient, aten.convolution calls during backward) of one training
    step of a tiny mixed supernet, with remat and ``policy``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func is torch.ops.aten.convolution.default
            return func(*args, **(kwargs or {}))

    m = PtModelSearch(5, num_layers=4, F=2, B=2, exit_layer=2, remat=policy != "off",
                      remat_policy=None if policy in ("off", "none") else policy).train()
    init_params(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 65, 65, 3), seed=30))
    y = torch.from_numpy(np.random.RandomState(31).randint(0, 5, (2, 65, 65)))
    loss = multi_exit_cross_entropy(m(x, class_leading=True), y)
    with Count():
        loss.backward()
    grad = torch.cat([p.grad.flatten() for p in m.parameters() if p.grad is not None])
    return grad, Count.n, {k: b.clone() for k, b in m.named_buffers()}


def test_remat_policies_keep_the_gradients():
    """Every policy gives the no-remat gradients and BN statistics
    bitwise; full remat recomputes the cells' convs in backward, 'dots'
    and 'offload_dots' recompute none of them."""
    grad0, convs0, bufs0 = _conv_calls_in_backward("off")
    recomputed = {}
    for policy in ("none", "dots", "offload_dots"):
        grad, convs, bufs = _conv_calls_in_backward(policy)
        assert torch.equal(grad, grad0), policy
        assert all(torch.equal(bufs[k], bufs0[k]) for k in bufs), policy
        recomputed[policy] = convs - convs0
    assert recomputed["none"] > 0 and recomputed["dots"] == recomputed["offload_dots"] == 0


@pytest.mark.parametrize("kw", [dict(remat=True, remat_policy="everything"),
                                dict(remat=False, remat_policy="dots")])
def test_remat_policy_errors_match_jax(kw):
    with pytest.raises(ValueError) as pt_err:
        PtModelSearch(5, num_layers=4, F=2, B=2, exit_layer=2, **kw)
    jm = JxModelSearch(num_classes=5, num_layers=4, F=2, B=2, exit_layer=2, **kw)
    with pytest.raises(ValueError) as jx_err:
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=False))
    assert str(pt_err.value) == str(jx_err.value)
