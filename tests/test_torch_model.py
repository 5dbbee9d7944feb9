"""The port's cells, decoded model, engine, evaluator and CLI against the JAX
package, at a small size (path [1,2,2,2,3,2], F=4, B=5, 7 classes), on the
CPU, with the same numpy inputs and weights.

Tolerances: cells fp32 |Δ| ≤ 1e-4·max(1, max|ref|); whole-model fp32
per-exit logits |Δ| ≤ 1e-3·max|ref| (the golden-test tolerance); bf16: the
port's relative error vs the JAX fp32 oracle ≤ 2x the JAX bf16 path's own
error plus 1e-3; engine exit indices exact, confidences |Δ| ≤ 1e-4.
"""
import ast
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auto_dynamic_deeplab_torch
from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.cli import evaluate as pt_cli
from auto_dynamic_deeplab_torch.data import DataLoader as PtLoader
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation as PtSynthetic
from auto_dynamic_deeplab_torch.data import make_data_loader as pt_make_data_loader
from auto_dynamic_deeplab_torch.runtime import resolve_device
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine as PtEngine
from auto_dynamic_deeplab_torch.train.evaluator import Evaluation as PtEvaluation
from auto_dynamic_deeplab_torch.utils.metrics import Evaluator as PtEvaluator
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.data import DataLoader as JxLoader
from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation as JxSynthetic
from auto_dynamic_deeplab_tpu.models.cell import FixedCell as JxCell
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.train.dynamic import DynamicInferenceEngine as JxEngine
from auto_dynamic_deeplab_tpu.train.evaluator import Evaluation as JxEvaluation
from auto_dynamic_deeplab_tpu.utils.metrics import Evaluator as JxEvaluator

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

# B=5 blocks: edges 0-1, 2-4, 5-8, 9-13, 14-19. Pools, skip and none on
# some edges, rows deliberately not sorted by edge (the op-to-edge quirk).
RANDOM_GENOTYPE = [
    [1, 1], [0, 3], [2, 0], [4, 2], [6, 4], [8, 6], [9, 3], [12, 1], [19, 2], [15, 7],
]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ cells


# (genotype, downup, s1 hw, s0 spec, dense_out); s0 spec is an int (the
# channels of a plain s0) or a list of (channels, hw) dense taps
CELL_CASES = {
    "shipped-reduce": (AUTODEEPLAB_GENOTYPE, -1, (18, 22), 5, False),
    "shipped-same-dense-out": (AUTODEEPLAB_GENOTYPE, 0, (9, 11), 5, True),
    "shipped-up-dense-in-out": (AUTODEEPLAB_GENOTYPE, 1, (5, 6), [(4, (9, 11)), (4, (5, 6))], True),
    "random-same": (RANDOM_GENOTYPE, 0, (9, 11), 5, False),
    "random-up-dense-in": (RANDOM_GENOTYPE, 1, (5, 6), [(4, (9, 11)), (8, (17, 21))], False),
    "random-reduce-dense-out": (RANDOM_GENOTYPE, -1, (17, 21), 6, True),
}


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_fixed_cell(case):
    genotype, downup, s1_hw, s0_spec, dense_out = CELL_CASES[case]
    C_out, c_prev = 4, 8
    s1 = _x((1, *s1_hw, c_prev), seed=1)
    if isinstance(s0_spec, list):
        s0 = [_x((1, *hw, c), seed=2 + i) for i, (c, hw) in enumerate(s0_spec)]
        s0_jx = [jx(t) for t in s0]
        s0_pt = [nchw(t) for t in s0]
        kw_jx = dict(dense_in=True, num_dense_in=len(s0))
        kw_pt = dict(dense_in_channels=[c for c, _ in s0_spec])
    else:
        s0 = _x((1, 9, 11, s0_spec), seed=2)
        s0_jx, s0_pt = jx(s0), nchw(s0)
        kw_jx, kw_pt = {}, dict(C_prev_prev=s0_spec)
    rows = tuple((int(e), int(o)) for e, o in genotype)
    jm = JxCell(genotype=rows, B=5, C_out=C_out, downup_sample=downup,
                dense_out=dense_out, **kw_jx)
    v = flax_variables(jm, s0_jx, jx(s1), False)
    ref = jm.apply(v, s0_jx, jx(s1), False)
    pm = port_module(
        pt_models.FixedCell(genotype, 5, C_out, downup, c_prev, dense_out=dense_out, **kw_pt), v
    )
    out = pm(s0_pt, nchw(s1))
    assert len(out) == len(ref) == (3 if dense_out else 2)
    for o, r in zip(out, ref):
        assert_close_fp32_module(nhwc_np(o), r)


def test_edge_op_assignment_quirk():
    rows = pt_models.as_genotype_rows(AUTODEEPLAB_GENOTYPE)
    # rows [19,7],[18,5]: op 7 lands on edge 18, op 5 on edge 19
    assert pt_models.edge_op_assignment(rows)[-2:] == ((18, 7), (19, 5))


# ------------------------------------------------------------ whole model


def _jx_add(dtype=None, path=PATH, c_index=C_INDEX, ctor="ADD"):
    return getattr(jx_models, ctor)(path, c_index, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, dtype=dtype)


def _pt_add(variables, dtype=None, path=PATH, c_index=C_INDEX, ctor="ADD"):
    return port_module(
        getattr(pt_models, ctor)(path, c_index, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, dtype=dtype),
        variables,
    )


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX ADD, its seeded variables, the port model and an input."""
    jm = _jx_add()
    x = _x((1, *HW, 3), seed=4)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=5)
    return jm, v, _pt_add(v), x


def _jx_forward(jm, v, x):
    """One compiled program: cheaper on the CPU than op-by-op dispatch."""
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jx(x))


@pytest.fixture(scope="module")
def tiny_ref(tiny):
    jm, v, _, x = tiny
    return _jx_forward(jm, v, x)


@pytest.mark.parametrize("class_leading", [False, True])
def test_add_per_exit_logits_fp32(tiny, tiny_ref, class_leading):
    _, _, pm, x = tiny
    outs = pm(torch.from_numpy(x), class_leading=class_leading)
    assert len(outs) == len(tiny_ref) == 2
    for o, r in zip(outs, tiny_ref):
        o = o.permute(0, 2, 3, 1) if class_leading else o
        assert_close_fp32_model(o.numpy(), r)


def test_add_per_exit_logits_bf16(tiny, tiny_ref):
    _, v, _, x = tiny
    ref16 = _jx_forward(_jx_add(jnp.bfloat16), v, x)
    outs = _pt_add(v, torch.bfloat16)(torch.from_numpy(x))
    for o, r16, r32 in zip(outs, ref16, tiny_ref):
        assert o.dtype == torch.bfloat16  # eval logits cast as ops/heads.py:63-64
        assert_bf16_within_jax(o.float().numpy(), np.asarray(r16, np.float32), r32)


def _cell_outputs_jax(jm, v, x):
    """{cell index: its output tuple} from one compiled forward."""
    _, state = jax.jit(lambda v, x: jm.apply(
        v, x, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, name: isinstance(m, JxCell) and name == "__call__",
    ))(v, jx(x))
    cells = state["intermediates"]
    return {int(k[5:]): cells[k]["__call__"][0] for k in cells if k.startswith("cell_")}


def _cell_outputs_port(pm, x):
    outs = {}
    hooks = [getattr(pm, f"cell_{i}").register_forward_hook(
        lambda m, a, o, i=i: outs.setdefault(i, o)) for i in range(len(pm.network_arch))]
    try:
        pm(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return outs


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_add_per_cell_outputs(tiny, dtype):
    """Every cell's outputs of the tiny ADD along one forward, under the
    file's fp32 and bf16 policies: where a bf16 departure starts. The bf16
    exit fault came from the resizes of the last two cells (cell 4 resizes
    its dense taps, cell 5 upsamples from level 3 to 2): the port rounded
    them once, JAX after each axis (``test_resize_bilinear_bf16_rounds_as_jax``
    in tests/test_torch_ops.py). Max relative errors, port against JAX
    bf16's: cell 4 0.0136 / 0.0080 before the repair, 0.0087 after; the
    final exit 0.0247 / 0.0102 before, 0.0147 after."""
    jm, v, pm, x = tiny
    refs32 = _cell_outputs_jax(jm, v, x)
    if dtype == "bf16":
        refs = _cell_outputs_jax(_jx_add(jnp.bfloat16), v, x)
        outs = _cell_outputs_port(_pt_add(v, torch.bfloat16), x)
    else:
        refs, outs = refs32, _cell_outputs_port(pm, x)
    assert sorted(outs) == sorted(refs) == list(range(len(PATH)))
    for i in outs:
        assert len(outs[i]) == len(refs[i]) == len(refs32[i])
        for o, r, r32 in zip(outs[i], refs[i], refs32[i]):
            if dtype == "bf16":
                assert_bf16_within_jax(nhwc_np(o), np.asarray(r, np.float32), r32)
            else:
                assert_close_fp32_module(nhwc_np(o), r)


@pytest.fixture(scope="module")
def three_exits():
    """C=3: a level-0 exit (DoubleFactorizedReduce adapter), a level-3 exit
    (upsample + 1x1 adapter) and the final one; the path also takes every
    cell downup_sample (-1, 0, +1). The JAX ADD, its seeded variables, the
    port model and an input."""
    path, c_index = [0, 1, 2, 3, 2, 2], [0, 3]
    jm = _jx_add(path=path, c_index=c_index)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=7)
    return jm, v, _pt_add(v, path=path, c_index=c_index), _x((1, *HW, 3), seed=6)


def test_three_exits_fp32(three_exits):
    jm, v, pm, x = three_exits
    refs = _jx_forward(jm, v, x)
    outs = pm(torch.from_numpy(x))
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        assert_close_fp32_model(o.numpy(), r)


@pytest.mark.parametrize("ctor", ["BaselineModel", "AutoDeepLab"])
def test_other_constructors_take_jax_variables(ctor):
    """The non-dense constructors name every parameter as the JAX package
    does (the bridge raises otherwise) and give the JAX module's logits at
    every exit."""
    path = [0, 1, 2, 3, 2, 1]
    args = (path, [2]) if ctor == "BaselineModel" else (path,)
    jm = getattr(jx_models, ctor)(*args, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=9)
    pm = port_module(getattr(pt_models, ctor)(*args, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v)
    x = _x((1, *HW, 3))
    outs, refs = pm(torch.from_numpy(x)), _jx_forward(jm, v, x)
    assert len(outs) == len(refs) == len(jm.exit_layers) == len(pm.exit_layers)
    for o, r in zip(outs, refs):
        assert o.shape == (1, *HW, NCLS) and torch.isfinite(o).all()
        assert_close_fp32_model(o.numpy(), r)


def test_get_feature(tiny, tiny_ref):
    _, _, pm, x = tiny
    logits, feat = pm.get_feature(torch.from_numpy(x))
    assert_close_fp32_model(logits.numpy(), tiny_ref[0])
    # exit 1 sits at level 2 (stride 16): 33x65 -> 3x5
    assert feat.shape == (1, pm.feature_channels(pm.exit_layers[0]), 3, 5)


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines(tiny):
    jm, v, pm, x = tiny
    c_feat = pm.feature_channels(pm.exit_layers[0])
    jedm = jx_models.EDM()
    ev = flax_variables(jedm, jnp.zeros((1, 9, 17, c_feat)), seed=8)
    pedm = port_module(pt_models.EDM(c_feat), ev)
    return (
        JxEngine(jm, v, edm=jedm, edm_variables=ev, num_classes=NCLS),
        PtEngine(pm, edm=pedm, num_classes=NCLS, device="cpu"),
    )


# (confidence, threshold that exits at the first exit, one that does not)
@pytest.mark.parametrize("exits", [True, False])
@pytest.mark.parametrize("confidence,thr_exit,thr_stay", [
    ("edm", 1e9, -1e9), ("entropy", 2.0, -1.0), ("max", 0.3, 0.99),
])
def test_engine_matches_jax(tiny, engines, confidence, thr_exit, thr_stay, exits):
    x = tiny[3]
    jeng, peng = engines
    thr = thr_exit if exits else thr_stay
    if confidence != "max":
        # the threshold does not enter the JAX edm/entropy decide programs
        # (only the host-side comparison): reuse a compiled one, saving a
        # compile per threshold on the CPU
        for key, prog in list(jeng._programs.items()):
            if key[0] == "decide" and key[3] == confidence:
                jeng._programs.setdefault(key[:4] + (thr,), prog)
    l_r, k_r, _, c_r = jeng.infer(jx(x), threshold=thr, confidence=confidence)
    logits, k, dt, c = peng.infer(torch.from_numpy(x), threshold=thr, confidence=confidence)
    assert k == k_r == (0 if exits else 1)
    assert abs(c - c_r) <= 1e-4 and dt > 0
    assert logits.shape == (1, NCLS, *HW)  # engine logits are (N, C, H, W)
    assert_close_fp32_model(logits.numpy(), l_r)


# the 3-exit model's input: entropy 0.258 at exit 0, 0.079 at exit 1
@pytest.mark.parametrize("thr,want_exit", [(2.0, 0), (0.2, 1), (-1.0, 2)])
def test_engine_matches_jax_at_three_exits(three_exits, thr, want_exit):
    jm, v, pm, x = three_exits
    jeng = _three_exit_engines(three_exits)
    # reuse the compiled entropy decide programs (the threshold enters them
    # only through the host-side comparison)
    for key, prog in list(jeng._programs.items()):
        if key[0] == "decide":
            jeng._programs.setdefault(key[:4] + (thr,), prog)
    l_r, k_r, _, c_r = jeng.infer(jx(x), threshold=thr, confidence="entropy")
    logits, k, _, c = PtEngine(pm, num_classes=NCLS, device="cpu").infer(
        torch.from_numpy(x), threshold=thr, confidence="entropy"
    )
    assert k == k_r == want_exit
    assert abs(c - c_r) <= 1e-4
    assert_close_fp32_model(logits.numpy(), l_r)


_JX_ENGINES = {}


def _three_exit_engines(three_exits):
    """One JAX engine for the 3-exit model, so that its compiled programs
    serve every case."""
    if "three" not in _JX_ENGINES:
        jm, v, _, _ = three_exits
        _JX_ENGINES["three"] = JxEngine(jm, v, num_classes=NCLS)
    return _JX_ENGINES["three"]


# -------------------------------------------------------------- evaluator


def test_validate_matches_jax(tiny):
    jm, v, pm, _ = tiny
    ref = JxEvaluation(jm, v, NCLS).validate(
        JxLoader(JxSynthetic(2, HW, NCLS), 2, shuffle=False, drop_last=False, num_workers=1)
    )
    out = PtEvaluation(pm, NCLS, device="cpu").validate(
        PtLoader(PtSynthetic(2, HW, NCLS), 2, shuffle=False, drop_last=False, num_workers=1)
    )
    np.testing.assert_allclose(out["miou"], ref["miou"], atol=1e-3)
    np.testing.assert_allclose(out["pixel_acc"], ref["pixel_acc"], atol=1e-3)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-5)


def test_metrics_match_jax():
    rng = np.random.RandomState(3)
    gt = rng.randint(0, NCLS, (2, 9, 11))
    gt[0, :2] = 255  # ignored pixels
    pred = rng.randint(0, NCLS - 1, (2, 9, 11))  # one class never predicted
    ref, out = JxEvaluator(NCLS), PtEvaluator(NCLS)
    for _ in range(2):
        ref.add_batch(gt, pred)
        out.add_batch(gt, torch.from_numpy(pred))
    np.testing.assert_array_equal(out.confusion_matrix.numpy(), np.asarray(ref.confusion_matrix))
    assert out.Mean_Intersection_over_Union() == pytest.approx(ref.Mean_Intersection_over_Union())
    assert out.Pixel_Accuracy() == pytest.approx(ref.Pixel_Accuracy())


@pytest.mark.parametrize("index", [0, 3])
def test_synthetic_data_copy_matches_jax(index):
    ref = JxSynthetic(4, (17, 23), NCLS, seed=1)[index]
    out = PtSynthetic(4, (17, 23), NCLS, seed=1)[index]
    np.testing.assert_array_equal(out["image"], ref["image"])
    np.testing.assert_array_equal(out["label"], ref["label"])


def test_dynamic_inference_confidence_matches_jax_fused_at_three_exits(three_exits):
    """The JAX evaluator's default (fused) program reports each image's
    first decision's confidence; the port's evaluator reports the same.
    Entropies of the loader's images at exits 0 and 1: (0.237, 0.077) and
    (0.219, 0.088); at threshold 0.228 the first exits at exit 1, where
    the first and the last decision differ, the second at exit 0."""
    jm, v, pm, _ = three_exits

    def loader(synthetic, data_loader):
        return data_loader(synthetic(2, HW, NCLS), 2, shuffle=False, drop_last=False, num_workers=1)

    kw = dict(threshold=0.228, confidence="entropy")
    ref = JxEvaluation(jm, v, NCLS).dynamic_inference(loader(JxSynthetic, JxLoader), **kw)
    out = PtEvaluation(pm, NCLS, device="cpu").dynamic_inference(loader(PtSynthetic, PtLoader), **kw)
    assert out["exit_histogram"] == ref["exit_histogram"] == [1, 1, 0]
    assert abs(out["avg_confidence"] - ref["avg_confidence"]) <= 1e-4
    assert out["miou"] == pytest.approx(ref["miou"], abs=1e-6)
    assert out["n_images"] == ref["n_images"] == 2


# -------------------------------------------------------------------- CLI


_CLI = ["--device", "cpu", "--F", "4", "--synthetic-crop", "33", "65",
        "--synthetic-length", "8", "--workers", "1"]


@pytest.mark.parametrize("extra", [[], ["--dynamic", "--confidence", "entropy", "--threshold", "0.5"],
                                   ["--dynamic"]])
def test_cli_evaluate_cpu(extra, capsys):
    stats = pt_cli.main(_CLI + extra)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["device"] == "cpu"
    if "--dynamic" in extra:
        assert stats["n_images"] == 8 and sum(stats["exit_histogram"]) == 8
        assert 0.0 <= stats["miou"] <= 1.0 and stats["mean_latency_s"] > 0
    else:
        assert len(stats["miou"]) == 2 and all(0.0 <= m <= 1.0 for m in stats["miou"])


def test_cli_rejects_unported_dataset(tmp_path):
    """A dataset the loader factory does not know raises; a known file
    dataset on a root without its frames raises FileNotFoundError, as the
    JAX package's datasets do."""
    with pytest.raises(NotImplementedError, match="ade20k"):
        pt_make_data_loader("ade20k", 1)
    for dataset in ("cityscapes", "pascal"):
        with pytest.raises(FileNotFoundError):
            pt_make_data_loader(dataset, 1, root=str(tmp_path / "missing"))


def test_cuda_default_raises_without_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PtEvaluation(tiny[2], NCLS)  # the Python APIs default to cuda too
    with pytest.raises(RuntimeError, match="cuda"):
        pt_cli.main(["--F", "4"])  # the CLI's default device is cuda


# ----------------------------------------------------------------- bridge


def test_bridge_raises_on_unused_missing_and_misshaped(tiny):
    _, v, _, _ = tiny
    fresh = lambda: pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)  # noqa: E731
    extra = {"params": {**v["params"], "bogus": {"kernel": np.zeros(3)}}, "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="bogus"):
        load_jax_variables(fresh(), extra)
    short = {"params": {k: p for k, p in v["params"].items() if k != "aspp"},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="aspp"):
        load_jax_variables(fresh(), short)
    wrong = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS + 1, F=F, B=5)
    with pytest.raises(ValueError, match="classifier"):
        load_jax_variables(wrong, v)


# -------------------------------------------------------------- isolation


def test_port_imports_no_jax():
    pkg = pathlib.Path(auto_dynamic_deeplab_torch.__file__).parent
    forbidden = ("jax", "flax", "msgpack", "auto_dynamic_deeplab_tpu")
    for src in [*pkg.rglob("*.py"), pkg.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(src.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in forbidden, (src, name)
    # every module that needs no GPU toolchain imports cleanly without jax
    code = (
        "import importlib, pkgutil, sys\n"
        "import auto_dynamic_deeplab_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('_triton'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'auto_dynamic_deeplab_tpu')]\n"
        "assert not bad, bad\n"
        "new = ['train.loss', 'train.schedules', 'train.step', 'train.trainer', 'train.edm_trainer',\n"
        "       'utils.saver', 'utils.summaries', 'data.utils', 'cli.train', 'cli.train_edm']\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in new)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=pkg.parent, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
