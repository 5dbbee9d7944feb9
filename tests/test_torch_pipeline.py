"""The port's pipelined early-exit inference (``parallel/pipeline.py``) on
the CPU: two stages on ``cpu`` against the port's own segment loop
(``DynamicInferenceEngine.infer``) bitwise, each stage holding only the
modules of its segments, and against the JAX package's
``PipelinedDynamicInference`` over two virtual CPU devices (recorded in
tests/torch_parallel_ref.npz by scripts/torch_record_parallel_ref.py);
then ``Evaluation.dynamic_inference(pipeline_devices=...)`` and
``cli.evaluate --pipeline-devices``.

Sizes: the tiny ADD of tests/test_torch_dynamic.py (path [1,2,2,2,3,2],
exit at cell 1, F=4, B=5, 7 classes, 33x65) with its EDM, and the 3-exit
variant (exits at cells 0 and 3). Tolerances against JAX, as in
tests/test_torch_dynamic.py: exit indices exact, confidences |Δ| ≤ 1e-4,
logits |Δ| ≤ 1e-3·max|ref|.
"""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.cli import evaluate as pt_cli_eval
from auto_dynamic_deeplab_torch.data import DataLoader, SyntheticSegmentation
from auto_dynamic_deeplab_torch.parallel import PipelinedDynamicInference
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine
from auto_dynamic_deeplab_torch.train.evaluator import Evaluation
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE

from torch_port_helpers import assert_close_fp32_model, flax_variables, port_module

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_ref.npz")
PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)
THREE_PATH, THREE_C_INDEX = [0, 1, 2, 3, 2, 2], [0, 3]
# (confidence, threshold, exit) of the 2-exit model: each signal exits at exit 0, and runs to the end
CASES = [("entropy", 2.0, 0), ("entropy", -1.0, 1), ("max", -1.0, 0), ("max", 2.0, 1),
         ("edm", 1e9, 0), ("edm", -1e9, 1)]


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def two_exits():
    """The port's tiny 2-exit ADD and EDM from the recording's seeds, the
    JAX variables' and input's SHA-256 checked against it."""
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=5)
    pm = port_module(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v)
    c_feat = pm.feature_channels(pm.exit_layers[0])
    ev = flax_variables(jx_models.EDM(), jnp.zeros((1, 9, 17, c_feat)), seed=8)
    pedm = port_module(pt_models.EDM(c_feat), ev)
    x = _x((1, *HW, 3), seed=4)
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in
                                     [x, *[a for _, a in _leaves(v)], *[a for _, a in _leaves(ev)]])).hexdigest()
    with np.load(REF_PATH) as z:
        recorded = {k: z[k] for k in z.files if k.startswith("pipeline/")}
    assert digest == str(recorded["pipeline/sha256"])
    return pm, pedm, x, recorded


def _modules(stage) -> set:
    return set(stage["engine"].model._modules)


@pytest.mark.parametrize("confidence,thr,want_exit", CASES)
def test_pipeline_matches_the_segment_loop_bitwise(two_exits, confidence, thr, want_exit):
    pm, pedm, x, _ = two_exits
    engine = DynamicInferenceEngine(pm, edm=pedm, num_classes=NCLS, device="cpu")
    pipe = PipelinedDynamicInference(pm, HW, ["cpu", "cpu"], confidence, thr, edm=pedm, num_classes=NCLS)
    pipe.warmup()
    logits, k, conf = pipe.infer(torch.from_numpy(x))
    ref, k_ref, _, conf_ref = engine.infer(torch.from_numpy(x), thr, confidence)
    assert k == k_ref == want_exit and conf == conf_ref
    assert torch.equal(logits, ref)


def test_each_stage_holds_only_its_segments_modules(two_exits):
    """Stage 0 runs stem + cells 0-1 + exit 0's decision, stage 1 cells 2-5
    + the final head: each holds those modules (and the shared head it
    decodes) and nothing else; only the deciding stage has the EDM."""
    pm, pedm, _, _ = two_exits
    pipe = PipelinedDynamicInference(pm, HW, ["cpu", "cpu"], "edm", 0.5, edm=pedm, num_classes=NCLS)
    s0, s1 = pipe.stages
    assert [p for p, _ in s0["programs"]] == ["decide"] and [p for p, _ in s1["programs"]] == ["final"]
    head = {"aspp", "decoder"} | ({"conv_aspp_1"} if "conv_aspp_1" in pm._modules else set())
    assert _modules(s0) == {"stems", "cell_0", "cell_1", "low_level_conv"} | head
    assert _modules(s1) == {"cell_2", "cell_3", "cell_4", "cell_5", "aspp", "decoder"}
    assert not any(n.startswith(("stems.", "cell_0.", "cell_1.", "low_level_conv."))
                   for n, _ in s1["engine"].model.named_parameters())
    assert s0["engine"].edm is not None and s1["engine"].edm is None
    # copies: the pipeline shares no tensor with the model it was built from
    ptrs = {t.data_ptr() for t in list(pm.parameters()) + list(pm.buffers())}
    assert not any(t.data_ptr() in ptrs for st in pipe.stages for t in st["engine"].model.parameters())
    # the deep stage cannot run a segment it does not hold
    with pytest.raises(AttributeError, match="stems"):
        s1["engine"].model.stem_state(torch.zeros(1, *HW, 3))


@pytest.mark.parametrize("thr,want_exit", [(2.0, 0), (0.2, 1), (-1.0, 2)])
def test_three_exit_pipeline_matches_the_segment_loop(thr, want_exit):
    """Three segments over two stages: the first stage takes two."""
    jm = jx_models.ADD(THREE_PATH, THREE_C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    pm = port_module(pt_models.ADD(THREE_PATH, THREE_C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5),
                     flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=7))
    x = torch.from_numpy(_x((1, *HW, 3), seed=6))
    pipe = PipelinedDynamicInference(pm, HW, ["cpu", "cpu"], "entropy", thr, num_classes=NCLS)
    assert [len(st["programs"]) for st in pipe.stages] == [2, 1]
    logits, k, conf = pipe.infer(x)
    ref, k_ref, _, conf_ref = DynamicInferenceEngine(pm, num_classes=NCLS, device="cpu").infer(x, thr, "entropy")
    assert k == k_ref == want_exit and conf == conf_ref and torch.equal(logits, ref)


@pytest.mark.parametrize("confidence,thr", [("entropy", 2.0), ("entropy", -1.0), ("edm", 1e9), ("max", 2.0)])
def test_pipeline_matches_jax_pipeline(two_exits, confidence, thr):
    pm, pedm, x, recorded = two_exits
    key = f"pipeline/{confidence}/{thr:g}"
    pipe = PipelinedDynamicInference(pm, HW, ["cpu", "cpu"], confidence, thr, edm=pedm, num_classes=NCLS)
    logits, k, conf = pipe.infer(torch.from_numpy(x))
    assert k == int(recorded[f"{key}/exit"])
    want_conf = float(recorded[f"{key}/confidence"])
    assert (np.isnan(conf) and np.isnan(want_conf)) or abs(conf - want_conf) <= 1e-4
    assert_close_fp32_model(logits.numpy(), recorded[f"{key}/logits"])


def test_evaluation_pipelined_matches_the_segment_loop(two_exits):
    """``dynamic_inference(pipeline_devices=2)`` on the CPU: the same
    exits, mIoU and confidences as the segment loop."""
    pm, _, _, _ = two_exits
    evaluation = Evaluation(pm, NCLS, device="cpu")
    loader = DataLoader(SyntheticSegmentation(4, HW, NCLS, seed=2), 2, shuffle=False, drop_last=False)
    piped = evaluation.dynamic_inference(loader, threshold=0.2, confidence="entropy", pipeline_devices=2)
    loop = evaluation.dynamic_inference(loader, threshold=0.2, confidence="entropy", fused=False)
    for k in ("miou", "early_exit_rate", "avg_confidence", "exit_histogram", "n_images"):
        assert piped[k] == loop[k], k
    assert 0 < piped["early_exit_rate"] < 1


def test_evaluation_refuses_more_pipeline_devices_than_gpus(two_exits, monkeypatch):
    """On CUDA, two stages need two GPUs: with one it raises (the JAX
    evaluator raises too) rather than pipeline over fewer."""
    pm, _, _, _ = two_exits
    evaluation = Evaluation(pm, NCLS, device="cpu")
    monkeypatch.setattr(evaluation, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    loader = DataLoader(SyntheticSegmentation(1, HW, NCLS), 1, shuffle=False)
    with pytest.raises(RuntimeError, match="pipeline_devices=2 requested but only 1 GPUs"):
        evaluation.dynamic_inference(loader, confidence="entropy", pipeline_devices=2)


def test_cli_evaluate_pipeline_devices_on_cpu(capsys):
    argv = ["--device", "cpu", "--F", "4", "--synthetic-crop", "33", "65", "--synthetic-length", "8",
            "--dynamic", "--confidence", "entropy", "--threshold", "0.5"]
    piped = pt_cli_eval.main(argv + ["--pipeline-devices", "2"])
    plain = pt_cli_eval.main(argv)
    assert piped["n_images"] == 8 and piped["exit_histogram"] == plain["exit_histogram"]
    assert piped["miou"] == plain["miou"]
