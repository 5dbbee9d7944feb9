"""The port's training path against the JAX package's, on the CPU, at the
tiny ADD of tests/test_torch_model.py (path [1,2,2,2,3,2], exit at cell 1,
F=4, B=5, 7 classes, 33x65, batch 2), from the same numpy-seeded weights
and inputs; then the trainer, its checkpoints and the CLIs on the port
alone.

Tolerances: training BN fp32 output |Δ| ≤ 1e-5·max(1, max|ref|) (JAX takes
the variance as E[x²] − E[x]², PyTorch another way; 2e-4 at n = 1, where
JAX's x − mean is one rounding off 0 and scaled by rsqrt(eps)), running statistics
≤ 1e-5 relative; bf16 output within one bf16 unit (2^-7 relative) of the
JAX bf16 output. Loss ≤ 1e-6 relative, schedules ≤ 1e-6 of the base lr
(JAX computes them in fp32). Three train steps: see
``test_three_train_steps_match_jax`` (the first step's loss ≤ 1e-5
relative; the gradients held to the port's float64 run). One bf16 step's
loss: the port's relative error against the JAX fp32 loss ≤ 2x the JAX
bf16 loss's own plus 1e-3. remat: gradients ≤ 1e-6 relative, running
statistics equal.
Validation after the steps: per-exit mIoU and pixel accuracy |Δ| ≤ 1e-3,
confidence ≤ 1e-5 (flat against xla, and xla against JAX). Resuming on the
CPU is bitwise.
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.cli import evaluate as pt_cli_eval
from auto_dynamic_deeplab_torch.cli import train as pt_cli_train
from auto_dynamic_deeplab_torch.cli import train_edm as pt_cli_train_edm
from auto_dynamic_deeplab_torch.data import DataLoader as PtLoader
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation as PtSynthetic
from auto_dynamic_deeplab_torch.data import calculate_class_weights as pt_class_weights
from auto_dynamic_deeplab_torch.data import decode_segmap as pt_decode_segmap
from auto_dynamic_deeplab_torch.ops.norm import BatchNorm as PtBatchNorm
from auto_dynamic_deeplab_torch.train import loss as pt_loss
from auto_dynamic_deeplab_torch.train.evaluator import Evaluation as PtEvaluation
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule as pt_lr_schedule
from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer
from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer
from auto_dynamic_deeplab_torch.utils.initialize import init_params
from auto_dynamic_deeplab_torch.utils.saver import find_latest_checkpoint
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.data import DataLoader as JxLoader
from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation as JxSynthetic
from auto_dynamic_deeplab_tpu.data.utils import calculate_class_weights as jx_class_weights
from auto_dynamic_deeplab_tpu.data.utils import decode_segmap as jx_decode_segmap
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.ops.norm import BatchNorm as JxBatchNorm
from auto_dynamic_deeplab_tpu.train import loss as jx_loss
from auto_dynamic_deeplab_tpu.train.evaluator import Evaluation as JxEvaluation
from auto_dynamic_deeplab_tpu.train.schedules import lr_schedule as jx_lr_schedule
from auto_dynamic_deeplab_tpu.train.step import (
    TrainState,
    make_optimizer as jx_make_optimizer,
    make_single_device_train_step,
)

from torch_port_helpers import flax_variables, nchw, rel_err

PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)
LR, STEPS = 0.02, 3


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_close(out, ref, tol, what=""):
    """|Δ| ≤ tol·max(1, max|ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = float(np.abs(out - ref).max()), tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, (what, err, bound)


# ------------------------------------------------------------ training BN


@pytest.mark.parametrize("shape", [(2, 5, 7, 6), (1, 1, 1, 6)], ids=["n70", "n1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(shape, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _x(shape, seed=1) * 2.0 + 0.5
    c = shape[-1]
    rng = np.random.RandomState(2)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, c).astype(np.float32), "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jm = JxBatchNorm(dtype=jdt)
    ref, mutated = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x, jdt), True,
                            mutable=["batch_stats"])
    bn = load_jax_variables(PtBatchNorm(c, dtype=tdt), {"params": params, "batch_stats": stats}).train()
    v0 = (bn.mean._version, bn.var._version)
    out = bn(nchw(x).to(tdt))
    assert out.dtype == tdt
    out = np.transpose(out.float().detach().numpy(), (0, 2, 3, 1))
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        # at n = 1 the variance is 0 and x − mean, 0 here but one rounding
        # off it in JAX, is scaled by rsqrt(eps) = 316
        _assert_close(out, ref, 1e-5 if shape[0] > 1 else 2e-4, "y")
    else:  # both round the fp32 result once
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=1e-6)
    for k in ("mean", "var"):
        want = np.asarray(mutated["batch_stats"][k])
        assert rel_err(getattr(bn, k).numpy(), want) <= 1e-5, k
    # the kernels' folded-weight caches key on the buffers' versions
    assert bn.mean._version > v0[0] and bn.var._version > v0[1]
    bn.eval()
    before = bn.mean.clone()
    bn(nchw(x).to(tdt))
    assert torch.equal(bn.mean, before)  # eval mode reads the statistics only


# ------------------------------------------------------------------ loss


def _loss_case(seed=3, shape=(2, 5, 4, 6)):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape).astype(np.float32) * 3.0
    n, c, h, w = shape
    target = rng.randint(0, c, (n, h, w)).astype(np.int32)
    target[0, 0, :3] = 255
    target[1, 1, 0], target[1, 1, 1], target[1, 2, 2] = -1, c, 300  # outside [0, C)
    weight = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return logits, target, weight


@pytest.mark.parametrize("case", ["unweighted", "weighted", "all_ignored", "sum", "weighted_sum"])
def test_loss_matches_jax(case):
    logits, target, weight = _loss_case()
    if case == "all_ignored":
        target = np.where(target % 2 == 0, 255, -3).astype(np.int32)
    w = weight if "weighted" in case else None
    reduce = "sum" if "sum" in case else "mean"
    logits2 = logits[:, ::-1].copy()  # a second exit
    ref = jx_loss.multi_exit_cross_entropy(
        [jnp.asarray(logits), jnp.asarray(logits2)], jnp.asarray(target),
        None if w is None else jnp.asarray(w), reduce=reduce, channel_axis=1,
    )
    out = pt_loss.multi_exit_cross_entropy(
        [torch.from_numpy(logits), torch.from_numpy(logits2)], torch.from_numpy(target),
        None if w is None else torch.from_numpy(w), reduce=reduce,
    )
    ref = float(ref)
    if case == "all_ignored":
        assert ref == 0.0 and out.item() == 0.0
    else:
        assert abs(out.item() - ref) <= 1e-6 * abs(ref), (out.item(), ref)
    with pytest.raises(NotImplementedError):
        pt_loss.multi_exit_cross_entropy([torch.from_numpy(logits)], torch.from_numpy(target), reduce="max")


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_segmentation_losses_match_jax(weighted):
    """``SegmentationLosses(weight).build_loss("ce")`` on (N, C, H, W)
    logits against the JAX package's on the same logits channels last,
    with ignored pixels (255 and outside [0, C)), |Δ| ≤ 1e-6 relative;
    another mode raises, as JAX's does."""
    logits, target, weight = _loss_case()
    w = weight if weighted else None
    ref = float(jx_loss.SegmentationLosses(w).build_loss("ce")(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                                                                 jnp.asarray(target)))
    crit = pt_loss.SegmentationLosses(w).build_loss("ce")
    assert crit.ignore_index == 255
    out = crit(torch.from_numpy(logits), torch.from_numpy(target)).item()
    assert abs(out - ref) <= 1e-6 * abs(ref), (out, ref)
    for losses in (pt_loss.SegmentationLosses(w), jx_loss.SegmentationLosses(w)):
        with pytest.raises(NotImplementedError):
            losses.build_loss("focal")


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("mode,kw", [
    ("poly", {}), ("poly", {"warmup_epochs": 1, "min_lr": 1e-3}),
    ("cos", {"min_lr": 1e-3}), ("cos", {"min_lr": 1e-4, "warmup_epochs": 2}),
    ("step", {"lr_step": 2}), ("step", {"lr_step": 1, "min_lr": 2e-3, "warmup_epochs": 1}),
], ids=str)
def test_schedule_matches_jax(mode, kw):
    args = (mode, 0.05, 5, 7)
    ref, out = jx_lr_schedule(*args, **kw), pt_lr_schedule(*args, **kw)
    for step in range(0, 5 * 7 + 3):
        want = float(ref(step))  # fp32 in JAX: 1 + cos(πT/N) cancels near the end
        assert abs(out(step) - want) <= 1e-6 * 0.05, (step, out(step), want)


# --------------------------------------------------------- train steps


def _jx_add(dtype=None):
    return jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, dtype=dtype)


def _pt_add(variables, **kw):
    return load_jax_variables(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, **kw), variables)


def _batch(n=2, seed=0):
    items = [PtSynthetic(n, HW, NCLS, seed=seed)[i] for i in range(n)]
    return np.stack([s["image"] for s in items]), np.stack([s["label"] for s in items])


def _schedules():
    args = ("poly", LR, 1, STEPS + 1)
    return jx_lr_schedule(*args), pt_lr_schedule(*args)


@contextlib.contextmanager
def _float64_kept():
    """``Tensor.float()`` leaves float64 tensors float64 (the loss and the
    decoder's classifier cast to fp32), so that the port runs in float64."""
    to_fp32 = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else to_fp32(t)
    try:
        yield
    finally:
        torch.Tensor.float = to_fp32


def _port_steps(v, image, label, float64=False):
    """The port's three steps: (model, losses, lrs, step, the first
    step's gradients, the state after the first step)."""
    pm = _pt_add(v)
    if float64:
        pm = pm.double()
        pm.decoder.classifier.dtype = None
        image = image.astype(np.float64)
    ts = TrainStep(pm, make_optimizer(pm.parameters()), _schedules()[1])
    losses, lrs = [], []
    with _float64_kept() if float64 else contextlib.nullcontext():
        for _ in range(STEPS):
            losses.append(ts(torch.from_numpy(image), torch.from_numpy(label)).item())
            lrs.append(ts.optimizer.param_groups[0]["lr"])
            if len(losses) == 1:
                grads = {k: p.grad.double().clone() for k, p in pm.named_parameters()}
                first = {k: t.double().clone() for k, t in pm.state_dict().items()}
    return {"model": pm, "losses": losses, "lrs": lrs, "step": ts, "grads": grads, "first": first}


def _flat(tree) -> dict:
    return {k: torch.from_numpy(np.asarray(a, np.float64)) for k, a in
            _pt_add(tree).state_dict().items()}


@pytest.fixture(scope="module")
def trained():
    """Three steps of the JAX single-device step (fp32) and of the port's,
    in fp32 and in float64, on one batch, from the same weights."""
    jm = _jx_add()
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=5)
    image, label = _batch()
    tx = jx_make_optimizer(_schedules()[0])
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                       opt_state=tx.init(params))
    step = make_single_device_train_step(jm, tx, class_leading=True)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    jlosses = []
    for k in range(STEPS):
        state, m = step(state, batch)
        jlosses.append(float(m["loss"]))
        if k == 0:
            jfirst = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}
    # the first update is p1 = p0 - lr(0) (1 + momentum) (g + wd p0): its gradient
    p0, p1 = _flat(v), _flat(jfirst)
    lr0 = float(_schedules()[0](0))
    jgrads = {k: (p0[k] - p1[k]) / (lr0 * 1.9) - 4e-5 * p0[k] for k in _pt_add(v).state_dict()
              if k in dict(_pt_add(v).named_parameters())}
    return {
        "variables": v, "jax_state": state, "jax_losses": jlosses, "jax_first": p1, "jax_grads": jgrads,
        "jax_model": _pt_add({"params": jax.device_get(state.params),
                              "batch_stats": jax.device_get(state.batch_stats)}),
        "port": _port_steps(v, image, label), "port64": _port_steps(v, image, label, float64=True),
    }


def _l2_rel(a: dict, ref: dict) -> float:
    num = sum(float(((a[k].double() - ref[k]) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


def _max_err(a: dict, ref: dict) -> float:
    """max over tensors of |Δ| / max(1, max|ref|)."""
    return max(float((a[k].double() - ref[k]).abs().max()) / max(1.0, float(ref[k].abs().max())) for k in ref)


def test_three_train_steps_match_jax(trained):
    """Same weights, batch and schedule. The first step's loss, the update
    rule and the learning rates agree tightly. The gradient of this tiny
    batch-2 model is ill-conditioned in fp32: in the ASPP image-pool
    branch the BN normalizes each channel over the two images (n = 2), and
    where the two pooled values lie within sqrt(eps) of each other the
    branch's output swings with their difference, which JAX's E[x²] − E[x]²
    variance loses to cancellation. So the gradients are held to the
    port's own float64 run (the exact one): the port's fp32 gradient is
    within 5e-3 of it (L2, relative) and closer than JAX's fp32 gradient,
    and the two fp32 gradients within 5e-2 of each other; the parameters
    and BN statistics after the first step |Δ| ≤ 1e-3·max(1, max|ref|) per
    tensor from float64 and ≤ 2e-2 from JAX. Steps 2 and 3 then follow
    that sharp landscape: their losses ≤ 5e-2 relative."""
    port, port64 = trained["port"], trained["port64"]
    jlosses, state = trained["jax_losses"], trained["jax_state"]
    assert port["step"].step == int(state.step) == STEPS
    assert abs(port["losses"][0] - jlosses[0]) <= 1e-5 * jlosses[0]
    assert abs(port["losses"][0] - port64["losses"][0]) <= 1e-5 * port64["losses"][0]
    # update k used lr(k), counting from 0, as optax does
    np.testing.assert_allclose(port["lrs"], [float(_schedules()[0](k)) for k in range(STEPS)], rtol=1e-6)
    exact = port64["grads"]
    port_err, jax_err = _l2_rel(port["grads"], exact), _l2_rel(trained["jax_grads"], exact)
    assert port_err <= 5e-3 and port_err < jax_err, (port_err, jax_err)
    assert _l2_rel(port["grads"], trained["jax_grads"]) <= 5e-2
    # parameters and BN statistics after the first step
    assert _max_err(port["first"], port64["first"]) <= 1e-3
    assert _max_err(port["first"], trained["jax_first"]) <= 2e-2
    for k in range(1, STEPS):
        assert abs(port["losses"][k] - jlosses[k]) <= 5e-2 * jlosses[k], (k, port["losses"], jlosses)
    initial = _pt_add(trained["variables"]).state_dict()
    out_state = port["model"].state_dict()
    assert all(not torch.equal(out_state[k], initial[k]) for k in ("stems.stem0_conv.kernel", "stems.stem0_bn.var"))


def test_optimizer_is_the_optax_chain():
    """SGD(momentum 0.9, nesterov, weight decay 4e-5) = optax's
    add_decayed_weights + sgd(nesterov), over steps of changing lr."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(4)]
    sched = lambda k: 0.1 / (1 + k)  # noqa: E731
    tx = jx_make_optimizer(sched)
    jp, opt = jnp.asarray(p0), None
    opt = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    sgd = make_optimizer([p])
    for k, g in enumerate(grads):
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        sgd.param_groups[0]["lr"] = sched(k)
        p.grad = torch.from_numpy(g)
        sgd.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_bf16_step_loss_matches_jax(trained):
    v, jlosses = trained["variables"], trained["jax_losses"]
    image, label = _batch()

    def loss(model):
        def f(v, x, y):
            outs, _ = model.apply(v, x, train=True, mutable=["batch_stats"], class_leading=True)
            return jx_loss.multi_exit_cross_entropy(outs, y, channel_axis=1)
        return float(jax.jit(f)(v, jnp.asarray(image), jnp.asarray(label)))

    ref16 = loss(_jx_add(jnp.bfloat16))
    pm = _pt_add(v, dtype=torch.bfloat16)
    ts = TrainStep(pm, make_optimizer(pm.parameters()), _schedules()[1])
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    out = ts(torch.from_numpy(image), torch.from_numpy(label)).item()
    jax_err = abs(ref16 - jlosses[0]) / jlosses[0]
    assert abs(out - jlosses[0]) / jlosses[0] <= 2 * jax_err + 1e-3, (out, ref16, jlosses[0])
    after = pm.state_dict()
    for k, t in after.items():  # fp32 parameters and statistics, updated and finite
        assert t.dtype == torch.float32 and torch.isfinite(t).all(), k
    assert not torch.equal(after["stems.stem0_conv.kernel"], before["stems.stem0_conv.kernel"])
    assert not torch.equal(after["stems.stem0_bn.mean"], before["stems.stem0_bn.mean"])


def test_remat_gives_the_same_gradients(trained):
    v = trained["variables"]
    image, label = (torch.from_numpy(a) for a in _batch())
    grads, stats = [], []
    for remat in (False, True):
        pm = _pt_add(v, remat=remat).train()
        loss = pt_loss.multi_exit_cross_entropy(pm(image, class_leading=True), label)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
        stats.append({k: b.clone() for k, b in pm.named_buffers()})
    for k, g in grads[0].items():
        assert rel_err(grads[1][k].numpy(), g.numpy()) <= 1e-6, k
    for k, b in stats[0].items():  # the recomputation left the statistics alone
        assert torch.equal(stats[1][k], b), k


def test_flat_cells_refuse_training():
    pm = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, flat_eval=True).train()
    with pytest.raises(RuntimeError, match="eval-mode BN"):
        pm(torch.zeros(1, *HW, 3))


def test_validate_after_training_matches_jax(trained):
    """JAX ``Evaluation.validate`` on the JAX-updated variables against the
    port's on the same weights, with xla cells and with flat cells (a model
    that validated before the new weights were copied in, so its
    folded-weight caches must refresh)."""
    state, trained_model = trained["jax_state"], trained["jax_model"]

    def loader(synthetic, data_loader):
        return data_loader(synthetic(2, HW, NCLS, seed=1), 2, shuffle=False, drop_last=False, num_workers=1)

    ref = JxEvaluation(_jx_add(), state.variables(), NCLS).validate(loader(JxSynthetic, JxLoader))
    xla = PtEvaluation(trained_model, NCLS, device="cpu").validate(loader(PtSynthetic, PtLoader))
    flat_model = _pt_add(trained["variables"], flat_eval=True)
    flat_eval = PtEvaluation(flat_model, NCLS, device="cpu")
    untrained = flat_eval.validate(loader(PtSynthetic, PtLoader))
    flat_model.load_state_dict(trained_model.state_dict())
    flat = flat_eval.validate(loader(PtSynthetic, PtLoader))
    assert untrained["confidence"] != flat["confidence"]
    for out in (xla, flat):
        np.testing.assert_allclose(out["miou"], ref["miou"], atol=1e-3)
        np.testing.assert_allclose(out["pixel_acc"], ref["pixel_acc"], atol=1e-3)
        np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-5)


def test_folded_weights_follow_a_train_step(trained):
    """The flat cells' folded-weight cache (kernels/cell_ops.py), filled by
    a validation, is rebuilt after a train step updates the parameters and
    the BN statistics in place: flat validation then equals xla."""
    pm = _pt_add(trained["variables"])
    cells = [m for m in pm.modules() if isinstance(m, pt_models.FixedCell)]
    val = PtLoader(PtSynthetic(2, HW, NCLS, seed=1), 2, shuffle=False, drop_last=False, num_workers=1)
    evaluation = PtEvaluation(pm, NCLS, device="cpu")

    def validate(flat):
        for c in cells:
            c.flat_eval = flat
        return evaluation.validate(val)

    before = validate(True)
    validate(False)
    ts = TrainStep(pm, make_optimizer(pm.parameters()), _schedules()[1])
    ts(*(torch.from_numpy(a) for a in _batch()))
    flat, xla = validate(True), validate(False)
    assert flat["confidence"] != before["confidence"]
    np.testing.assert_allclose(flat["miou"], xla["miou"], atol=1e-3)
    np.testing.assert_allclose(flat["confidence"], xla["confidence"], atol=1e-5)


def test_class_weights_and_segmap_copies_match_jax():
    ds = JxSynthetic(3, (17, 23), NCLS)
    np.testing.assert_array_equal(pt_class_weights(PtSynthetic(3, (17, 23), NCLS), NCLS),
                                  jx_class_weights(ds, NCLS))
    label = np.array([[0, 3, 18], [19, 255, -1]])
    for dataset in ("cityscapes", "pascal"):
        np.testing.assert_array_equal(pt_decode_segmap(label, dataset), jx_decode_segmap(label, dataset))


# -------------------------------------------------------------- trainer


def _trainer(run_dir, epochs=2, **cfg):
    g = torch.Generator().manual_seed(0)
    model = init_params(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), g)
    train = PtLoader(PtSynthetic(4, HW, NCLS), 2, num_workers=1)
    val = PtLoader(PtSynthetic(2, HW, NCLS, seed=1), 2, shuffle=False, drop_last=False, num_workers=1)
    config = TrainConfig(epochs=epochs, lr=0.01, eval_interval=1, run_dir=str(run_dir), **cfg)
    return Trainer(model, train, val, config, device="cpu")


def test_trainer_files_and_resume_is_bitwise(tmp_path):
    straight = _trainer(tmp_path / "a")
    result = straight.fit()
    assert len(result["miou"]) == 2 and np.isfinite(result["train_loss"]) and len(result["step_ms"]) == 2

    first = _trainer(tmp_path / "b")
    first.fit(1)
    exp0 = tmp_path / "b" / "synthetic" / "add" / "experiment_0"
    for name in ("parameters.txt", "scalars.jsonl", "checkpoint", "checkpoint.meta.json",
                 "best_pred.txt", "best_model"):
        assert (exp0 / name).exists(), name
    meta = json.loads((exp0 / "checkpoint.meta.json").read_text())
    assert meta["epoch"] == 0 and meta["best_pred"] == pytest.approx(float(np.mean(
        [json.loads(line)["value"] for line in (exp0 / "scalars.jsonl").read_text().splitlines()
         if json.loads(line)["tag"].startswith("val/mIoU")])))
    assert "lr: 0.01" in (exp0 / "parameters.txt").read_text()
    assert find_latest_checkpoint(str(tmp_path / "b"), "synthetic", "add") == str(exp0 / "checkpoint")

    resumed = _trainer(tmp_path / "b", resume="auto")
    assert resumed.start_epoch == 1 and resumed.train_step.step == 2
    assert resumed.saver.experiment_dir.endswith("experiment_1")
    resumed.fit()
    for name, want in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], want), name
    assert resumed.train_step.step == straight.train_step.step == 4
    assert os.path.exists(os.path.join(resumed.saver.experiment_dir, "checkpoint"))


def test_trainer_ft_restarts_the_schedule(tmp_path):
    first = _trainer(tmp_path, epochs=1)
    first.fit()
    ckpt = find_latest_checkpoint(str(tmp_path), "synthetic", "add")
    ft = _trainer(tmp_path, epochs=1, resume=os.path.dirname(ckpt), ft=True)
    assert ft.start_epoch == 0 and ft.train_step.step == 0 and not ft.train_step.optimizer.state
    for name, want in first.model.state_dict().items():
        assert torch.equal(ft.model.state_dict()[name], want), name
    cold = _trainer(tmp_path / "cold", epochs=1, resume="auto")  # nothing committed: a cold start
    assert cold.start_epoch == 0 and cold.train_step.step == 0


# ------------------------------------------------------------------ CLIs


_CLI = ["--device", "cpu", "--F", "4", "--synthetic-crop", "33", "65", "--workers", "1"]


def test_cli_train_edm_evaluate_end_to_end(tmp_path, capsys):
    run = ["--run-dir", str(tmp_path)]
    result = pt_cli_train.main(_CLI + run + ["--synthetic-length", "4", "--batch-size", "2",
                                             "--epochs", "1", "--eval-interval", "1"])
    exp = result["experiment_dir"]
    assert exp.endswith(os.path.join("ADD_C2_F4", "experiment_0"))
    loss = pt_cli_train_edm.main(_CLI + run + ["--synthetic-length", "3", "--resume", exp, "--epochs", "2"])
    assert np.isfinite(loss)
    edm_exp = str(tmp_path / "synthetic" / "edm_C2" / "experiment_0")
    assert os.path.exists(os.path.join(edm_exp, "edm"))
    ev = ["--synthetic-length", "8", "--resume", exp]
    static = pt_cli_eval.main(_CLI + ev)
    assert static["miou"] == result["miou"]  # the checkpoint round trip: the trainer's own validation
    dyn = pt_cli_eval.main(_CLI + ev + ["--dynamic", "--confidence", "edm", "--edm-resume", edm_exp])
    assert dyn["n_images"] == 8 and sum(dyn["exit_histogram"]) == 8 and np.isfinite(dyn["avg_confidence"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed[-1]["device"] == "cpu"


@pytest.mark.parametrize("flag", ["--sync-bn"])
def test_cli_train_rejects_unported_flags(flag, tmp_path):
    """--sync-bn reduces BN statistics over a process group's ranks: with
    no group (or with --no-data-parallel) there is nothing to reduce over,
    and it raises rather than train with per-process BN
    (tests/test_torch_parallel.py runs it under torchrun)."""
    for extra in ([], ["--no-data-parallel"]):
        with pytest.raises(ValueError, match="needs a process group"):
            pt_cli_train.main(_CLI + [flag, "--run-dir", str(tmp_path)] + extra)


def test_training_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path is not reachable")
    for main in (pt_cli_train.main, pt_cli_train_edm.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--F", "4", "--run-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5),
                PtLoader(PtSynthetic(2, HW, NCLS), 2), None, TrainConfig(run_dir=str(tmp_path)))
