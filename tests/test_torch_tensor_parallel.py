"""The port's channel tensor parallelism (``parallel.tensor``) against the
JAX package's GSPMD step and against the port's single-device step, on
the CPU: four gloo ranks (``tests/torch_sharded_ranks.py``) as a
(data 2, model 2) mesh run one ``make_tp_train_step`` step of the model
and optimizer of tests/test_tensor_parallel.py (the tiny ADD, path
[1,2,2,2,3,2], exit at cell 1, F=2, B=5, 19 classes, low-level layer 0;
SGD with Nesterov momentum, ``lr_schedule("poly", 0.05, 10, 4)``, weight
decay 4e-5) on a global batch of 4 at 17x17. The labels put 255 on most
of the first data shard's pixels and a few of the second's, so that the
global batch's loss and the mean of the shards' losses differ by far more
than the loss bound.

Bounds (tests/test_tensor_parallel.py's: any real split re-associates
fp32 sums and flips a few ReLU / max-pool selections at near-ties, so
parameters are held by distribution): the loss within 2e-4 relative of
JAX's TP step and of the port's single-device step; against the latter,
under 5% of parameter elements more than 2e-3 apart and none 0.05 apart,
BN statistics within rtol 1e-2, atol 1e-4 (against JAX's too); the
update's seeded sketches within 5e-2 (L2, relative) of JAX's. The JAX
side is recorded in tests/torch_sharded_ref.npz by
scripts/torch_record_sharded_ref.py.
"""
import copy
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.parallel import channel_spec, make_tp_train_step
from auto_dynamic_deeplab_torch.train.loss import multi_exit_cross_entropy
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer
from auto_dynamic_deeplab_tpu.models import ADD as JxADD
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE

from torch_port_helpers import flax_variables, run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
REF_PATH = os.path.join(TESTS, "torch_sharded_ref.npz")
PATH, C_INDEX, HW, N, SEED, SKETCH = [1, 2, 2, 2, 3, 2], [1], (17, 17), 4, 23, 8


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _inputs():
    """scripts/torch_record_sharded_ref.py's batch and variables."""
    jm = JxADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5, low_level_layer=0, axis_name=None)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=SEED)
    rng = np.random.RandomState(SEED)
    x = rng.randn(N, *HW, 3).astype(np.float32)
    y = rng.randint(0, 19, size=(N, *HW)).astype(np.int32)
    y[: N // 2, : HW[0] * 3 // 4] = 255
    y[N // 2:, :2, :3] = 255
    model = load_jax_variables(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5), v)
    return x, y, v, model


def _tree(rec, prefix) -> dict:
    data, out, at = rec[f"{prefix}:data"], {}, 0
    for path, shape in json.loads(str(rec[f"{prefix}:index"])):
        n = int(np.prod(shape))
        out[path.replace("/", ".")] = data[at:at + n].reshape(shape).astype(np.float64)
        at += n
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results, the single-device step's, the inputs and
    the JAX recording."""
    with np.load(REF_PATH) as z:
        rec = {k: z[k] for k in z.files}
    x, y, v, model = _inputs()
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                     for a in [x, y, *[a for _, a in _leaves(v)]])).hexdigest()
    assert digest == str(rec["tp/sha256"])
    p0 = {k: t.detach().clone() for k, t in model.state_dict().items()}
    tmp = tmp_path_factory.mktemp("tp")
    image, label = torch.from_numpy(x), torch.from_numpy(y).long()
    torch.save({"state": p0, "image": image, "label": label}, tmp / "spec.pt")
    run_ranks(4, [os.path.join(TESTS, "torch_sharded_ranks.py"), "tp", str(tmp / "spec.pt"),
                  str(tmp / "out{rank}.pt")], REPO)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(4)]
    single = copy.deepcopy(model)
    loss = TrainStep(single, make_optimizer(single.parameters(), weight_decay=4e-5),
                     lr_schedule("poly", 0.05, 10, 4))(image, label).item()
    return {"outs": outs, "rec": rec, "p0": p0, "model": model, "image": image, "label": label,
            "single": {"loss": loss, "state": single.state_dict()}}


def test_channel_spec_rules():
    """tests/test_tensor_parallel.py's rules in the port's layouts: a conv
    weight (out, in, kh, kw) and a depthwise one shard their out dim, as
    flax's trailing dim; the 19-class classifier and scalars stay whole."""
    assert channel_spec(np.zeros((16, 8, 3, 3)), 2) == 0
    assert channel_spec(torch.zeros(16, 1, 5, 5), 2) == 0
    assert channel_spec(np.zeros((19,)), 2) is None
    assert channel_spec(torch.zeros(19, 256, 1, 1), 2) is None
    assert channel_spec(np.zeros(()), 2) is None
    assert channel_spec(np.zeros((2,)), 4) is None


def test_tp_loss_is_the_global_batch_loss(run):
    """Every rank's loss within 2e-4 of JAX's TP step and of the port's
    single-device step; the mean of the data shards' losses is far from
    it (so the test would catch a per-rank mean)."""
    want_jax, want_single = float(run["rec"]["tp/loss"]), run["single"]["loss"]
    for out in run["outs"]:
        assert abs(out["loss"] - want_jax) <= 2e-4 * abs(want_jax), (out["loss"], want_jax)
        assert abs(out["loss"] - want_single) <= 2e-4 * abs(want_single), (out["loss"], want_single)
    model = copy.deepcopy(run["model"]).train()
    with torch.no_grad():
        shard_losses = [multi_exit_cross_entropy(model(run["image"][s], class_leading=True), run["label"][s]).item()
                        for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(shard_losses) - want_jax) > 100 * 2e-4 * abs(want_jax), (shard_losses, want_jax)


def test_tp_step_matches_single_device_step(run):
    """Parameters by distribution, BN statistics elementwise, against the
    single-device step; every rank ends with the same whole state."""
    ref = run["single"]["state"]
    names = [k for k, _ in run["model"].named_parameters()]
    for out in run["outs"]:
        got = out["state"]["model"]
        assert set(got) == set(ref)
        pa = np.concatenate([ref[k].numpy().ravel() for k in names])
        pb = np.concatenate([got[k].numpy().ravel() for k in names])
        diff = np.abs(pa - pb)
        assert float(np.mean(diff > 2e-3)) < 0.05
        assert float(diff.max()) < 0.05, float(diff.max())
        for k in ref:
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-2, atol=1e-4, err_msg=k)
        first = run["outs"][0]["state"]["model"]
        assert all(torch.equal(got[k], first[k]) for k in got)


def test_tp_step_matches_jax(run):
    """BN statistics against JAX's TP step (rtol 1e-2, atol 1e-4) and the
    update's seeded sketches within 5e-2 (L2, relative)."""
    stats = _tree(run["rec"], "tp/stats")
    names = json.loads(str(run["rec"]["tp/update_names"]))
    for out in run["outs"]:
        got = out["state"]["model"]
        for k, want in stats.items():
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-2, atol=1e-4, err_msg=k)
        sketches = []
        for t, name in enumerate(names):
            d = got[name].double().numpy() - run["p0"][name].double().numpy()
            sketches.append(np.random.RandomState(2000 + t).standard_normal((SKETCH, d.size)) @ d.ravel())
        want = run["rec"]["tp/update_sketch"]
        assert np.linalg.norm(np.stack(sketches) - want) <= 5e-2 * np.linalg.norm(want)


def test_tp_state_is_sharded_and_gathers_back_bitwise(run):
    """More than 10 parameters are blocks after the step, every rank sits
    at its (d, m), and the state gathered right after sharding is the
    original, bitwise."""
    assert sorted(out["mesh"] for out in run["outs"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for out in run["outs"]:
        assert out["round_trip_bitwise"]
        assert out["sharded_params"] == out["sharded_after"] > 10
        assert set(out["state"]["momentum"]) == {k for k, _ in run["model"].named_parameters()}


def test_tp_refuses_a_mesh_or_batch_that_does_not_fit(run):
    for out in run["outs"]:
        assert "a (3, 2) mesh needs 6 ranks, the group has 4" in out["errors"]["make_mesh"]
        assert "does not split over the 2-rank data mesh" in out["errors"]["batch"]


def test_tp_step_needs_a_sharded_model():
    model = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5)
    with pytest.raises(ValueError, match="shard_train_state"):
        make_tp_train_step(model, make_optimizer(model.parameters()), lambda _: 0.1, object())
