"""The port's NAS search (stage 1) against the JAX package's, on the CPU:
the three supernets at 65x65, 4 layers, F=2, B=2, 5 classes, batch 4,
from the same numpy-seeded weights, BN statistics and arch
(``torch_port_helpers.flax_variables``); then the search trainer and the
two CLIs on the port alone.

Tolerances: logits |Δ| ≤ 1e-3·max|ref| (fp32, the golden-test tolerance);
bf16 logits by ``assert_bf16_within_jax``; the BN running statistics a
training forward or a step leaves ≤ 1e-4 relative per tensor;
``normalize_betas`` and its gradient ≤ 1e-6. The steps (JAX
``make_search_steps`` on ModelNetSearch and on the mixed ModelSearch;
the mixed cell's gradients are also held at one cell,
``test_mixed_cell_gradients_match_jax``): losses ≤ 1e-5 relative, weight
and arch gradients ≤ 1e-4 (L2, relative). JAX's gradient is read off its
own step program run with a probing optimizer whose update is the
(decayed) gradient itself (SGD at lr 1e3; Adam with eps and -lr 1e6, so
that m̂ / (sqrt(v̂) + eps) ≈ g / eps). The real optimizers' updates are
then applied to each side's gradient: the weights after the step |Δ| ≤
1e-6·max(1, max|ref|); the arch after Adam's first step, which is nearly
-lr·sign(g), |Δ| ≤ 1e-6 on the components whose decayed gradient exceeds
1e-2 of the tensor's largest (below that a component's sign is fp32 noise
and may flip, moving it by 2·lr).

The JAX side of the supernets' forwards and steps is recorded in
tests/torch_search_ref.npz by scripts/torch_record_search_ref.py (the
JAX package on the CPU: its step programs take minutes of XLA
compilation, the mixed supernet's most), with the variables it ran on
and the hashes of its inputs; regenerate it with
``JAX_PLATFORMS=cpu python scripts/torch_record_search_ref.py``. The
mixed supernet's step is JAX's in float64: its fp32 program parts from
its own float64 run by 7.1e-4 / 8.3e-4 (weight / arch gradient, L2),
where the port's fp32 step is within 3.3e-6 of it
(scripts/torch_search_conditioning.py).
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import _to_torch_layout, load_jax_variables
from auto_dynamic_deeplab_torch.cli import search as pt_cli_search
from auto_dynamic_deeplab_torch.cli import search_layer as pt_cli_search_layer
from auto_dynamic_deeplab_torch.data import DataLoader as PtLoader
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation as PtSynthetic
from auto_dynamic_deeplab_torch.data import make_data_loader as pt_make_data_loader
from auto_dynamic_deeplab_torch.nas.decode import normalize_betas as normalize_betas_np
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule as pt_lr_schedule
from auto_dynamic_deeplab_torch.train.search_trainer import SearchConfig, SearchTrainer
from auto_dynamic_deeplab_torch.train.step import SearchSteps, make_arch_optimizer, make_optimizer
from auto_dynamic_deeplab_torch.utils.initialize import init_params
from auto_dynamic_deeplab_torch.utils.saver import find_latest_checkpoint, restore_checkpoint
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.models.supernet_cell import MixedOp as JxMixedOp
from auto_dynamic_deeplab_tpu.models.supernet_cell import TrellisCell as JxTrellisCell
from auto_dynamic_deeplab_tpu.train.schedules import lr_schedule as jx_lr_schedule
from auto_dynamic_deeplab_tpu.train.step import make_arch_optimizer as jx_make_arch_optimizer

from test_supernet import _bank_cell_tree, _scan_cell_tree
from torch_port_helpers import assert_bf16_within_jax, assert_close_fp32_model, flax_variables, nchw, rel_err

HW, N, NCLS = (65, 65), 4, 5
# a B=2 cell: rows in genotype order land on the sorted edges 0, 1, 2, 4 as
# dil_conv_3x3, skip_connect, sep_conv_5x5, max_pool_3x3 (the op-to-edge quirk)
G2 = ((1, 6), (0, 3), (4, 5), (2, 1))
WD, ARCH_WD, LR, ARCH_LR = 8e-4, 1e-3, 0.05, 1e-3
KINDS = ("mixed", "net", "baseline")


def _supernet(lib, kind, **kw):
    common = dict(num_layers=4, F=2, B=2, **kw)
    if kind == "mixed":
        return lib.ModelSearch(NCLS, exit_layer=2, **common)
    if kind == "net":
        return lib.ModelNetSearch(NCLS, G2, C_index=(2,), **common)
    return lib.ModelBaselinePathSearch(NCLS, G2, exit_layer=2, **common)


def _batch(n=N, seed=0):
    items = [PtSynthetic(n, HW, NCLS, seed=seed)[i] for i in range(n)]
    return np.stack([s["image"] for s in items]), np.stack([s["label"] for s in items])


def _flat(tree, prefix=""):
    """A flax tree as {port name: float64 array in the port's layout}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = _to_torch_layout(prefix + k, np.asarray(v, np.float64))
    return out


def _port(variables, kind, **kw):
    return load_jax_variables(_supernet(pt_models, kind, **kw), variables)


REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_search_ref.npz")


@pytest.fixture(scope="module")
def recorded():
    """The JAX package's answers, recorded by scripts/torch_record_search_ref.py."""
    with np.load(REF_PATH) as z:
        return {k: z[k] for k in z.files}


def _tree(rec: dict, prefix: str) -> dict:
    """The nested dict recorded under ``prefix`` (one float32 vector and
    the JSON index of its leaves)."""
    data, out, at = rec[f"{prefix}:data"], {}, 0
    for path, shape in json.loads(str(rec[f"{prefix}:index"])):
        n = int(np.prod(shape))
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = data[at:at + n].reshape(shape)
        at += n
    assert at == data.size
    return out


def _list(rec: dict, prefix: str) -> list:
    return [rec[f"{prefix}/{i}"] for i in range(sum(k.startswith(prefix + "/") for k in rec))]


def _recorded_batch(rec: dict, seed: int):
    """The port's synthetic batch of ``seed``, which the recording ran on."""
    image, label = _batch(seed=seed)
    assert hashlib.sha256(image.tobytes() + label.tobytes()).hexdigest() == str(rec[f"batch{seed}/sha256"])
    return image, label


@pytest.fixture(scope="module")
def ref(recorded):
    """Per kind: the variables, and the eval and training logits (with the
    statistics training leaves) of the JAX model on one batch."""

    def get(kind):
        variables = {c: _tree(recorded, f"{kind}/variables/{c}") for c in ("params", "batch_stats", "arch")}
        return {"variables": variables, "image": _recorded_batch(recorded, 0)[0],
                "eval": _list(recorded, f"{kind}/eval"), "train": _list(recorded, f"{kind}/train"),
                "stats": _flat(_tree(recorded, f"{kind}/stats"))}

    return get


def _assert_stats(model, stats):
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(stats)
    for k, want in stats.items():
        assert rel_err(buffers[k].numpy(), want) <= 1e-4, k


def _logits(model, image, train):
    model.train(train)
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(image))]


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", KINDS)
def test_supernet_forward_matches_jax(ref, kind, train):
    """Every exit's logits; in training the running statistics each BN
    blended (a cell's ops once per branch, in the order down, same, up)."""
    r = ref(kind)
    model = _port(r["variables"], kind)
    outs = _logits(model, r["image"], train)
    want = r["train" if train else "eval"]
    assert len(outs) == len(want) == 2
    for out, w in zip(outs, want):
        assert_close_fp32_model(out, w)
    if train:
        _assert_stats(model, r["stats"])


def _garbage_pad_lanes(tree, scan=False):
    """Every (B, B+2, ...) leaf under a ``blocks`` scope, with 7 added to
    the lanes past each block's 2 + b edges."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _garbage_pad_lanes(v, scan or k == "blocks")
        elif scan:
            a = np.array(v)
            for b in range(a.shape[0]):
                a[b, 2 + b:] += 7.0
            out[k] = a
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("mode", ["banked", "scan"])
def test_bridge_takes_banked_and_scan_layouts(ref, mode):
    """The JAX package's other mixed-cell layouts (the per-edge variables
    stacked per block, as its own test_mixed_exec_supernet_matches_edges
    builds them and holds them to its init's layout; scan's padding lanes
    filled with garbage here) load into the per-edge port and give the
    per-edge JAX logits, train and eval."""
    r = ref("mixed")
    v = r["variables"]

    def convert(tree):
        banked = _bank_cell_tree(jax.tree.map(jnp.asarray, tree), 2)
        return banked if mode == "banked" else _scan_cell_tree(banked, 2)

    vb = {"arch": v["arch"], "params": convert(v["params"]), "batch_stats": convert(v["batch_stats"])}
    if mode == "scan":  # lanes 2 + b.. of block b carry zero mixing weight: their values must not matter
        vb["params"], vb["batch_stats"] = _garbage_pad_lanes(vb["params"]), _garbage_pad_lanes(vb["batch_stats"])
    image = r["image"]
    model = _port(vb, "mixed")
    edges = _port(v, "mixed")
    for train in (False, True):
        outs = _logits(model, image, train)
        for out, want, same in zip(outs, r["train" if train else "eval"], _logits(edges, image, train)):
            np.testing.assert_array_equal(out, same)
            assert_close_fp32_model(out, want)
    # a layout whose lanes do not fit its block is refused
    bad = jax.tree.map(np.asarray, vb)
    cell = bad["params"]["l0_c0"]
    if mode == "banked":  # block 1 with 2 lanes, not 3
        leaf = cell["bank_1"]["ops_4"]["dw1"]
        leaf["kernel"] = leaf["kernel"][:-1]
    else:  # 3 lanes a block, not B + 2
        leaf = cell["blocks"]["bank"]["ops_4"]["dw1"]
        leaf["kernel"] = leaf["kernel"][:, :-1]
    with pytest.raises(ValueError, match="lanes"):
        _port(bad, "mixed")


def test_bf16_forward_within_jax(ref, recorded):
    """ModelNetSearch under the bf16 policy, eval mode, every exit."""
    r = ref("net")
    ref16 = _list(recorded, "net/bf16_eval")
    outs = _logits(_port(r["variables"], "net", dtype=torch.bfloat16), r["image"], False)
    for out, j16, j32 in zip(outs, ref16, r["eval"]):
        assert out.dtype == np.float32
        assert_bf16_within_jax(out, np.asarray(j16, np.float32), j32)


def test_input_dims_must_be_64k_plus_1():
    model = _supernet(pt_models, "net")
    with pytest.raises(ValueError, match=r"\(d-1\) % 64"):
        model(torch.zeros(1, 64, 65, 3))


# ---------------------------------------------------- betas and MixedOp


def test_normalize_betas_and_its_gradient():
    betas = np.random.RandomState(4).randn(6, 4, 3).astype(np.float32)
    w = np.random.RandomState(5).randn(6, 4, 3).astype(np.float32)
    jfun = lambda b: jnp.sum(jx_models.normalize_betas(b) * w)  # noqa: E731
    want, want_grad = np.asarray(jx_models.normalize_betas(jnp.asarray(betas))), np.asarray(jax.grad(jfun)(jnp.asarray(betas)))
    b = torch.from_numpy(betas).requires_grad_()
    out = pt_models.normalize_betas(b)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), want_grad, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), normalize_betas_np(betas), rtol=1e-6, atol=1e-6)
    assert b.grad[0, 0, 0] == 0 and b.grad[0, 1:].abs().max() == 0  # invalid transitions


@pytest.mark.parametrize("case", ["train", "argmax", "tie", "none"])
def test_mixed_op_matches_jax(case):
    """Training mixes the seven primitives (pools with their BN); eval runs
    only the argmax op: a tie takes the first maximum (jnp.argmax and
    torch.argmax both do), an argmax of ``none`` gives exact zeros."""
    rng = np.random.RandomState(3)
    C = 4
    x = rng.randn(2, 9, 9, C).astype(np.float32)
    w = {"train": rng.randn(8), "argmax": rng.randn(8), "tie": np.array([0.1, 0.2, 0.9, 0.3, 0.0, 0.9, 0.2, 0.1]),
         "none": np.array([3.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7])}[case]
    weights = np.asarray(jax.nn.softmax(jnp.asarray(w, jnp.float32)))
    jm = JxMixedOp(C=C)
    v = flax_variables(jm, jnp.zeros((1, 9, 9, C)), jnp.asarray(weights), True, seed=6)
    train = case == "train"
    out = jm.apply(v, jnp.asarray(x), jnp.asarray(weights), train, mutable=["batch_stats"] if train else False)
    ref, upd = out if train else (out, None)
    op = load_jax_variables(pt_models.MixedOp(C), v).train(train)
    with torch.no_grad():
        got = op(nchw(x), torch.from_numpy(weights))
    got = np.transpose(got.numpy(), (0, 2, 3, 1))
    if case == "none":
        assert not got.any() and not np.asarray(ref).any()
        return
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    if train:
        _assert_stats(op, _flat(jax.device_get(upd["batch_stats"])))
    else:  # exactly the argmax op's own output
        k = int(np.argmax(weights))
        assert case != "tie" or k == 2
        with torch.no_grad():
            alone = op._op(k, nchw(x))
        np.testing.assert_array_equal(got, np.transpose(alone.numpy(), (0, 2, 3, 1)))


def test_mixed_cell_gradients_match_jax():
    """One training-mode mixed cell with all three branches (its ops shared
    by them): the loss's gradient with respect to the softmaxed alphas and
    to the weights, and the statistics, against jax.grad."""
    rng = np.random.RandomState(9)
    B, C = 2, 2
    s0 = rng.randn(2, 9, 9, 3).astype(np.float32)
    down = rng.randn(2, 17, 17, B * C // 2).astype(np.float32)
    same = rng.randn(2, 9, 9, B * C).astype(np.float32)
    up = rng.randn(2, 5, 5, 2 * B * C).astype(np.float32)
    alphas = np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(5, 8), jnp.float32), axis=-1))
    probe = [rng.randn(2, 9, 9, B * C).astype(np.float32) for _ in range(3)]
    jc = JxTrellisCell(B=B, C_out=C, has_down=True, has_same=True, has_up=True)
    args = [jnp.asarray(a) for a in (s0, down, same, up)]
    v = flax_variables(jc, *args, jnp.asarray(alphas), True, seed=4)

    def loss(params, a):
        outs, upd = jc.apply({"params": params, "batch_stats": v["batch_stats"]}, *args, a, True,
                             mutable=["batch_stats"])
        return sum(jnp.sum(o * p) for o, p in zip(outs, probe)), upd

    (jl, upd), (jg_w, jg_a) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(alphas))
    cell = load_jax_variables(pt_models.TrellisCell(B, C, True, True, True, 3), v).train()
    a = torch.tensor(alphas, requires_grad=True)
    outs = cell(*(nchw(t) for t in (s0, down, same, up)), a)
    pl = sum((o * nchw(p)).sum() for o, p in zip(outs, probe))
    pl.backward()
    grads = {k: p.grad.detach() for k, p in cell.named_parameters()}
    assert abs(pl.item() - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    assert rel_err(a.grad.numpy(), np.asarray(jg_a)) <= 1e-4
    want = load_jax_variables(pt_models.TrellisCell(B, C, True, True, True, 3),
                              {"params": jax.device_get(jg_w), "batch_stats": v["batch_stats"]})
    num = sum(float(((grads[k] - p.detach()).double() ** 2).sum()) for k, p in want.named_parameters())
    den = sum(float((p.detach().double() ** 2).sum()) for _, p in want.named_parameters())
    assert (num / den) ** 0.5 <= 1e-4
    _assert_stats(cell, _flat(jax.device_get(upd["batch_stats"])))


# ----------------------------------------------------------------- steps


@pytest.fixture(scope="module")
def steps(ref, recorded):
    """Per kind: JAX ``make_search_steps`` from the shared variables, the
    weight step with the mean loss and the arch step with the summed loss,
    each run with a probing optimizer that exposes its (decayed)
    gradient: g' = (p0 - p1) / lr for SGD's first step at lr 1e3, g' =
    -(a1 - a0) for Adam with eps = lr = 1e6 (m̂ / (sqrt(v̂) + eps) = g' /
    (|g'| + 1e6)); then the real optax chain applied to the gradient g'
    less the decay (elementwise, so on all parameters as one vector)."""
    chains = {"weight": optax.chain(optax.add_decayed_weights(WD),
                                    optax.sgd(jx_lr_schedule("cos", LR, 1, 2, min_lr=0.003), momentum=0.9)),
              "arch": jx_make_arch_optimizer(ARCH_LR, ARCH_WD)}

    def get(kind):
        r = ref(kind)
        out = {"variables": r["variables"], "batch": _recorded_batch(recorded, 1)}
        for which, collection, decay in (("weight", "params", WD), ("arch", "arch", ARCH_WD)):
            p0 = _flat(r["variables"][collection])
            decayed = _flat(_tree(recorded, f"{kind}_step/{which}/decayed"))
            grads = {k: g - decay * p0[k] for k, g in decayed.items()}
            names = sorted(grads)
            tx = chains[which]
            flat_p = jnp.asarray(np.concatenate([p0[k].ravel() for k in names]), jnp.float32)
            flat_g = jnp.asarray(np.concatenate([grads[k].ravel() for k in names]), jnp.float32)
            new = np.asarray(jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
                flat_g, flat_p), np.float64)
            updated, at = {}, 0
            for k in names:
                updated[k] = new[at:at + p0[k].size].reshape(p0[k].shape)
                at += p0[k].size
            out[which] = {"loss": float(recorded[f"{kind}_step/{which}/loss"]),
                          "stats": _flat(_tree(recorded, f"{kind}_step/{which}/stats")),
                          "grads": grads, "decayed": decayed, "updated": updated}
        return out

    return get


def _l2_rel(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _check_search_step(s_all, kind, which, reduce):
    """One step of the port's ``SearchSteps`` (the real optimizers: SGD
    momentum 0.9 without Nesterov, the cos schedule's lr(0), decay 8e-4 on
    every weight, BN affine terms included; Adam with L2 1e-3) against
    JAX's: loss, gradient, the BN statistics the step blended, the
    parameters it updated (the real optax chain applied to JAX's
    gradient), and nothing else moved. Returns the gradient's L2 error,
    relative."""
    s = s_all[which]
    image, label = s_all["batch"]
    model = _port(s_all["variables"], kind)
    sched = pt_lr_schedule("cos", LR, 1, 2, min_lr=0.003)
    st = SearchSteps(model, make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=WD),
                     make_arch_optimizer(model.arch_parameters(), ARCH_LR, ARCH_WD), sched, loss_reduce=reduce)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    fn = st.weight_step if which == "weight" else st.arch_step
    loss = fn(torch.from_numpy(image), torch.from_numpy(label))
    assert loss.dim() == 0 and abs(loss.item() - s["loss"]) <= 1e-5 * s["loss"]
    params = dict(model.named_parameters())
    grads = {k: params[k].grad.double().numpy() for k in s["grads"]}
    grad_err = _l2_rel(grads, s["grads"])
    assert grad_err <= 1e-4
    # only this step's parameters have gradients; the others did not move
    other = [k for k in params if k not in s["grads"]]
    assert all(params[k].grad is None and torch.equal(params[k], before[k]) for k in other)
    _assert_stats(model, s["stats"])
    assert (st.step == 1) == (which == "weight")
    for k, w in s["updated"].items():
        got = params[k].detach().double().numpy()
        if which == "arch":  # Adam's first step: about -lr·sign(g'), noisy where g' is
            d = np.abs(s["decayed"][k])
            big = d > 1e-2 * d.max()
            assert big.sum() >= 8, k
            got, w = got[big], w[big]
        assert np.abs(got - w).max() <= 1e-6 * max(1.0, float(np.abs(w).max())), k
    return grad_err


@pytest.mark.parametrize("which,reduce", [("weight", "mean"), ("arch", "sum")])
def test_search_step_matches_jax(steps, which, reduce):
    """ModelNetSearch's weight step (mean loss) and arch step (summed)."""
    _check_search_step(steps("net"), "net", which, reduce)


@pytest.mark.parametrize("which,reduce", [("weight", "mean"), ("arch", "sum")])
def test_mixed_supernet_search_step_matches_jax(steps, recorded, which, reduce):
    """The mixed ModelSearch's weight step (mean loss) and arch step
    (summed), against JAX's in float64: every MixedOp's seven primitives
    and the alphas' gradient through the whole supernet. The port's fp32
    gradient lies closer to that oracle than JAX's own fp32 step does
    (recorded beside it), which is why the oracle is the float64 step."""
    grad_err = _check_search_step(steps("mixed"), "mixed", which, reduce)
    assert grad_err < float(recorded[f"mixed_step/{which}/fp32_grad_rel_l2"])


def test_unreached_parameters_still_decay():
    """A weight the loss does not reach gets a zero gradient, as under
    jax.grad, and the weight step's decay still moves it: p1 = p0 - lr(0)
    * wd * p0. The search cells hold no such weight: with the shipped B=5
    genotype in a B=2 cell (the CLIs' default genotype at --B 2) a fixed
    cell builds only the ops its blocks call, as flax creates only those
    (tests/test_torch_orbax.py), so the weight here is one the model
    registers and never uses."""
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE

    model = init_params(pt_models.ModelNetSearch(NCLS, AUTODEEPLAB_GENOTYPE, 4, 2, 2, C_index=(2,)),
                        torch.Generator().manual_seed(0))
    assert not [n for n, _ in model.named_parameters() if ".ops_4." in n]  # ops_0-ops_3 sit on the 5 edges
    unreached = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    model.register_parameter("unreached", torch.nn.Parameter(unreached))
    sched = pt_lr_schedule("cos", LR, 1, 2, min_lr=0.003)
    st = SearchSteps(model, make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=WD),
                     make_arch_optimizer(model.arch_parameters(), ARCH_LR), sched)
    p0 = model.unreached.detach().clone()
    st.weight_step(*(torch.from_numpy(a) for a in _batch()))
    assert not model.unreached.grad.any()
    torch.testing.assert_close(model.unreached.detach(), p0 - sched(0) * WD * p0, rtol=0, atol=1e-7)


def test_optimizers_are_the_optax_chains():
    """The weight optimizer (SGD, momentum 0.9, no Nesterov, decay in the
    gradient) and the arch optimizer (Adam, L2 in the gradient) against
    the JAX search trainer's chains over steps of changing lr."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) * s for s in (1.0, 1e-3, 0.5, 2.0)]
    sched = lambda k: 0.1 / (1 + k)  # noqa: E731
    chains = {
        "weight": (optax.chain(optax.add_decayed_weights(WD), optax.sgd(sched, momentum=0.9)),
                   lambda p: make_optimizer([p], nesterov=False, weight_decay=WD)),
        "arch": (jx_make_arch_optimizer(ARCH_LR, ARCH_WD), lambda p: make_arch_optimizer([p], ARCH_LR, ARCH_WD)),
    }
    for name, (tx, make) in chains.items():
        jp = jnp.asarray(p0)
        opt = tx.init(jp)
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        torch_opt = make(p)
        for k, g in enumerate(grads):
            upd, opt = tx.update(jnp.asarray(g), opt, jp)
            jp = optax.apply_updates(jp, upd)
            if name == "weight":
                torch_opt.param_groups[0]["lr"] = sched(k)
            p.grad = torch.from_numpy(g)
            torch_opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7, err_msg=name)


# --------------------------------------------------------------- trainer


def _trainer(run_dir, epochs=2, **cfg):
    model = init_params(_supernet(pt_models, "net"), torch.Generator().manual_seed(0))
    a = PtLoader(PtSynthetic(8, HW, NCLS), 4, num_workers=1)
    b = PtLoader(PtSynthetic(4, HW, NCLS, seed=2), 4, num_workers=1)
    val = PtLoader(PtSynthetic(2, HW, NCLS, seed=1), 2, shuffle=False, drop_last=False, num_workers=1)
    config = SearchConfig(epochs=epochs, alpha_epoch=1, eval_interval=1, lr=0.01, run_dir=str(run_dir), **cfg)
    return SearchTrainer(model, a, b, val, config, device="cpu")


def test_search_trainer_end_to_end_and_resume(tmp_path):
    """Two epochs with alpha_epoch=1 (the arch moves in the second only),
    the decoded files of each validation, then a run cut after one epoch
    and resumed with 'auto' ends bitwise where the straight run ends."""
    straight = _trainer(tmp_path / "a")
    betas0 = straight.model.betas.detach().clone()
    straight.training(0)
    assert torch.equal(straight.model.betas, betas0) and straight.steps.step == 2
    assert len(straight.step_ms["weight"]) == 2 and not straight.step_ms["arch"]
    straight.validation(0)
    loss = straight.training(1)
    assert np.isfinite(loss) and not torch.equal(straight.model.betas, betas0)
    assert len(straight.step_ms["arch"]) == 2
    result = straight.validation(1)
    assert len(result["miou"]) == 2
    exp0 = tmp_path / "a" / "synthetic" / "search" / "experiment_0"
    for e in (0, 1):
        path = np.load(exp0 / f"arch_epoch_{e}" / "network_path.npy")
        assert path.shape == (4,) and path[0] in (0, 1) and np.all(np.abs(np.diff(path.astype(int))) <= 1)
        assert np.load(exp0 / f"arch_epoch_{e}" / "betas.npy").shape == (4, 4, 3)
        assert not (exp0 / f"arch_epoch_{e}" / "genotype.npy").exists()  # fixed cells: no alphas
    np.testing.assert_array_equal(np.load(exp0 / "arch_epoch_1" / "betas.npy"), straight.model.betas.detach().numpy())

    cut = _trainer(tmp_path / "b")
    cut.fit(1)
    resumed = _trainer(tmp_path / "b", resume="auto")
    assert resumed.start_epoch == 1 and resumed.steps.step == 2
    assert resumed.saver.experiment_dir.endswith("experiment_1")
    resumed.fit()
    assert resumed.steps.step == straight.steps.step == 4
    for name, want in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], want), name
    a_state = resumed.steps.a_optimizer.state_dict()["state"]
    assert sorted(int(s["step"]) for s in a_state.values()) == [2]  # Adam's count, restored and continued
    state, meta = restore_checkpoint(find_latest_checkpoint(str(tmp_path / "b"), "synthetic", "search"))
    assert meta["epoch"] == 1 and state["step"] == 4 and set(state) == {"model", "w_opt", "a_opt", "step"}


def test_search_loaders_split(tmp_path):
    """The synthetic split; Cityscapes' (``two_train_seg``, held to JAX in
    tests/test_torch_data.py) raises on a root without frames, as the JAX
    dataset does."""
    a, b, val, n = pt_make_data_loader("synthetic", 4, 1, num_workers=1, synthetic_length=8,
                                       synthetic_crop=HW, supernet=True)
    assert (len(a.dataset), len(b.dataset), len(val.dataset), n) == (8, 4, 8, 19)
    assert b.dataset.seed == 2 and len(b) == 1
    with pytest.raises(FileNotFoundError, match="No files"):
        pt_make_data_loader("cityscapes", 4, supernet=True, root=str(tmp_path / "missing"))


# ------------------------------------------------------------------ CLIs


_TINY = ["--device", "cpu", "--num-layers", "4", "--F", "2", "--B", "2", "--batch-size", "4",
         "--synthetic-crop", "65", "65", "--synthetic-length", "8", "--workers", "1"]


@pytest.mark.parametrize("cli", ["search", "search_layer"])
def test_search_clis_on_cpu(tmp_path, capsys, cli):
    """cli.search net_supernet, two epochs (the arch from the second), a
    validation each; cli.search_layer on the mixed supernet (summed loss),
    one bilevel epoch, with its genotype."""
    run = ["--run-dir", str(tmp_path)]
    if cli == "search":
        argv = _TINY + run + ["--network", "net_supernet", "--exit-layers", "2", "--epochs", "2", "--alpha-epoch", "1",
                              "--eval-interval", "1", "--mixed-exec", "scan", "--no-dp"]
        result = pt_cli_search.main(argv)
        exp, epochs = tmp_path / "synthetic" / "search_net_supernet_F2" / "experiment_0", (0, 1)
    else:
        argv = _TINY + run + ["--network", "supernet", "--exit-layer", "2", "--epochs", "1", "--alpha-epoch", "0"]
        result = pt_cli_search_layer.main(argv)
        exp, epochs = tmp_path / "synthetic" / "search_layer_supernet_F2" / "experiment_0", (0,)
        genotype = np.load(exp / "arch_epoch_0" / "genotype.npy")
        assert genotype.shape == (4, 2) and ((0 <= genotype[:, 1]) & (genotype[:, 1] < 8)).all()
    assert result["experiment_dir"] == str(exp) and np.isfinite(result["train_loss"])
    for e in epochs:
        assert (exp / f"arch_epoch_{e}" / "network_path.npy").exists()
    assert f"loss_reduce: {'mean' if cli == 'search' else 'sum'}" in (exp / "parameters.txt").read_text()
    assert "decoded path:" in capsys.readouterr().out


def test_search_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path is not reachable")
    for main in (pt_cli_search.main, pt_cli_search_layer.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--F", "2", "--B", "2", "--num-layers", "4", "--run-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        SearchTrainer(_supernet(pt_models, "net"), None, None, None, SearchConfig(run_dir=str(tmp_path)))
    assert not os.path.exists(tmp_path / "synthetic")
