"""Write a run directory of the JAX package's checkpoints with its own
``Saver`` (orbax) under tests/torch_orbax_fixture/, and record the JAX
package's answers on it into tests/torch_orbax_ref.npz, for
tests/test_torch_orbax.py and chip_smoke.py phase 16 (which read them
without JAX).

    JAX_PLATFORMS=cpu python scripts/torch_record_orbax_ref.py

The run directory, as cli.train, cli.train_edm and cli.search write it:

  * ``synthetic/ADD_C2_F4/experiment_0/checkpoint``: the stage-2 train
    state (``params``, ``batch_stats``, ``opt_state``, ``step``) of the ADD
    that ``cli.evaluate --F 4`` builds (C=2, B=5, 19 classes), with the
    optimizer of ``train/step.py::make_optimizer`` (weight decay 4e-5,
    Nesterov momentum 0.9, the poly schedule ``SCHEDULE``) at ``STEP``;
  * ``synthetic/edm_C2/experiment_0/edm``: an EDM on that ADD's exit-0
    features (``{"params": ...}``);
  * ``synthetic/search_net_supernet_F2/experiment_0/checkpoint``: the search
    state (``params``, ``batch_stats``, ``arch``, ``w_opt``, ``a_opt``) of
    the supernet that ``cli.search --network net_supernet --num-layers 4
    --exit-layers 2 --F 2 --B 5`` builds, with the search trainer's
    optimizers (SGD with momentum 0.9 and weight decay 3e-4 on the
    schedule ``SEARCH_SCHEDULE``; Adam with L2 1e-3) at ``SEARCH_STEP``.

Each with its ``.meta.json`` (epoch, best_pred). The values are seeded:
``torch_port_helpers.flax_variables`` for the weights, BN statistics and
arch, and normal draws for the momentum traces and the Adam moments (the
second moments their squares), in the structure ``tx.init`` gives, with the
counts set. Every leaf repeats its first ``PERIOD`` values: the ADD has
2.6 M parameters (its ASPP and decoder are 256 channels wide at any F), and
orbax's zstd chunks of seeded values, or of the moments real steps leave,
would take 21 MB for the train state alone; repeated, the whole run
directory takes a few hundred KB.

The npz holds:

  * ``leaves/<checkpoint>``: every leaf as orbax restores it (the JAX
    package's ``restore_checkpoint``), bfloat16 as float32, as a JSON index
    and one byte string per dtype;
  * ``eval/*``: the 8 validation images of ``cli.evaluate --F 4
    --synthetic-crop 65 65 --synthetic-length 8`` (their SHA-256): the
    per-exit logits of the first ``LOGIT_IMAGES`` (N, H, W, C), every
    image's EDM confidence, and its exit and the confidence under the
    dynamic engine at ``eval/threshold`` (the middle of the widest gap
    between the confidences, so that images exit at both exits);
  * ``step/*``: one more step of ``make_single_device_train_step`` from the
    restored train state on a synthetic batch of 4 at 65x65 (seed 7): the
    loss, the BN statistics after it, and the update of every parameter
    (after minus before, in the port's layout and names) as ``SKETCH``
    seeded Gaussian projections (tensor t's from ``RandomState(1000 +
    t)``) and whole for tensors of at most ``FULL`` values.

It takes about two minutes on a few cores (the ADD's train step compiles).
"""
import argparse
import hashlib
import json
import os
import shutil
import sys
import zlib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

PERIOD = 61
F, NCLS, HW = 4, 19, (65, 65)
SCHEDULE = ("poly", 0.01, 2, 5)  # mode, lr, epochs, iterations an epoch
STEP = 2
SEARCH_SCHEDULE = ("cos", 0.025, 2, 4, 0.003)
SEARCH_STEP = 3
SEARCH_WD, ARCH_LR, ARCH_WD = 3e-4, 3e-3, 1e-3
EVAL_LENGTH, LOGIT_IMAGES = 8, 2
STEP_BATCH, STEP_SEED = 4, 7
FULL, SKETCH = 64, 8
STAGE2 = "synthetic/ADD_C2_F4/experiment_0"
EDM_DIR = "synthetic/edm_C2/experiment_0"
SEARCH = "synthetic/search_net_supernet_F2/experiment_0"


def repeat(a) -> np.ndarray:
    """``a``'s first PERIOD values, rounded to bfloat16's precision (float32
    with the low 16 bits cleared), repeated over its shape."""
    a = np.asarray(a)
    block = a.reshape(-1)[:PERIOD]
    if block.dtype == np.float32:
        block = (block.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return np.resize(block, a.shape).astype(a.dtype)


def repeated_tree(tree):
    return jax.tree.map(repeat, tree)


def normal_like(tree, seed: int, scale: float, square: bool = False):
    rng = np.random.RandomState(seed)

    def draw(a):
        v = rng.normal(0.0, scale, np.shape(a)).astype(np.float32)
        return repeat(v * v if square else v)

    return jax.tree.map(draw, tree)


def with_moments(opt_state, count: int, seed: int):
    """``opt_state`` (from ``tx.init``) with its traces and Adam moments
    drawn and its counts set."""
    def fill(path, leaf):
        names = [getattr(k, "name", getattr(k, "key", None)) for k in path]
        leaf_seed = seed + zlib.crc32(jax.tree_util.keystr(path).encode()) % 100003
        if "count" in names:
            return jnp.asarray(count, jnp.int32)
        if "trace" in names or "mu" in names:
            return jnp.asarray(normal_like(np.asarray(leaf), leaf_seed, 0.5))
        if "nu" in names:
            return jnp.asarray(normal_like(np.asarray(leaf), leaf_seed, 0.05, square=True))
        raise ValueError(f"unexpected optimizer leaf {path}")

    return jax.tree_util.tree_map_with_path(fill, opt_state)


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def put_leaves(out, key, tree):
    """Every leaf of ``tree`` (orbax's restore): a JSON index of
    (path, dtype, shape, offset) and one byte string per dtype."""
    index, blobs = [], {}
    for path, a in leaves(tree):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        blob = blobs.setdefault(a.dtype.str, bytearray())
        index.append([".".join(path), a.dtype.str, list(a.shape), len(blob)])
        blob.extend(np.ascontiguousarray(a).tobytes())
    out[f"leaves/{key}:index"] = np.asarray(json.dumps(index))
    for dt, blob in blobs.items():
        out[f"leaves/{key}:{dt}"] = np.frombuffer(bytes(blob), np.uint8)


def sketch(t: int, a: np.ndarray) -> np.ndarray:
    r = np.random.RandomState(1000 + t).standard_normal((SKETCH, a.size))
    return r @ a.reshape(-1).astype(np.float64)


def save(saver_cls, root, rel, state, filename, epoch, best_pred):
    dataset, checkname, _ = rel.split("/")
    saver = saver_cls(root, dataset, checkname)
    assert saver.experiment_dir.endswith(rel), saver.experiment_dir
    saver.save_checkpoint(state, is_best=False, epoch=epoch, best_pred=best_pred, filename=filename)
    return os.path.join(saver.experiment_dir, filename)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.join(_REPO, "tests", "torch_orbax_fixture"))
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_orbax_ref.npz"))
    args = p.parse_args()

    from auto_dynamic_deeplab_torch.bridge import _flatten, _per_edge, _to_torch_layout
    from auto_dynamic_deeplab_tpu.cli.common import resolve_arch
    from auto_dynamic_deeplab_tpu.data import make_data_loader
    from auto_dynamic_deeplab_tpu.data.synthetic import SyntheticSegmentation
    from auto_dynamic_deeplab_tpu.models import ADD, EDM, ModelNetSearch
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_tpu.train.dynamic import DynamicInferenceEngine
    from auto_dynamic_deeplab_tpu.train.schedules import lr_schedule
    from auto_dynamic_deeplab_tpu.train.step import (TrainState, make_arch_optimizer, make_optimizer,
                                                     make_single_device_train_step)
    from auto_dynamic_deeplab_tpu.utils.saver import Saver, restore_checkpoint
    from torch_port_helpers import flax_variables

    shutil.rmtree(args.root, ignore_errors=True)
    out = {}

    # ------------------------------------------------------------- stage 2
    cli = argparse.Namespace(C=2)
    path, c_index, low_level, _ = resolve_arch(cli, None)
    model = ADD(path, c_index, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5, low_level_layer=low_level)
    v = repeated_tree(flax_variables(model, jnp.zeros((1, *HW, 3)), train=False, seed=21))
    mode, lr, epochs, iters = SCHEDULE
    tx = make_optimizer(lr_schedule(mode, lr, epochs, iters))
    params = jax.tree.map(jnp.asarray, v["params"])
    state = {"params": params, "batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"]),
             "opt_state": with_moments(tx.init(params), STEP, 31), "step": jnp.asarray(STEP, jnp.int32)}
    ckpt = save(Saver, args.root, STAGE2, state, "checkpoint", epoch=1, best_pred=0.25)
    restored, _ = restore_checkpoint(ckpt, None)
    put_leaves(out, "stage2", restored)

    # ------------------------------------------------------------- the EDM
    feat = jax.eval_shape(lambda x: model.apply(v, x, train=False, method="get_feature"),
                          jnp.zeros((1, *HW, 3)))[1]
    edm = EDM()
    edm_v = repeated_tree(flax_variables(edm, jnp.zeros(feat.shape), seed=22))
    edm_ckpt = save(Saver, args.root, EDM_DIR, edm_v, "edm", epoch=20, best_pred=-0.05)
    edm_restored, _ = restore_checkpoint(edm_ckpt, None)
    put_leaves(out, "edm", edm_restored)

    # ----------------------------------------------------- the evaluation
    _, val_loader, nclass = make_data_loader("synthetic", 4, 1, synthetic_length=EVAL_LENGTH, synthetic_crop=HW)
    assert nclass == NCLS
    images = np.concatenate([b["image"] for b in val_loader])
    variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
    logits = jax.jit(lambda x: model.apply(variables, x, train=False))(jnp.asarray(images[:LOGIT_IMAGES]))
    engine = DynamicInferenceEngine(model, variables, edm, edm_restored, NCLS)
    confs = np.asarray([engine.infer(images[i:i + 1], -1e9, "edm")[3] for i in range(len(images))])
    s = np.sort(confs)
    gap = int(np.argmax(np.diff(s)))
    threshold = float((s[gap] + s[gap + 1]) / 2)
    runs = [engine.infer(images[i:i + 1], threshold, "edm") for i in range(len(images))]
    exits = np.asarray([r[1] for r in runs], np.int32)
    assert 0 < exits.sum() < len(exits), exits
    out["eval/sha256"] = np.asarray(hashlib.sha256(np.ascontiguousarray(images)).hexdigest())
    out["eval/length"] = np.asarray(EVAL_LENGTH)
    out["eval/hw"] = np.asarray(HW)
    out["eval/threshold"] = np.asarray(threshold)
    out["eval/threshold_margin"] = np.asarray(float(s[gap + 1] - s[gap]) / 2)
    out["eval/confidence"] = confs
    out["eval/dynamic_confidence"] = np.asarray([r[3] for r in runs])
    out["eval/exit"] = exits
    for k, lg in enumerate(logits):
        out[f"eval/logits_{k}"] = np.asarray(lg, np.float32)

    # ---------------------------------------- one more step from the restore
    data = SyntheticSegmentation(STEP_BATCH, HW, NCLS, seed=STEP_SEED)
    items = [data[i] for i in range(STEP_BATCH)]
    batch = {"image": jnp.asarray(np.stack([it["image"] for it in items])),
             "label": jnp.asarray(np.stack([it["label"] for it in items]))}
    target = {"params": params, "batch_stats": state["batch_stats"], "opt_state": tx.init(params),
              "step": jnp.zeros((), jnp.int32)}
    target_restored, _ = restore_checkpoint(ckpt, target)
    ts = TrainState(**target_restored)
    p0 = jax.tree.map(np.array, ts.params)  # the step donates its state
    new, metrics = make_single_device_train_step(model, tx, class_leading=True)(ts, batch)
    out["step/loss"] = np.asarray(metrics["loss"])
    out["step/step"] = np.asarray(int(new.step))
    flat0, flat1, stats = {}, {}, {}
    _flatten(p0, "", flat0)
    _flatten(jax.device_get(new.params), "", flat1)
    _flatten(jax.device_get(new.batch_stats), "", stats)
    flat0, flat1 = _per_edge(flat0), _per_edge(flat1)
    names, sketches, whole = sorted(flat0), [], {}
    for t, name in enumerate(names):
        upd = _to_torch_layout(name, np.asarray(flat1[name], np.float64) - np.asarray(flat0[name], np.float64))
        sketches.append(sketch(t, upd))
        if upd.size <= FULL:
            whole[name] = upd.astype(np.float32)
    out["step/names"] = np.asarray(json.dumps(names))
    out["step/update_sketch"] = np.stack(sketches)
    out["step/update_whole:index"] = np.asarray(json.dumps(sorted(whole)))
    out["step/update_whole"] = np.concatenate([whole[k].reshape(-1) for k in sorted(whole)])
    out["step/stats:index"] = np.asarray(json.dumps([[k, list(np.shape(stats[k]))] for k in sorted(stats)]))
    out["step/stats"] = np.concatenate([np.asarray(stats[k], np.float32).reshape(-1) for k in sorted(stats)])

    # -------------------------------------------------------------- search
    snet = ModelNetSearch(NCLS, AUTODEEPLAB_GENOTYPE, C_index=(2,), num_layers=4, F=2, B=5)
    sv = repeated_tree(flax_variables(snet, jnp.zeros((1, *HW, 3)), train=False, seed=23))
    mode, lr, epochs, iters, min_lr = SEARCH_SCHEDULE
    w_tx = optax.chain(optax.add_decayed_weights(SEARCH_WD),
                       optax.sgd(learning_rate=lr_schedule(mode, lr, epochs, iters, min_lr=min_lr), momentum=0.9))
    a_tx = make_arch_optimizer(ARCH_LR, ARCH_WD)
    sparams = jax.tree.map(jnp.asarray, sv["params"])
    sarch = jax.tree.map(jnp.asarray, sv["arch"])
    sstate = {"params": sparams, "batch_stats": jax.tree.map(jnp.asarray, sv["batch_stats"]), "arch": sarch,
              "w_opt": with_moments(w_tx.init(sparams), SEARCH_STEP, 41),
              "a_opt": with_moments(a_tx.init(sarch), SEARCH_STEP, 51)}
    sckpt = save(Saver, args.root, SEARCH, sstate, "checkpoint", epoch=0, best_pred=0.1)
    put_leaves(out, "search", restore_checkpoint(sckpt, None)[0])

    np.savez_compressed(args.out, **out)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.root) for f in fs)
    print(json.dumps({"fixture_bytes": size, "npz_bytes": os.path.getsize(args.out), "threshold": threshold,
                      "exits": exits.tolist(), "confidence": confs.tolist(), "loss": float(metrics["loss"])}))


if __name__ == "__main__":
    main()
