"""Record the JAX package's data-parallel and pipelined answers for
tests/test_torch_parallel.py and tests/test_torch_pipeline.py into
tests/torch_parallel_ref.npz, so that the tests hold the port to them
without compiling the JAX programs again.

    JAX_PLATFORMS=cpu python scripts/torch_record_parallel_ref.py \\
        [--out tests/torch_parallel_ref.npz]

On two virtual CPU devices, from ``torch_port_helpers.flax_variables``:

- ``train``: one ``make_train_step`` over a 2-device data mesh
  (``shard_map``, gradients and loss ``pmean``-ed, BN with
  ``axis_name=DATA_AXIS``) of the tiny ADD (path [1,2,2,2,3,2], exit at
  cell 1, F=2, B=5, 7 classes, seed 11) on a global batch of 4 at 33x33,
  class-leading logits. The labels of the first half are mostly 255 and
  the second half's hardly, so that the mean of per-shard losses and the
  global-batch loss differ. Its gradient is read off a probing optimizer
  (SGD with Nesterov momentum 0.9 at lr 1e3: g' = (p0 - p1) / 1900,
  which includes the decay 4e-5·p0). The ADD has 2.1 M parameters, so the
  file keeps, in the port's layout and under the port's names
  (``bridge._to_torch_layout``), each gradient tensor of at most ``FULL``
  values whole and, of every tensor, ``SKETCH`` seeded Gaussian
  projections (tensor t's from ``RandomState(1000 + t)``); the BN
  statistics the step leaves are kept whole;
- ``search``: the weight step (mean loss) and the arch step (summed
  loss) of ``make_search_steps(mesh=...)`` on the tiny ModelNetSearch
  (4 layers, F=2, B=2, 5 classes, seed 3) on a global batch of 4 at
  65x65 with the same uneven 255s, read through the probing optimizers of
  scripts/torch_record_search_ref.py (SGD at lr 1e3; Adam with eps = lr =
  1e6), whole;
- ``pipeline``: ``PipelinedDynamicInference`` over the two devices on the
  tiny ADD of tests/test_torch_dynamic.py (F=4, 7 classes, 33x65, seed 5,
  with an EDM of seed 8) for one image (seed 4): logits, exit index and
  confidence for entropy at thresholds 2.0 (exits at exit 0) and -1.0
  (runs to the end), EDM at 1e9 (exit 0) and max at 2.0 (the end).

The inputs are rebuilt by the tests from the same seeds; the file keeps
their SHA-256. It takes about two minutes on a few cores.
"""
import argparse
import hashlib
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

TRAIN_PATH, TRAIN_C_INDEX, TRAIN_NCLS, TRAIN_F, TRAIN_HW, N = [1, 2, 2, 2, 3, 2], [1], 7, 2, (33, 33), 4
SEARCH_HW, SEARCH_NCLS = (65, 65), 5
G2 = ((1, 6), (0, 3), (4, 5), (2, 1))
PIPE_PATH, PIPE_C_INDEX, PIPE_NCLS, PIPE_F, PIPE_HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)
PIPE_CASES = (("entropy", 2.0), ("entropy", -1.0), ("edm", 1e9), ("max", 2.0))
WD, SEARCH_WD, ARCH_WD, PROBE_LR = 4e-5, 8e-4, 1e-3, 1e3
FULL, SKETCH = 4096, 8


def uneven_batch(n, hw, ncls, seed):
    """The port's and the JAX package's synthetic batch, with 255s on most
    of the first half's pixels and a few of the second half's."""
    from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation

    items = [SyntheticSegmentation(n, hw, ncls, seed=seed)[i] for i in range(n)]
    image = np.stack([s["image"] for s in items])
    label = np.stack([s["label"] for s in items]).astype(np.int32)
    label[: n // 2, : hw[0] * 3 // 4] = 255
    label[n // 2:, :2, :3] = 255
    return image, label


def leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def put_tree(out, prefix, tree):
    """A nested dict of float arrays as one float32 vector and its index."""
    items = list(leaves(tree))
    out[f"{prefix}:index"] = np.asarray(json.dumps([[k, list(a.shape)] for k, a in items]))
    out[f"{prefix}:data"] = np.concatenate([a.astype(np.float32).ravel() for _, a in items])


def sketch(t: int, g: np.ndarray) -> np.ndarray:
    """SKETCH seeded Gaussian projections of tensor number ``t``'s values
    (tests/test_torch_parallel.py computes the same)."""
    r = np.random.RandomState(1000 + t).standard_normal((SKETCH, g.size))
    return r @ np.asarray(g, np.float64).ravel()


def sha256(*arrays) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


def record_train(out, mesh):
    from auto_dynamic_deeplab_torch.bridge import _to_torch_layout
    from auto_dynamic_deeplab_tpu import models
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_tpu.parallel import DATA_AXIS
    from auto_dynamic_deeplab_tpu.train.step import TrainState, make_train_step
    from torch_port_helpers import flax_variables

    jm = models.ADD(TRAIN_PATH, TRAIN_C_INDEX, AUTODEEPLAB_GENOTYPE, TRAIN_NCLS, F=TRAIN_F, B=5,
                    axis_name=DATA_AXIS)
    v = flax_variables(jm, jnp.zeros((1, *TRAIN_HW, 3)), train=False, seed=11)
    image, label = uneven_batch(N, TRAIN_HW, TRAIN_NCLS, seed=0)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.sgd(PROBE_LR, momentum=0.9, nesterov=True))
    params = jax.tree.map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))
    step = make_train_step(jm, tx, mesh, class_leading=True)
    new, metrics = step(state, {"image": jnp.asarray(image), "label": jnp.asarray(label)})
    out["train/sha256"] = np.asarray(sha256(image, label, *[a for _, a in leaves(v)]))
    out["train/loss"] = np.asarray(metrics["loss"])
    put_tree(out, "train/stats", jax.device_get(new.batch_stats))
    p0, p1 = dict(leaves(v["params"])), dict(leaves(jax.device_get(new.params)))
    names, full, sketches = [], {}, []
    for t, (path, a0) in enumerate(p0.items()):
        name = path.replace("/", ".")
        g = (np.asarray(a0, np.float64) - np.asarray(p1[path], np.float64)) / (PROBE_LR * 1.9)
        g = _to_torch_layout(name, g)
        names.append(name)
        sketches.append(sketch(t, g))
        if g.size <= FULL:
            full[name] = g
    out["train/grad_names"] = np.asarray(json.dumps(names))
    out["train/grad_sketch"] = np.stack(sketches)
    put_tree(out, "train/grad_full", full)


def record_search(out, mesh):
    from auto_dynamic_deeplab_tpu import models
    from auto_dynamic_deeplab_tpu.parallel import DATA_AXIS
    from auto_dynamic_deeplab_tpu.train.step import make_search_steps
    from torch_port_helpers import flax_variables

    jm = models.ModelNetSearch(SEARCH_NCLS, G2, C_index=(2,), num_layers=4, F=2, B=2, remat=False,
                               axis_name=DATA_AXIS)
    v = flax_variables(jm, jnp.zeros((1, *SEARCH_HW, 3)), train=True, seed=3)
    image, label = uneven_batch(N, SEARCH_HW, SEARCH_NCLS, seed=1)
    out["search/sha256"] = np.asarray(sha256(image, label, *[a for _, a in leaves(v)]))
    data = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    w_probe = optax.chain(optax.add_decayed_weights(SEARCH_WD), optax.sgd(PROBE_LR, momentum=0.9))
    a_probe = optax.chain(optax.add_decayed_weights(ARCH_WD), optax.scale_by_adam(eps=1e6), optax.scale(-1e6))
    w_step, _ = make_search_steps(jm, w_probe, a_probe, mesh=mesh, loss_reduce="mean")
    _, a_step = make_search_steps(jm, w_probe, a_probe, mesh=mesh, loss_reduce="sum")
    vj = jax.tree.map(jnp.asarray, v)
    p1, w_stats, _, w_loss = w_step(vj["params"], vj["batch_stats"], vj["arch"], w_probe.init(vj["params"]), data)
    a1, a_stats, _, a_loss = a_step(vj["params"], vj["batch_stats"], vj["arch"], a_probe.init(vj["arch"]), data)
    for which, p0, p_1, stats, loss, scale in (("weight", v["params"], p1, w_stats, w_loss, PROBE_LR),
                                                ("arch", v["arch"], a1, a_stats, a_loss, 1.0)):
        p_1 = jax.device_get(p_1)
        out[f"search/{which}/loss"] = np.asarray(loss)
        put_tree(out, f"search/{which}/stats", jax.device_get(stats))
        put_tree(out, f"search/{which}/decayed", jax.tree.map(
            lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64)) / scale, p0, p_1))


def record_pipeline(out):
    from auto_dynamic_deeplab_tpu import models
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_tpu.parallel import PipelinedDynamicInference
    from torch_port_helpers import flax_variables

    jm = models.ADD(PIPE_PATH, PIPE_C_INDEX, AUTODEEPLAB_GENOTYPE, PIPE_NCLS, F=PIPE_F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *PIPE_HW, 3)), train=False, seed=5)
    c_feat = 5 * PIPE_F * 4  # cell 1's concat channels at level 2
    jedm = models.EDM()
    ev = flax_variables(jedm, jnp.zeros((1, 9, 17, c_feat)), seed=8)
    x = np.random.RandomState(4).randn(1, *PIPE_HW, 3).astype(np.float32)
    out["pipeline/sha256"] = np.asarray(sha256(x, *[a for _, a in leaves(v)], *[a for _, a in leaves(ev)]))
    for confidence, thr in PIPE_CASES:
        pipe = PipelinedDynamicInference(jm, v, PIPE_HW, devices=jax.devices()[:2], confidence=confidence,
                                         threshold=thr, edm=jedm, edm_variables=ev, num_classes=PIPE_NCLS)
        logits, k, conf = pipe.infer(jnp.asarray(x))
        key = f"pipeline/{confidence}/{thr:g}"
        out[f"{key}/logits"] = np.asarray(logits, np.float32)
        out[f"{key}/exit"] = np.asarray(k)
        out[f"{key}/confidence"] = np.asarray(conf, np.float64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_parallel_ref.npz"))
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    out = {}
    for name, fn in (("train", lambda: record_train(out, mesh)), ("search", lambda: record_search(out, mesh)),
                     ("pipeline", lambda: record_pipeline(out))):
        fn()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    out["meta/jax_version"] = np.asarray(jax.__version__)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays, {os.path.getsize(args.out) / 2**20:.2f} MiB, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
