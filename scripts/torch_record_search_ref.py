"""Record the JAX package's answers for tests/test_torch_search.py into
tests/torch_search_ref.npz, so that the test holds the port to them
without compiling the JAX programs again.

    JAX_PLATFORMS=cpu python scripts/torch_record_search_ref.py \\
        [--out tests/torch_search_ref.npz]

The tiny supernets of the test (65x65, 4 layers, F=2, B=2, 5 classes,
batch 4): for each of ModelSearch (mixed cells), ModelNetSearch and
ModelBaselinePathSearch, the numpy-seeded variables
(``torch_port_helpers.flax_variables``, seed 3), the eval and training
logits of every exit and the BN statistics training leaves; ModelNetSearch's
eval logits under the bf16 policy; and one bilevel step of ModelNetSearch
and of ModelSearch through ``make_search_steps``: the weight step (mean
loss) and the arch step (summed loss), each from the same variables, with
its loss, the statistics it blended and its gradient read off a probing
optimizer (SGD at lr 1e3: g' = (p0 - p1) / 1e3; Adam with eps = lr = 1e6:
g' = a0 - a1; g' includes the decay). The inputs are the port's and the
JAX package's synthetic batches (the same numpy code), seeds 0 and 1: the
file keeps their SHA-256.

ModelSearch's step is recorded in float64: its fp32 program parts from
exact arithmetic by 7e-4 in the gradient (L2, relative; the value is
stored as ``mixed_step/<weight|arch>/fp32_grad_rel_l2``), 200 times
the port's fp32 step. The JAX package computes in fp32 through explicit ``jnp.float32``
casts, so for that step the script enables ``jax_enable_x64`` and
resolves ``jnp.float32`` to float64 in the package's modules at run time
(no file of the package changes).

A tree is stored as one float32 vector (``<prefix>:data``) and a JSON
index of its leaves' paths and shapes (``<prefix>:index``). The JAX
package is the reference and does not change, so the file changes only
when the test's configuration does. The whole script takes about 20
minutes on a few cores: the mixed supernet's step programs, in fp32 and
in float64, compile for minutes each.
"""
import argparse
import hashlib
import json
import os
import sys
import time
import types

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

HW, N, NCLS = (65, 65), 4, 5
G2 = ((1, 6), (0, 3), (4, 5), (2, 1))
WD, ARCH_WD = 8e-4, 1e-3
PROBE_LR = 1e3
KINDS = ("mixed", "net", "baseline")


def supernet(kind, **kw):
    from auto_dynamic_deeplab_tpu import models

    common = dict(num_layers=4, F=2, B=2, **kw)
    if kind == "mixed":
        return models.ModelSearch(NCLS, exit_layer=2, **common)
    if kind == "net":
        return models.ModelNetSearch(NCLS, G2, C_index=(2,), **common)
    return models.ModelBaselinePathSearch(NCLS, G2, exit_layer=2, **common)


def batch(seed):
    from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation

    items = [SyntheticSegmentation(N, HW, NCLS, seed=seed)[i] for i in range(N)]
    return np.stack([s["image"] for s in items]), np.stack([s["label"] for s in items])


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def put_tree(out, prefix, tree):
    """A nested dict of float arrays as one float32 vector and its index."""
    leaves = list(_leaves(tree))
    out[f"{prefix}:index"] = np.asarray(json.dumps([[k, list(a.shape)] for k, a in leaves]))
    out[f"{prefix}:data"] = np.concatenate([a.astype(np.float32).ravel() for _, a in leaves])


def put_list(out, prefix, arrays):
    for i, a in enumerate(arrays):
        out[f"{prefix}/{i}"] = np.asarray(a, np.float32)


def sha256(*arrays) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


class _Float64Numpy(types.ModuleType):
    """jax.numpy with ``float32`` resolved to float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def in_float64():
    """Every loaded module of the JAX package computes in float64 from here on."""
    jax.config.update("jax_enable_x64", True)
    proxy = _Float64Numpy("jax.numpy (float64)")
    for name, module in list(sys.modules.items()):
        if name.startswith("auto_dynamic_deeplab_tpu") and getattr(module, "jnp", None) is jnp:
            module.jnp = proxy


def grads_of(out, prefix, variables, decay):
    """The recorded gradients (g' less the decay) as one float64 vector."""
    index = json.loads(str(out[f"{prefix}/decayed:index"]))
    flat = np.asarray(out[f"{prefix}/decayed:data"], np.float64)
    p0 = dict(_leaves(variables))
    at, parts = 0, []
    for path, shape in index:
        n = int(np.prod(shape))
        parts.append(flat[at:at + n] - decay * np.asarray(p0[path], np.float64).ravel())
        at += n
    return np.concatenate(parts)


def record_steps(out, kind, model, variables, image, label, dtype=np.float32):
    """One weight step and one arch step from ``variables``, read through
    the probing optimizers; raises unless the loss, the statistics and the
    updated parameters came out in ``dtype``."""
    from auto_dynamic_deeplab_tpu.train.step import make_search_steps

    v = jax.tree.map(jnp.asarray, variables)
    data = {"image": jnp.asarray(image), "label": jnp.asarray(label)}

    w_probe = optax.chain(optax.add_decayed_weights(WD), optax.sgd(PROBE_LR, momentum=0.9))
    a_probe = optax.chain(optax.add_decayed_weights(ARCH_WD), optax.scale_by_adam(eps=1e6), optax.scale(-1e6))
    ws, _ = make_search_steps(model, w_probe, a_probe, loss_reduce="mean")
    _, as_ = make_search_steps(model, w_probe, a_probe, loss_reduce="sum")
    p1, w_stats, _, w_loss = ws(v["params"], v["batch_stats"], v["arch"], w_probe.init(v["params"]), data)
    a1, a_stats, _, a_loss = as_(v["params"], v["batch_stats"], v["arch"], a_probe.init(v["arch"]), data)
    for which, p0, p_1, stats, loss, scale in (
        ("weight", v["params"], p1, w_stats, w_loss, PROBE_LR),
        ("arch", v["arch"], a1, a_stats, a_loss, 1.0),
    ):
        prefix = f"{kind}_step/{which}"
        got = {np.asarray(loss).dtype} | {a.dtype for t in (stats, p_1) for _, a in _leaves(jax.device_get(t))}
        if got != {np.dtype(dtype)}:
            raise AssertionError(f"{prefix} computed in {sorted(map(str, got))}, want {np.dtype(dtype)}")
        # the difference in float64 from the float32 parameters
        p0, p_1 = (jax.tree.map(lambda a: np.asarray(a, np.float64), jax.device_get(t)) for t in (p0, p_1))
        out[f"{prefix}/loss"] = np.asarray(loss)
        put_tree(out, f"{prefix}/stats", jax.device_get(stats))
        put_tree(out, f"{prefix}/decayed", jax.tree.map(lambda a, b: (a - b) / scale, p0, p_1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_search_ref.npz"))
    args = p.parse_args(argv)
    from torch_port_helpers import flax_variables

    t0 = time.perf_counter()
    out = {}
    image, label0 = batch(0)
    step_image, step_label = batch(1)
    out["batch0/sha256"] = np.asarray(sha256(image, label0))
    out["batch1/sha256"] = np.asarray(sha256(step_image, step_label))
    for kind in KINDS:
        jm = supernet(kind, remat=False)
        v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=True, seed=3)
        ev = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(image))
        tr, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(image))
        for collection, tree in v.items():
            put_tree(out, f"{kind}/variables/{collection}", tree)
        put_list(out, f"{kind}/eval", ev)
        put_list(out, f"{kind}/train", tr)
        put_tree(out, f"{kind}/stats", jax.device_get(upd["batch_stats"]))
        if kind == "net":
            jm16 = supernet("net", remat=False, dtype=jnp.bfloat16)
            put_list(out, "net/bf16_eval", jax.jit(lambda v, x: jm16.apply(v, x, train=False))(v, jnp.asarray(image)))
        if kind == "net":
            record_steps(out, kind, jm, v, step_image, step_label)
        if kind == "mixed":
            mixed = v
            record_steps(out, "mixed_fp32", jm, v, step_image, step_label)
        print(f"{kind}: {time.perf_counter() - t0:.1f} s", flush=True)
    in_float64()
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), mixed)
    record_steps(out, "mixed", supernet("mixed", remat=False), v64, step_image.astype(np.float64), step_label,
                 dtype=np.float64)
    for which, collection, decay in (("weight", "params", WD), ("arch", "arch", ARCH_WD)):
        g32 = grads_of(out, f"mixed_fp32_step/{which}", mixed[collection], decay)
        g64 = grads_of(out, f"mixed_step/{which}", mixed[collection], decay)
        out[f"mixed_step/{which}/fp32_grad_rel_l2"] = np.asarray(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))
    for key in [k for k in out if k.startswith("mixed_fp32_step/")]:
        del out[key]
    print(f"mixed in float64: {time.perf_counter() - t0:.1f} s", flush=True)
    out["meta/jax_version"] = np.asarray(jax.__version__)
    out["meta/backend"] = np.asarray(jax.default_backend())
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays, {os.path.getsize(args.out) / 2**20:.2f} MiB, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
