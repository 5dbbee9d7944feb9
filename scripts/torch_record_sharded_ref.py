"""Record the JAX package's spatially sharded forward and dp×tp train step
for tests/test_torch_spatial.py and tests/test_torch_tensor_parallel.py
into tests/torch_sharded_ref.npz, so that the tests hold the port to them
without compiling the JAX programs again.

    JAX_PLATFORMS=cpu python scripts/torch_record_sharded_ref.py \\
        [--out tests/torch_sharded_ref.npz]

Rerun it when the JAX package's model, ``spatial_shard_forward`` or
``make_tp_train_step`` change, or when a test changes the inputs below
(the tests check the recording's SHA-256 of them). On four virtual CPU
devices, from ``torch_port_helpers.flax_variables``, the tiny ADD of
tests/test_spatial_shard.py (path [1,2,2,2,3,2], exit at cell 1, F=2,
B=5, 19 classes):

- ``spatial/w4``: ``spatial_shard_forward`` over a mesh of 4 devices at
  64x65 (seed 22): every exit's logits, whole; ``spatial/w2`` at 65x65
  (seed 21), the flagship's odd-size rule: JAX's ``spatial_shard_forward``
  refuses it (``device_put`` of an H-sharded input wants H divisible by
  the mesh, and 65 rows do not split over 2 devices, nor 1025 over any
  even count), so the recording is the unsharded ``model.apply`` that
  the sharded program equals;
- ``tp``: ``make_tp_train_step`` over a (data 2, model 2) mesh of the
  model of tests/test_tensor_parallel.py (``axis_name=None``, seed 23,
  ``make_optimizer(lr_schedule("poly", 0.05, 10, 4), weight_decay=4e-5)``)
  on a batch of 4 at 17x17: 255 on most of the first data shard's pixels
  and a few of the second's, so that the global batch's loss and the mean
  of the shards' losses differ. Its loss, the BN statistics after the
  step whole, and ``SKETCH`` seeded Gaussian projections of each
  parameter's update (port layout; tensor t's from
  ``RandomState(2000 + t)``).

It takes about a minute on a few cores.

    JAX_PLATFORMS=cpu python scripts/torch_record_sharded_ref.py --mixed \
        [--out tests/torch_sharded_mixed_ref.npz]

records the same two spatial cases of the ADD built with ``MIXED_GENOTYPE``
(pools, skip and none: the per-op routes of the flat DAG) instead, under
``mixed/w2`` and ``mixed/w4``, into a file of its own (the first file's
arrays stay as they were). Both are the unsharded ``model.apply``: at
64x65 over 4 devices JAX's ``spatial_shard_forward`` of this model
disagrees with its own ``model.apply`` (the second exit all NaN), so the
recording keeps, beside the answer, that program's max |Δ| against it and
its count of NaNs (``mixed/w4/sharded_max_abs_diff``, ``.../sharded_nans``).
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
jax.config.update("jax_num_cpu_devices", 4)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

PATH, C_INDEX, NCLS, F_, B_ = [1, 2, 2, 2, 3, 2], [1], 19, 2, 5
SPATIAL = {"w2": (2, (65, 65), 21), "w4": (4, (64, 65), 22)}
# max_pool+sep3, skip+dil5, avg_pool+dil3, none+sep5, skip+sep3 (chip_smoke.py's)
MIXED_GENOTYPE = [[0, 1], [1, 4], [2, 3], [3, 7], [5, 2], [8, 6], [11, 0], [13, 5], [18, 3], [19, 4]]
TP_HW, TP_N, TP_SEED, SKETCH = (17, 17), 4, 23, 8


def leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def sha256(*arrays) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


def spatial_inputs(name, genotype=None):
    """(image, variables) of a spatial case (the test rebuilds them)."""
    from auto_dynamic_deeplab_tpu.models import ADD
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from torch_port_helpers import flax_variables

    _, hw, seed = SPATIAL[name]
    genotype = AUTODEEPLAB_GENOTYPE if genotype is None else genotype
    v = flax_variables(ADD(PATH, C_INDEX, genotype, NCLS, F=F_, B=B_), jnp.zeros((1, *hw, 3)),
                       train=False, seed=seed)
    x = np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)
    return x, v


def tp_inputs():
    """(image, label, variables) of the TP case (the test rebuilds them)."""
    from auto_dynamic_deeplab_tpu.models import ADD
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from torch_port_helpers import flax_variables

    jm = ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F_, B=B_, low_level_layer=0, axis_name=None)
    v = flax_variables(jm, jnp.zeros((1, *TP_HW, 3)), train=False, seed=TP_SEED)
    rng = np.random.RandomState(TP_SEED)
    x = rng.randn(TP_N, *TP_HW, 3).astype(np.float32)
    y = rng.randint(0, NCLS, size=(TP_N, *TP_HW)).astype(np.int32)
    y[: TP_N // 2, : TP_HW[0] * 3 // 4] = 255
    y[TP_N // 2:, :2, :3] = 255
    return x, y, v


def put_tree(out, prefix, tree):
    items = list(leaves(tree))
    out[f"{prefix}:index"] = np.asarray(json.dumps([[k, list(a.shape)] for k, a in items]))
    out[f"{prefix}:data"] = np.concatenate([a.astype(np.float32).ravel() for _, a in items])


def record_spatial(out, prefix="spatial", genotype=None):
    from auto_dynamic_deeplab_tpu.models import ADD
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_tpu.parallel import make_mesh, spatial_shard_forward

    for name, (world, hw, _) in SPATIAL.items():
        x, v = spatial_inputs(name, genotype)
        model = ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE if genotype is None else genotype, NCLS, F=F_, B=B_)
        vj = jax.tree.map(jnp.asarray, v)
        if hw[0] % world or genotype is not None:
            outs = model.apply(vj, jnp.asarray(x), train=False)
            out[f"{prefix}/{name}/program"] = np.asarray("model.apply")
            if not hw[0] % world:
                mesh = make_mesh(n_data=world, devices=jax.devices()[:world])
                sharded = [np.asarray(o, np.float64) for o in spatial_shard_forward(model, vj, mesh)(jnp.asarray(x))]
                diff = [np.nan_to_num(np.abs(a - np.asarray(o, np.float64)), nan=np.inf).max()
                        for a, o in zip(sharded, outs)]
                out[f"{prefix}/{name}/sharded_max_abs_diff"] = np.asarray(diff)
                out[f"{prefix}/{name}/sharded_nans"] = np.asarray([int(np.isnan(a).sum()) for a in sharded])
        else:
            mesh = make_mesh(n_data=world, devices=jax.devices()[:world])
            outs = spatial_shard_forward(model, vj, mesh)(jnp.asarray(x))
            out[f"{prefix}/{name}/program"] = np.asarray("spatial_shard_forward")
        out[f"{prefix}/{name}/sha256"] = np.asarray(sha256(x, *[a for _, a in leaves(v)]))
        out[f"{prefix}/{name}/logits"] = np.stack([np.asarray(o, np.float32) for o in outs])


def record_mixed(out):
    record_spatial(out, "mixed", MIXED_GENOTYPE)


def record_tp(out):
    from auto_dynamic_deeplab_torch.bridge import _to_torch_layout
    from auto_dynamic_deeplab_tpu.models import ADD
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_tpu.parallel import make_mesh, make_tp_train_step, shard_train_state
    from auto_dynamic_deeplab_tpu.train import lr_schedule, make_optimizer
    from auto_dynamic_deeplab_tpu.train.step import TrainState

    x, y, v = tp_inputs()
    jm = ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F_, B=B_, low_level_layer=0, axis_name=None)
    tx = make_optimizer(lr_schedule("poly", 0.05, 10, 4), weight_decay=4e-5)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    new, metrics = make_tp_train_step(jm, tx, mesh)(shard_train_state(state, mesh),
                                                    {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    out["tp/sha256"] = np.asarray(sha256(x, y, *[a for _, a in leaves(v)]))
    out["tp/loss"] = np.asarray(metrics["loss"])
    put_tree(out, "tp/stats", jax.device_get(new.batch_stats))
    p1 = dict(leaves(jax.device_get(new.params)))
    names, sketches = [], []
    for t, (path, a0) in enumerate(leaves(v["params"])):
        name = path.replace("/", ".")
        d = _to_torch_layout(name, np.asarray(p1[path], np.float64) - np.asarray(a0, np.float64))
        names.append(name)
        sketches.append(np.random.RandomState(2000 + t).standard_normal((SKETCH, d.size)) @ d.ravel())
    out["tp/update_names"] = np.asarray(json.dumps(names))
    out["tp/update_sketch"] = np.stack(sketches)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mixed", action="store_true", help="record the MIXED_GENOTYPE spatial cases")
    p.add_argument("--out", default=None, help="default: tests/torch_sharded_ref.npz, with --mixed "
                   "tests/torch_sharded_mixed_ref.npz")
    args = p.parse_args(argv)
    if args.out is None:
        name = "torch_sharded_mixed_ref.npz" if args.mixed else "torch_sharded_ref.npz"
        args.out = os.path.join(_REPO, "tests", name)
    t0 = time.perf_counter()
    out = {}
    parts = (("mixed", record_mixed),) if args.mixed else (("spatial", record_spatial), ("tp", record_tp))
    for name, fn in parts:
        fn(out)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    out["meta/jax_version"] = np.asarray(jax.__version__)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays, {os.path.getsize(args.out) / 2**20:.2f} MiB, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
