"""Time the port's reader of the JAX package's orbax checkpoints
(utils/orbax_reader.py) on the flagship ADD's variables (C=2, F=20, B=5, 19
classes, 11.37 M parameters), as the JAX package's Saver writes them.

    JAX_PLATFORMS=cpu python scripts/torch_time_orbax_read.py [--repeats 3]

It builds the flax tree from ``jax.eval_shape`` and numpy seeds
(tests/torch_port_helpers.py), saves it with the JAX package's ``Saver``
into a temporary directory, then reads it ``--repeats`` times with the
port's reader (the decoder built beforehand) and once more into the port's
flagship ADD through the bridge. It prints one JSON line: the checkpoint's
bytes and keys, each read's seconds, the load's and the host CPU's model.
"""
import argparse
import json
import os
import platform
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))


def cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args()

    import jax.numpy as jnp

    from auto_dynamic_deeplab_torch.bridge import load_jax_variables
    from auto_dynamic_deeplab_torch.models import ADD as PtADD
    from auto_dynamic_deeplab_torch.utils import zstd
    from auto_dynamic_deeplab_torch.utils.orbax_reader import OcdbtStore, read_orbax_checkpoint
    from auto_dynamic_deeplab_tpu.models import ADD
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_tpu.utils.saver import Saver
    from torch_port_helpers import flax_variables

    arch = NETWORK_ARCH[2]
    kw = dict(F=20, B=5, low_level_layer=arch["low_level_layer"])
    v = flax_variables(ADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, 19, **kw),
                       jnp.zeros((1, 65, 65, 3)), train=False, seed=1)
    zstd.get_lib()
    with tempfile.TemporaryDirectory() as tmp:
        saver = Saver(tmp, "synthetic", "ADD_C2_F20")
        saver.save_checkpoint(v, is_best=False, epoch=0, best_pred=0.0)
        path = os.path.join(saver.experiment_dir, "checkpoint")
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
        reads = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            tree = read_orbax_checkpoint(path)
            reads.append(time.perf_counter() - t0)
        model = PtADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, 19, **kw)
        t0 = time.perf_counter()
        load_jax_variables(model, tree)
        load_s = time.perf_counter() - t0
        n_keys = len(OcdbtStore(path).items())
    print(json.dumps({"checkpoint_bytes": nbytes, "ocdbt_keys": n_keys,
                      "params": sum(p.numel() for p in model.parameters()), "read_s": reads,
                      "load_into_add_s": load_s, "cpu": cpu_model(), "cores": os.cpu_count()}))


if __name__ == "__main__":
    main()
