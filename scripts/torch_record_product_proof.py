"""Record the JAX package's answers on the trained weights, for the PyTorch
port to be held against where JAX is not installed (the GPU machine).

    JAX_PLATFORMS=cpu python scripts/torch_record_product_proof.py \\
        [--out tests/torch_product_proof_ref.json]

Loads artifacts/product_proof/{backbone,edm}.msgpack with
flax.serialization, builds the flagship-topology ADD (NETWORK_ARCH[2],
F=8, B=5, 7 classes) in fp32 and runs it on the 32 validation images of
the beacon task (scripts/product_proof.py::gen_item, seeds 9000-9031,
321x321). Writes, per seed, the EDM's exit-0 confidence; the static mIoU of
each exit over the 32 images; and, at meta.json's threshold, the
EDM-gated mIoU and exit histogram, gated as scripts/product_proof.py gates
(an image exits at exit 0 when its confidence is at or below the
threshold). Run it on the CPU: a TPU computes fp32 convolutions at reduced
precision, so its values are not the oracle.
"""
import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "scripts"))

import flax.serialization as fser  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ART = os.path.join(_REPO, "artifacts", "product_proof")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_product_proof_ref.json"))
    args = p.parse_args(argv)

    from product_proof import gen_item

    from auto_dynamic_deeplab_tpu.models import ADD, EDM
    from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_tpu.train.dynamic import DynamicInferenceEngine
    from auto_dynamic_deeplab_tpu.utils.metrics import Evaluator

    t0 = time.perf_counter()
    with open(os.path.join(ART, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(ART, "backbone.msgpack"), "rb") as f:
        variables = fser.msgpack_restore(f.read())
    with open(os.path.join(ART, "edm.msgpack"), "rb") as f:
        edm_variables = fser.msgpack_restore(f.read())
    m = meta["model"]
    cfg = NETWORK_ARCH[m["network_arch"]]
    ncls, hw, thr = m["num_classes"], tuple(meta["hw"]), meta["threshold_median"]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, ncls, F=m["F"], B=m["B"],
                low_level_layer=cfg["low_level_layer"])
    engine = DynamicInferenceEngine(model, variables, edm=EDM(), edm_variables=edm_variables,
                                    num_classes=ncls, use_pallas_stems=False)
    decide0 = engine._decide(0, hw, "edm", 0.0)
    head0 = engine._head(model.exit_layers[0], hw)
    final = engine._final(hw)
    predict_all = jax.jit(lambda v, x: [jnp.argmax(o, axis=-1) for o in model.apply(v, x, train=False)])

    items = [gen_item(s, hw) for s in meta["val_seeds"]]
    static = [Evaluator(ncls) for _ in model.exit_layers]
    gated = Evaluator(ncls)
    confs, hist = [], [0] * len(model.exit_layers)
    for it in items:
        x = jnp.asarray(it["image"][None])
        for k, pred in enumerate(predict_all(variables, x)):
            static[k].add_batch(it["label"][None], np.asarray(pred))
        state, conf = decide0(x)
        conf = float(np.asarray(conf)[0])
        exit_index = 0 if conf <= thr else len(model.exit_layers) - 1
        logits = head0(state) if exit_index == 0 else final(state)
        gated.add_batch(it["label"][None], np.argmax(np.asarray(logits), axis=1))
        confs.append(conf)
        hist[exit_index] += 1

    ref = {
        "source": "scripts/torch_record_product_proof.py",
        "jax_backend": jax.default_backend(),
        "jax_version": jax.__version__,
        "model": m, "hw": list(hw), "dtype": "float32", "threshold": thr,
        "val_seeds": meta["val_seeds"],
        "exit0_edm_confidence": confs,
        "static_miou_per_exit": [float(e.Mean_Intersection_over_Union()) for e in static],
        "gated_miou": float(gated.Mean_Intersection_over_Union()),
        "exit_histogram": hist,
    }
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in ref.items() if k != "exit0_edm_confidence"}))
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
