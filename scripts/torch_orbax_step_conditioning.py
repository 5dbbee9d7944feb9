"""How far fp32 runs of the one train step that tests/test_torch_orbax.py
resumes from the committed JAX run (tests/torch_orbax_fixture) stand from
the exact step: the port's step in fp32 with 1 and 8 intra-op threads and
in float64, and JAX's recorded step (tests/torch_orbax_ref.npz, fp32 on
the CPU), each update (parameters after minus before) compared over the
same seeded projections the test uses.

    python scripts/torch_orbax_step_conditioning.py

It prints one JSON line: each run's loss and the L2 distances, relative,
of the updates from the float64 one and from each other. No JAX is needed.
"""
import contextlib
import json
import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from auto_dynamic_deeplab_torch.data import SyntheticSegmentation  # noqa: E402
from auto_dynamic_deeplab_torch.models import ADD  # noqa: E402
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH  # noqa: E402
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule  # noqa: E402
from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer  # noqa: E402
from auto_dynamic_deeplab_torch.utils.initialize import init_params  # noqa: E402
from auto_dynamic_deeplab_torch.utils.saver import restore_checkpoint  # noqa: E402

CKPT = os.path.join(_REPO, "tests", "torch_orbax_fixture", "synthetic", "ADD_C2_F4", "experiment_0", "checkpoint")
REF = os.path.join(_REPO, "tests", "torch_orbax_ref.npz")
SCHEDULE = ("poly", 0.01, 2, 5)  # the fixture's (scripts/torch_record_orbax_ref.py)


@contextlib.contextmanager
def _float64_kept():
    """``Tensor.float()`` leaves float64 tensors float64, so that the
    model's fp32 casts (the loss, the classifier) keep float64."""
    to_fp32 = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else to_fp32(t)
    try:
        yield
    finally:
        torch.Tensor.float = to_fp32


def step_update(threads: int, float64: bool = False):
    torch.set_num_threads(threads)
    arch = NETWORK_ARCH[2]
    model = ADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=4, B=5,
                low_level_layer=arch["low_level_layer"])
    model = init_params(model, torch.Generator().manual_seed(0))
    step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule(*SCHEDULE))
    step.load_state_dict(restore_checkpoint(CKPT)[0])
    data = SyntheticSegmentation(4, (65, 65), 19, seed=7)
    image = torch.from_numpy(np.stack([data[i]["image"] for i in range(4)]))
    label = torch.from_numpy(np.stack([data[i]["label"] for i in range(4)]))
    if float64:
        model.double()
        model.decoder.classifier.dtype = None
        for st in step.optimizer.state.values():
            st["momentum_buffer"] = st["momentum_buffer"].double()
        image = image.double()
    before = {k: p.detach().double().clone() for k, p in model.named_parameters()}
    with _float64_kept() if float64 else contextlib.nullcontext():
        loss = step(image, label).item()
    return loss, {k: (p.detach().double() - before[k]).numpy() for k, p in model.named_parameters()}


def sketch(names, update):
    return np.stack([np.random.RandomState(1000 + t).standard_normal((8, update[k].size)) @ update[k].reshape(-1)
                     for t, k in enumerate(names)])


def main():
    ref = np.load(REF)
    names = json.loads(str(ref["step/names"]))
    runs = {"fp32_1_thread": step_update(1), "fp32_8_threads": step_update(8), "float64": step_update(8, True)}
    sk = {k: sketch(names, u) for k, (_, u) in runs.items()}
    sk["jax_fp32"] = ref["step/update_sketch"]

    def rel(a, b):
        return float(np.linalg.norm(sk[a] - sk[b]) / np.linalg.norm(sk[b]))

    print(json.dumps({
        "loss": {**{k: v[0] for k, v in runs.items()}, "jax_fp32": float(ref["step/loss"])},
        "update_rel_to_float64": {k: rel(k, "float64") for k in ("fp32_1_thread", "fp32_8_threads", "jax_fp32")},
        "update_rel_to_jax": {k: rel(k, "jax_fp32") for k in ("fp32_1_thread", "fp32_8_threads", "float64")},
    }))


if __name__ == "__main__":
    main()
