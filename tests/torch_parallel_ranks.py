"""One rank of tests/test_torch_parallel.py's data-parallel cases, on the
CPU over gloo (no jax here: only the port and torch).

    WORLD_SIZE=2 RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_ranks.py SPEC OUT

SPEC (``torch.save``, written by the test) holds the global inputs and the
initial state of each case; this rank runs its rows of each through the
port and ``torch.save``s what it got to OUT:

- ``bn``: cross-replica training BatchNorm: output rows, the input
  gradient of sum(y·w) and the running statistics;
- ``train``: one ``TrainStep`` of the tiny ADD with its BNs over the group:
  the averaged loss and gradients, the state after the step;
- ``search``: a weight step and an arch step of the tiny ModelNetSearch;
- ``errors``: what ``make_data_mesh`` says of a batch of 3, and the
  ``Trainer`` with ``data_parallel=False``.
"""
import sys

import torch

from auto_dynamic_deeplab_torch import models
from auto_dynamic_deeplab_torch.data import DataLoader, SyntheticSegmentation
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_torch.ops.norm import BatchNorm, set_bn_group
from auto_dynamic_deeplab_torch.parallel import destroy, initialize, make_data_mesh
from auto_dynamic_deeplab_torch.train.step import SearchSteps, TrainStep, make_arch_optimizer, make_optimizer
from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer


def run_bn(case, mesh):
    x, w = case["x"], case["w"]  # NCHW, the global batch
    rows = mesh.rows(x.shape[0])
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(case["state"])
    set_bn_group(bn.train(), mesh.group)
    xr = x[rows].clone().requires_grad_(True)
    y = bn(xr)
    (y * w[rows]).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "mean": bn.mean.clone(), "var": bn.var.clone()}


def grads_and_state(model, loss):
    return {"loss": loss.item(), "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: t.clone() for k, t in model.state_dict().items()}}


def run_train(case, mesh):
    model = models.ADD(*case["args"], AUTODEEPLAB_GENOTYPE, case["ncls"], F=case["F"], B=5)
    model.load_state_dict(case["state"])
    set_bn_group(model, mesh.group)
    step = TrainStep(model, make_optimizer(model.parameters()), lambda _: case["lr"], mesh=mesh)
    rows = mesh.rows(case["image"].shape[0])
    return grads_and_state(model, step(case["image"][rows], case["label"][rows]))


def run_search(case, mesh):
    model = models.ModelNetSearch(case["ncls"], case["genotype"], C_index=(2,), num_layers=4, F=2, B=2, remat=False)
    model.load_state_dict(case["state"])
    set_bn_group(model, mesh.group)
    rows = mesh.rows(case["image"].shape[0])
    out = {}
    for which in ("weight", "arch"):
        model.load_state_dict(case["state"])  # each step from the same variables
        for p in model.parameters():
            p.grad = None
        steps = SearchSteps(model, make_optimizer(model.weight_parameters(), nesterov=False, weight_decay=8e-4),
                            make_arch_optimizer(model.arch_parameters(), 1e-3), lambda _: 0.05,
                            loss_reduce="mean" if which == "weight" else "sum", mesh=mesh)
        loss = getattr(steps, f"{which}_step")(case["image"][rows], case["label"][rows])
        out[which] = grads_and_state(model, loss)
    return out


def errors(tmp: str) -> dict:
    out = {}
    try:
        make_data_mesh(3)
    except ValueError as e:
        out["make_data_mesh"] = str(e)
    loader = DataLoader(SyntheticSegmentation(2, (33, 33), 7), 2)
    try:
        Trainer(models.ADD([1, 2, 2, 2, 3, 2], [1], AUTODEEPLAB_GENOTYPE, 7, F=2, B=5), loader, loader,
                TrainConfig(run_dir=tmp, data_parallel=False), device="cpu")
    except ValueError as e:
        out["trainer"] = str(e)
    return out


def main(spec_path: str, out_path: str):
    torch.manual_seed(0)
    initialize(device="cpu", timeout_s=120)
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh = make_data_mesh(4)
        out = {"rank": mesh.rank, "world": mesh.world,
               "bn": {name: run_bn(case, mesh) for name, case in spec["bn"].items()},
               "train": run_train(spec["train"], mesh), "search": run_search(spec["search"], mesh),
               "errors": errors(out_path + ".run")}
        torch.save(out, out_path)
    finally:
        destroy()


if __name__ == "__main__":
    main(*sys.argv[1:3])
