"""One rank of tests/test_torch_spatial.py and
tests/test_torch_tensor_parallel.py, on the CPU over gloo (no jax here:
only the port and torch).

    WORLD_SIZE=w RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_sharded_ranks.py {spatial|tp} SPEC OUT

SPEC (``torch.save``, written by the test) holds the model's state and
the inputs; this rank ``torch.save``s what it got to OUT, whose
``{rank}`` becomes its rank:

- ``spatial``: ``spatial_shard_forward`` over the whole group: this rank's
  rows of each exit's logits, the logits gathered whole, the bytes it
  received and its band of the input; then, for each model of SPEC's
  ``executions`` (label -> genotype, model flags, state), its rows, the
  bytes and the gathered logits;
- ``tp``: ``shard_train_state`` over ``make_mesh(2, 2)``, the round trip
  of ``gather_train_state`` before the step, one ``make_tp_train_step``
  step on the global batch, the whole state after it, the count of
  sharded parameters, and what the mesh and the step say of a world that
  the mesh does not match and of a batch the data axis does not divide.

``WindowBands`` stands in for ``parallel.spatial.RowBands`` in one process
that holds the whole tensor (the stems' window tests, on the CPU and the
card).
"""
import sys

import torch
import torch.distributed as dist

from auto_dynamic_deeplab_torch import models
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_torch.parallel import (
    DataMesh,
    destroy,
    gather_train_state,
    initialize,
    make_mesh,
    make_tp_train_step,
    shard_train_state,
    spatial_shard_forward,
)
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
from auto_dynamic_deeplab_torch.train.step import make_optimizer

PATH, C_INDEX = [1, 2, 2, 2, 3, 2], [1]


class WindowBands:
    """Rank ``rank`` of a row split at input rows ``points`` (p_0 = 0, the
    last = ``height``; a tensor of h rows splits at p·h // height, as
    ``row_bounds`` does), in one process: ``fetch`` cuts the rows it is
    asked for out of ``whole`` (the whole tensor; or a list of them, of
    which the one that holds the band asked about), ``fill`` outside it,
    channels_last where the whole tensor is, as ``RowBands.fetch``."""

    def __init__(self, height, points, rank, whole):
        self.height, self.points, self.rank, self.whole = height, points, rank, whole
        self.world = len(points) - 1

    def bounds(self, rows):
        return tuple(p * rows // self.height for p in self.points[:-1]) + (rows,)

    def band(self, rows, rank=None):
        b = self.bounds(rows)
        r = self.rank if rank is None else rank
        return b[r], b[r + 1]

    def fetch(self, x, rows, dim, window, fill):
        lo, hi = window(self.rank)
        whole = self.whole
        if isinstance(whole, (list, tuple)):
            whole = next(w for w in whole if w.untyped_storage().data_ptr() == x.untyped_storage().data_ptr())
        last = dim == 2 and whole.dim() == 4 and whole.shape[1] > 1 and whole.stride(1) == 1
        if last:
            whole, dim = whole.permute(0, 2, 3, 1), 1
        shape = list(whole.shape)
        shape[dim] = hi - lo
        out = whole.new_full(shape, fill)
        a, b = max(lo, 0), min(hi, rows)
        if a < b:
            out.narrow(dim, a - lo, b - a).copy_(whole.narrow(dim, a, b - a))
        return out.permute(0, 3, 1, 2) if last else out


def _model(ncls, genotype=AUTODEEPLAB_GENOTYPE, **kw):
    return models.ADD(PATH, C_INDEX, genotype, ncls, F=2, B=5, **kw)


def run_spatial(spec):
    model = _model(19)
    model.load_state_dict(spec["state"])
    mesh = DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    fwd = spatial_shard_forward(model, mesh)
    x = spec["image"]
    height = x.shape[1]
    outs = fwd(x)
    lo, hi = fwd.bands(height).band(height)
    out = {"rank": mesh.rank, "band": (lo, hi), "rows": outs, "bytes": fwd.exchanged_bytes,
           "whole": fwd.gather(outs, height), "band_input_rows": fwd(x[:, lo:hi], height=height),
           "executions": {}}
    # the other cell executions (and genotypes), each a model of its own
    for label, (genotype, flags, state) in spec.get("executions", {}).items():
        model = _model(19, genotype, **flags)
        model.load_state_dict(state)
        fwd = spatial_shard_forward(model, mesh)
        outs = fwd(x)
        out["executions"][label] = {"rows": outs, "bytes": fwd.exchanged_bytes, "whole": fwd.gather(outs, height)}
    return out


def run_tp(spec):
    out = {"errors": {}}
    try:
        make_mesh(3, 2)
    except ValueError as e:
        out["errors"]["make_mesh"] = str(e)
    model = _model(19, low_level_layer=0)
    model.load_state_dict(spec["state"])
    optimizer = make_optimizer(model.parameters(), weight_decay=4e-5)
    mesh = make_mesh(2, 2)
    shard_train_state(model, optimizer, mesh)
    back = gather_train_state(model, optimizer)["model"]
    out["round_trip_bitwise"] = all(torch.equal(back[k], v) for k, v in spec["state"].items()) and \
        set(back) == set(spec["state"])
    out["sharded_params"] = sum(p.numel() < back[n].numel() for n, p in model.named_parameters())
    step = make_tp_train_step(model, optimizer, lr_schedule("poly", 0.05, 10, 4), mesh)
    try:
        step(spec["image"][:3], spec["label"][:3])
    except ValueError as e:
        out["errors"]["batch"] = str(e)
    out["loss"] = step(spec["image"], spec["label"]).item()
    out["sharded_after"] = sum(p.numel() < back[n].numel() for n, p in model.named_parameters())
    out["state"] = gather_train_state(model, optimizer)
    out["mesh"] = (mesh.d, mesh.m)
    return out


def main(mode: str, spec_path: str, out_path: str):
    torch.manual_seed(0)
    initialize(device="cpu", timeout_s=120)
    try:
        spec = torch.load(spec_path, weights_only=False)
        torch.save({"spatial": run_spatial, "tp": run_tp}[mode](spec), out_path.format(rank=dist.get_rank()))
    finally:
        destroy()


if __name__ == "__main__":
    main(*sys.argv[1:4])
