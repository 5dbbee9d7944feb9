"""The port's data-parallel modes against the JAX package's, on the CPU:
two gloo ranks (``tests/torch_parallel_ranks.py``, one subprocess each)
against JAX's ``shard_map`` programs over two of the conftest's virtual
CPU devices, on the same global batches; then the CLIs under torchrun.

- Cross-replica BatchNorm (C=6) at 2x5x7 and at 1x1x1 rows a rank (n = 1
  per rank): output rows, the input gradient of sum(y·w) and the running
  statistics against JAX ``BatchNorm(axis_name=...)`` under shard_map,
  run here. fp32, |Δ| ≤ 1e-5·max(1, max|ref|); statistics ≤ 1e-5
  relative.
- One ``TrainStep`` of the tiny ADD (path [1,2,2,2,3,2], F=2, 7 classes,
  33x33, global batch 4) with its BNs over the group against JAX
  ``make_train_step`` over a 2-device mesh; one weight step and one arch
  step of the tiny ModelNetSearch (4 layers, F=2, B=2, 65x65, batch 4)
  against JAX ``make_search_steps(mesh=...)``. The labels put 255 on most
  of rank 0's pixels and few of rank 1's, so the mean of the ranks' losses
  (JAX's ``pmean``) and the global batch's mean differ by far more than
  the tolerances. Losses ≤ 1e-5 relative; gradients ≤ 1e-4 (L2,
  relative: the train step's from seeded Gaussian sketches of every
  tensor and from its small tensors whole); BN statistics ≤ 1e-4
  relative per tensor. The JAX side is recorded in
  tests/torch_parallel_ref.npz by scripts/torch_record_parallel_ref.py
  (its compiles take minutes); the inputs are rebuilt here and checked
  against the recording's SHA-256.
"""
import hashlib
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import _to_torch_layout, load_jax_variables
from auto_dynamic_deeplab_torch.parallel import DataMesh, data_shard, initialize, make_data_mesh, shard_batch
from auto_dynamic_deeplab_torch.train.loss import multi_exit_cross_entropy
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.data import SyntheticSegmentation as JxSynthetic
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.ops.norm import BatchNorm as JxBatchNorm

from torch_port_helpers import flax_variables, nchw, nhwc_np, rel_err

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
REF_PATH = os.path.join(TESTS, "torch_parallel_ref.npz")
TRAIN = dict(path=[1, 2, 2, 2, 3, 2], c_index=[1], ncls=7, F=2, hw=(33, 33), seed=11, lr=0.02)
SEARCH = dict(ncls=5, hw=(65, 65), genotype=((1, 6), (0, 3), (4, 5), (2, 1)), seed=3)
WD, SEARCH_WD, ARCH_WD, SKETCH = 4e-5, 8e-4, 1e-3, 8
BN_SHAPES = {"n70": (4, 5, 7, 6), "n1": (2, 1, 1, 6)}  # global NHWC; each rank takes half
RANK_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(name, None)
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), **extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_all(procs, timeout=RANK_TIMEOUT_S):
    """Wait for every process (each within ``timeout``); kill the rest if
    one fails or hangs. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def uneven_batch(n, hw, ncls, seed):
    """scripts/torch_record_parallel_ref.py's batch: 255 on most of the
    first half's pixels and a few of the second half's."""
    items = [JxSynthetic(n, hw, ncls, seed=seed)[i] for i in range(n)]
    image = np.stack([s["image"] for s in items])
    label = np.stack([s["label"] for s in items]).astype(np.int32)
    label[: n // 2, : hw[0] * 3 // 4] = 255
    label[n // 2:, :2, :3] = 255
    return image, label


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _sha256(*arrays) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


def _tree(rec, prefix, flax_layout=True) -> dict:
    """{port name: float64 array} of a tree recorded under ``prefix``, with
    flax's kernel layouts turned into the port's where it has them."""
    data, out, at = rec[f"{prefix}:data"], {}, 0
    for path, shape in json.loads(str(rec[f"{prefix}:index"])):
        n = int(np.prod(shape))
        name = path.replace("/", ".")
        a = data[at:at + n].reshape(shape).astype(np.float64)
        out[name] = _to_torch_layout(name, a) if flax_layout else a
        at += n
    return out


def _sketch(t: int, g: np.ndarray) -> np.ndarray:
    r = np.random.RandomState(1000 + t).standard_normal((SKETCH, g.size))
    return r @ np.asarray(g, np.float64).ravel()


def _bn_case(name):
    shape = BN_SHAPES[name]
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) * 2.0 + 0.5
    w = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.3, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    return x, w, variables


def _jax_bn(name):
    """JAX's cross-replica BN over 2 devices: (y, dx, stats)."""
    x, w, variables = _bn_case(name)
    bn = JxBatchNorm(axis_name="data")

    def body(xs):
        y, upd = bn.apply(variables, xs, True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    fn = jax.shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=(P("data"), P()), check_vma=False)
    y, stats = fn(jnp.asarray(x))
    dx = jax.grad(lambda xs: jnp.sum(fn(xs)[0] * w))(jnp.asarray(x))
    return np.asarray(y), np.asarray(dx), jax.device_get(stats)


@pytest.fixture(scope="module")
def recorded():
    with np.load(REF_PATH) as z:
        return {k: z[k] for k in z.files}


def _train_inputs():
    jm = jx_models.ADD(TRAIN["path"], TRAIN["c_index"], AUTODEEPLAB_GENOTYPE, TRAIN["ncls"], F=TRAIN["F"], B=5,
                       axis_name="data")
    v = flax_variables(jm, jnp.zeros((1, *TRAIN["hw"], 3)), train=False, seed=TRAIN["seed"])
    image, label = uneven_batch(4, TRAIN["hw"], TRAIN["ncls"], seed=0)
    model = load_jax_variables(pt_models.ADD(TRAIN["path"], TRAIN["c_index"], AUTODEEPLAB_GENOTYPE, TRAIN["ncls"],
                                             F=TRAIN["F"], B=5), v)
    return v, image, label, model


def _search_inputs():
    jm = jx_models.ModelNetSearch(SEARCH["ncls"], SEARCH["genotype"], C_index=(2,), num_layers=4, F=2, B=2,
                                  remat=False, axis_name="data")
    v = flax_variables(jm, jnp.zeros((1, *SEARCH["hw"], 3)), train=True, seed=SEARCH["seed"])
    image, label = uneven_batch(4, SEARCH["hw"], SEARCH["ncls"], seed=1)
    model = load_jax_variables(pt_models.ModelNetSearch(SEARCH["ncls"], SEARCH["genotype"], C_index=(2,),
                                                        num_layers=4, F=2, B=2, remat=False), v)
    return v, image, label, model


@pytest.fixture(scope="module")
def ranks(recorded, tmp_path_factory):
    """Both ranks' results on the cases of tests/torch_parallel_ranks.py,
    and the inputs they ran on."""
    tmp = tmp_path_factory.mktemp("ranks")
    tv, timage, tlabel, tmodel = _train_inputs()
    sv, simage, slabel, smodel = _search_inputs()
    assert _sha256(timage, tlabel, *[a for _, a in _leaves(tv)]) == str(recorded["train/sha256"])
    assert _sha256(simage, slabel, *[a for _, a in _leaves(sv)]) == str(recorded["search/sha256"])
    spec = {"bn": {}, "train": {"args": (TRAIN["path"], TRAIN["c_index"]), "ncls": TRAIN["ncls"], "F": TRAIN["F"],
                                "lr": TRAIN["lr"], "state": tmodel.state_dict(),
                                "image": torch.from_numpy(timage), "label": torch.from_numpy(tlabel)},
            "search": {"ncls": SEARCH["ncls"], "genotype": SEARCH["genotype"], "state": smodel.state_dict(),
                       "image": torch.from_numpy(simage), "label": torch.from_numpy(slabel)}}
    for name in BN_SHAPES:
        x, w, variables = _bn_case(name)
        bn_state = {"scale": variables["params"]["scale"], "bias": variables["params"]["bias"],
                    "mean": variables["batch_stats"]["mean"], "var": variables["batch_stats"]["var"]}
        spec["bn"][name] = {"x": nchw(x), "w": nchw(w), "state": {k: torch.from_numpy(v) for k, v in bn_state.items()}}
    torch.save(spec, tmp / "spec.pt")
    env = _env(WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, "torch_parallel_ranks.py"), str(tmp / "spec.pt"),
                               str(tmp / f"rank{r}.pt")], env={**env, "RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    _run_all(procs)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"spec": spec, "outs": outs, "train": (tv, timage, tlabel, tmodel), "search": (sv, simage, slabel, smodel)}


def _assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = float(np.abs(out - ref).max()), tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("name", sorted(BN_SHAPES))
def test_cross_replica_batchnorm_matches_jax(ranks, name):
    """Output and statistics against JAX's shard_map BN. The input gradient
    too at 2x5x7 rows a rank; at one row a rank each channel normalizes
    two values, and its input gradient, eps/(2|d|³)-sized for values d
    apart, is the difference of near-equal terms (JAX's own fp32 gradient
    is 1.6e-5 off the float64 one, 0.9% of its largest value): there both
    are held to the float64 gradient, the port within twice JAX's error."""
    y, dx, stats = _jax_bn(name)
    dx64 = _f64_bn(name)[1]
    jax_err = float(np.abs(dx - dx64).max())
    for out in ranks["outs"]:
        got = out["bn"][name]
        rows = slice(out["rank"] * y.shape[0] // 2, (out["rank"] + 1) * y.shape[0] // 2)
        _assert_close(nhwc_np(got["y"]), y[rows], 1e-5, "y")
        if name == "n1":
            err = float(np.abs(nhwc_np(got["dx"]) - dx64[rows]).max())
            assert err <= 2.0 * jax_err, (err, jax_err)
        else:
            _assert_close(nhwc_np(got["dx"]), dx[rows], 1e-5, "dx")
        for k in ("mean", "var"):
            assert rel_err(got[k].numpy(), stats[k]) <= 1e-5, k


def _f64_bn(name):
    """The global batch's BN in float64 (one process: the cross-replica
    statistics of equal shards are the global batch's): (y, dx)."""
    x, w, variables = _bn_case(name)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    p = {k: torch.from_numpy(v).double() for k, v in variables["params"].items()}
    mean = xt.mean(dim=(0, 1, 2))
    var = ((xt - mean) ** 2).mean(dim=(0, 1, 2))
    y = (xt - mean) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]
    (y * torch.from_numpy(w).double()).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _l2_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_train_step_at_two_ranks_matches_jax(ranks, recorded):
    """Loss, gradient (sketched) and BN statistics of one step at W = 2
    against JAX's 2-device ``make_train_step``; the two ranks end bitwise
    equal; and the data is such that the global batch's mean loss would
    fail the loss check."""
    tv, image, label, model = ranks["train"]
    want_loss = float(recorded["train/loss"])
    p0 = {k: p.detach().double().numpy() for k, p in model.named_parameters()}
    names = json.loads(str(recorded["train/grad_names"]))
    full = _tree(recorded, "train/grad_full", flax_layout=False)  # recorded in the port's layout
    stats = _tree(recorded, "train/stats")
    for out in ranks["outs"]:
        got = out["train"]
        assert abs(got["loss"] - want_loss) <= 1e-5 * want_loss, (got["loss"], want_loss)
        decayed = {k: got["grads"][k].double().numpy() + WD * p0[k] for k in names}
        sketches = np.stack([_sketch(t, decayed[k]) for t, k in enumerate(names)])
        assert _l2_rel(sketches, recorded["train/grad_sketch"]) <= 1e-4
        assert _l2_rel(np.concatenate([decayed[k].ravel() for k in full]),
                       np.concatenate([full[k].ravel() for k in full])) <= 1e-4
        for k, want in stats.items():
            assert rel_err(got["state"][k].numpy(), want) <= 1e-4, k
    a, b = (out["train"]["state"] for out in ranks["outs"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    # one process on the whole batch: the global pixel mean is not JAX's mean of the shards' means
    with torch.no_grad():
        outs = model.train()(torch.from_numpy(image), class_leading=True)
        global_loss = multi_exit_cross_entropy(outs, torch.from_numpy(label)).item()
    assert abs(global_loss - want_loss) > 1e-3 * want_loss, (global_loss, want_loss)


@pytest.mark.parametrize("which,collection,decay", [("weight", "params", SEARCH_WD), ("arch", "arch", ARCH_WD)])
def test_search_steps_at_two_ranks_match_jax(ranks, recorded, which, collection, decay):
    """ModelNetSearch's weight step (mean loss) and arch step (summed) at
    W = 2 against JAX's ``make_search_steps`` over a 2-device mesh."""
    sv = ranks["search"][0]
    p0 = {k.replace("/", "."): _to_torch_layout(k.replace("/", "."), np.asarray(a, np.float64))
          for k, a in _leaves(sv[collection])}
    decayed = _tree(recorded, f"search/{which}/decayed")
    want = {k: g - decay * p0[k] for k, g in decayed.items()}
    stats = _tree(recorded, f"search/{which}/stats")
    want_loss = float(recorded[f"search/{which}/loss"])
    for out in ranks["outs"]:
        got = out["search"][which]
        assert abs(got["loss"] - want_loss) <= 1e-5 * want_loss
        assert set(got["grads"]) == set(want)
        grads = {k: got["grads"][k].double().numpy() for k in want}
        assert _l2_rel(np.concatenate([grads[k].ravel() for k in want]),
                       np.concatenate([want[k].ravel() for k in want])) <= 1e-4
        for k, w in stats.items():
            assert rel_err(got["state"][k].numpy(), w) <= 1e-4, k
    a, b = (out["search"][which]["state"] for out in ranks["outs"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_no_process_group_is_one_device(monkeypatch):
    """Without an address ``initialize`` does nothing; there is no mesh."""
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert initialize(device="cpu") == (0, 1) and data_shard() == (0, 1)
    assert make_data_mesh(4) is None


def test_data_mesh_rows_and_their_errors():
    mesh = DataMesh(None, 1, 2)
    batch = {"image": np.arange(8).reshape(4, 2), "label": np.arange(4)}
    assert shard_batch(batch, mesh)["label"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(3)


def test_make_data_mesh_and_trainer_refuse_at_two_ranks(ranks):
    """Recorded by the ranks: a global batch of 3 over 2 ranks, and the
    single-device trainer under the 2-rank group."""
    for out in ranks["outs"]:
        assert out["world"] == 2
        assert "needs a global batch that 2 divides, got 3" in out["errors"]["make_data_mesh"]
        assert "data_parallel=False" in out["errors"]["trainer"]


@pytest.mark.parametrize("cli", ["train", "search"])
def test_clis_under_torchrun(tmp_path, cli):
    """``cli.train --sync-bn`` and ``cli.search`` (data-parallel: no
    --no-dp) as two gloo ranks under torchrun; rank 0 alone writes the
    run directory, and both ranks print the same result."""
    common = ["--device", "cpu", "--run-dir", str(tmp_path), "--epochs", "1", "--eval-interval", "1",
              "--workers", "1"]
    if cli == "train":
        argv = ["--sync-bn", "--F", "2", "--synthetic-crop", "33", "33", "--synthetic-length", "8",
                "--batch-size", "4", "--test-batch-size", "1"]
    else:
        argv = ["--num-layers", "4", "--exit-layers", "2", "--F", "2", "--B", "2", "--batch-size", "4",
                "--synthetic-crop", "65", "65", "--synthetic-length", "8", "--alpha-epoch", "0"]
    env = _env()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
           env["MASTER_PORT"], "--tee", "1", "-m", f"auto_dynamic_deeplab_torch.cli.{cli}", *common, *argv]
    out = _run_all([subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)])[0]
    if cli == "train":
        results = [json.loads(line.split("]:", 1)[1]) for line in out.splitlines() if "]:{" in line]
        assert len(results) == 2 and results[0] == results[1], out[-3000:]
        assert np.isfinite(results[0]["train_loss"])
    else:
        paths = [line.split("]:", 1)[1] for line in out.splitlines() if "decoded path" in line]
        assert len(paths) == 2 and paths[0] == paths[1], out[-3000:]
    runs = [d for d in (tmp_path / "synthetic").glob("*/experiment_*")]
    assert len(runs) == 1 and (runs[0] / "checkpoint").exists(), runs

