"""The port's spatial sharding (``parallel.spatial_shard_forward``) against
the JAX package's and against its own unsharded forward, on the CPU:
gloo ranks (``tests/torch_sharded_ranks.py``, one subprocess each) run
the tiny ADD of tests/test_spatial_shard.py (path [1,2,2,2,3,2], exit at
cell 1, F=2, B=5, 19 classes) on their bands of the image rows.

- World 2 at 65x65: the flagship's odd-size rule (65 → 33 → 17 → 9 → 5
  → 3 rows, the last rank takes the odd row at each level). JAX's
  ``spatial_shard_forward`` refuses an H its mesh does not divide, so
  its recorded answer there is the unsharded ``model.apply``.
- World 4 at 64x65: the JAX test's shape, recorded from JAX's
  ``spatial_shard_forward`` over 4 devices; two ranks hold no level-3
  row (2 rows over 4 ranks), and the level-2 map after cell 5's
  upsample has 3 rows (2 → 3 is not 2:1).

The same ranks run the other cell executions, each a model of its own
from the same parameters: ``flat`` (the cell kernels' plain versions on
the CPU, each DAG block on a window of rows around the band), ``flat-packed``,
``packed`` and ``dense-sep``, and all five executions of the ADD built
with MIXED_GENOTYPE (pools, skip, none and the flat DAG's per-op routes),
held to JAX's unsharded forward at both sizes (JAX's sharded forward of
that model is wrong at 64x65: ROADMAP.md Queue 3).

Every exit's logits against JAX within rtol = atol = 2e-4 (the JAX test's
own bound; every execution computes the same function, so JAX's default
execution is the answer for each), and against the port's unsharded
forward of the same execution within 1e-5·max(1, max|ref|) (fp32: a
band's convs and resizes sum in another order). The JAX side is recorded
in tests/torch_sharded_ref.npz and, for the mixed genotype,
tests/torch_sharded_mixed_ref.npz by scripts/torch_record_sharded_ref.py
(JAX's flat forward is not compiled: it runs the Pallas kernels in
interpret mode for minutes at this size); the inputs are rebuilt here and
checked against the recordings' SHA-256.
"""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.ops import band
from auto_dynamic_deeplab_torch.parallel import spatial_shard_forward
from auto_dynamic_deeplab_torch.parallel.spatial import RowBands, row_bounds
from auto_dynamic_deeplab_tpu.models import ADD as JxADD
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE

from torch_port_helpers import flax_variables, run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
REF_PATH = os.path.join(TESTS, "torch_sharded_ref.npz")
MIXED_REF_PATH = os.path.join(TESTS, "torch_sharded_mixed_ref.npz")
PATH, C_INDEX = [1, 2, 2, 2, 3, 2], [1]
CASES = {"w2": (2, (65, 65), 21), "w4": (4, (64, 65), 22)}  # world, (H, W), seed: the recording's
# max_pool+sep3, skip+dil5, avg_pool+dil3, none+sep5, skip+sep3 (chip_smoke.py's)
MIXED_GENOTYPE = [[0, 1], [1, 4], [2, 3], [3, 7], [5, 2], [8, 6], [11, 0], [13, 5], [18, 3], [19, 4]]
EXECUTIONS = {"flat": dict(flat_eval=True), "flat-packed": dict(flat_eval=True, packed_eval=True),
              "packed": dict(packed_eval=True), "dense-sep": dict(dense_sep_eval=True)}
# label -> (mixed genotype?, model flags): what the ranks run besides the default execution
RUNS = {**{ex: (False, f) for ex, f in EXECUTIONS.items()},
        **{f"mixed/{ex}": (True, f) for ex, f in {"xla": {}, **EXECUTIONS}.items()}}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield np.asarray(v)


def _inputs(name, genotype=AUTODEEPLAB_GENOTYPE, variables=None, **flags):
    _, hw, seed = CASES[name]
    v = variables or flax_variables(JxADD(PATH, C_INDEX, genotype, 19, F=2, B=5), jnp.zeros((1, *hw, 3)),
                                    train=False, seed=seed)
    x = np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)
    model = load_jax_variables(pt_models.ADD(PATH, C_INDEX, genotype, 19, F=2, B=5, **flags), v).eval()
    return x, v, model


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def recorded():
    return {**_load(REF_PATH), **_load(MIXED_REF_PATH)}


def _digest(x, v) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in [x, *_leaves(v)])).hexdigest()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, recorded, tmp_path_factory):
    """The ranks' results on one case, the unsharded forwards and the JAX
    recordings: one set of rank processes runs every execution."""
    name = request.param
    world = CASES[name][0]
    x, v, model = _inputs(name)
    _, vm, _ = _inputs(name, MIXED_GENOTYPE)
    assert _digest(x, v) == str(recorded[f"spatial/{name}/sha256"])
    assert _digest(x, vm) == str(recorded[f"mixed/{name}/sha256"])
    runs, plain_runs = {}, {}
    with torch.no_grad():
        plain = [o.numpy() for o in model(torch.from_numpy(x))]
        for label, (mixed, flags) in RUNS.items():
            genotype = MIXED_GENOTYPE if mixed else AUTODEEPLAB_GENOTYPE
            _, _, m = _inputs(name, genotype, vm if mixed else v, **flags)
            plain_runs[label] = [o.numpy() for o in m(torch.from_numpy(x))]
            runs[label] = (genotype, flags, m.state_dict())
    tmp = tmp_path_factory.mktemp(name)
    torch.save({"state": model.state_dict(), "image": torch.from_numpy(x), "executions": runs}, tmp / "spec.pt")
    run_ranks(world, [os.path.join(TESTS, "torch_sharded_ranks.py"), "spatial", str(tmp / "spec.pt"),
                      str(tmp / "out{rank}.pt")], REPO)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]
    return {"name": name, "world": world, "x": x, "plain": plain, "plain_runs": plain_runs,
            "jax": recorded[f"spatial/{name}/logits"], "jax_mixed": recorded[f"mixed/{name}/logits"],
            "program": str(recorded[f"spatial/{name}/program"]),
            "mixed_program": str(recorded[f"mixed/{name}/program"]), "outs": outs}


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err, bound = float(np.abs(out - ref).max()), tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, (err, bound)


def test_sharded_forward_matches_jax(case):
    """Each rank's gathered logits against the JAX recording, rtol = atol
    = 2e-4 (tests/test_spatial_shard.py's bound)."""
    assert case["program"] == ("model.apply" if case["name"] == "w2" else "spatial_shard_forward")
    for out in case["outs"]:
        assert len(out["whole"]) == len(case["jax"]) == 2
        for got, want in zip(out["whole"], case["jax"]):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_sharded_forward_matches_unsharded(case):
    """Each rank's own rows are its band of the unsharded forward's logits
    (|Δ| ≤ 1e-5·max(1, max|ref|)), from the global image and from its band
    of it alike; rows were exchanged; the gathered logits are equal on
    every rank."""
    h = case["x"].shape[1]
    bounds = row_bounds(h, case["world"], h)
    for out in case["outs"]:
        lo, hi = out["band"]
        assert (lo, hi) == bounds[out["rank"]:out["rank"] + 2]
        assert out["bytes"] > 0
        for e, (rows, ref) in enumerate(zip(out["rows"], case["plain"])):
            assert rows.shape[1] == hi - lo
            _close(rows.numpy(), ref[:, lo:hi], 1e-5)
            assert torch.equal(out["band_input_rows"][e], rows)
            assert torch.equal(out["whole"][e], case["outs"][0]["whole"][e])


@pytest.mark.parametrize("label", sorted(RUNS))
def test_cell_executions_sharded_match_jax(case, label):
    """Each cell execution's gathered logits on every rank against JAX's
    (its default execution: the same function of the same parameters),
    rtol = atol = 2e-4."""
    mixed = label.startswith("mixed/")
    if mixed:  # JAX's spatial_shard_forward of the mixed model is off at w4 (ROADMAP.md Queue 3)
        assert case["mixed_program"] == "model.apply"
    else:
        assert case["program"] == ("model.apply" if case["name"] == "w2" else "spatial_shard_forward")
    for out in case["outs"]:
        got = out["executions"][label]["whole"]
        assert len(got) == 2
        for g, want in zip(got, case["jax_mixed" if mixed else "jax"]):
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("label", sorted(RUNS))
def test_cell_executions_sharded_match_unsharded(case, label):
    """Each cell execution's rows on each rank against its band of the
    same execution's unsharded forward (|Δ| ≤ 1e-5·max(1, max|ref|)); the
    gathered logits are equal on every rank."""
    h = case["x"].shape[1]
    bounds = row_bounds(h, case["world"], h)
    for out in case["outs"]:
        lo, hi = bounds[out["rank"]:out["rank"] + 2]
        run = out["executions"][label]
        assert run["bytes"] > 0
        for e, (rows, ref) in enumerate(zip(run["rows"], case["plain_runs"][label])):
            assert rows.shape[1] == hi - lo
            _close(rows.numpy(), ref[:, lo:hi], 1e-5)
            assert torch.equal(run["whole"][e], case["outs"][0]["executions"][label]["whole"][e])


def test_band_geometry():
    """The split points: the flagship's chain halves exactly at world 2 and
    the last rank takes the odd row; 64 rows over 4 ranks leave two ranks
    without a level-3 row; the input's points are multiples of 4."""
    chain = (1025, 513, 257, 129, 65, 33)
    assert [row_bounds(1025, 2, h) for h in chain] == [(0, 512 >> k, h) for k, h in enumerate(chain)]
    assert row_bounds(64, 4, 2) == (0, 0, 1, 1, 2)
    assert row_bounds(64, 4, 3) == (0, 0, 1, 2, 3)
    for h, w in ((1025, 3), (2049, 4), (65, 2), (9, 4)):
        b = row_bounds(h, w, h)
        assert b[0] == 0 and b[-1] == h and all(p % 4 == 0 for p in b[:-1]) and list(b) == sorted(b)


def test_one_band_needs_no_group():
    """Without a process group the band is the whole image: the same
    logits as the unsharded forward within the fp32 bound, and nothing
    exchanged."""
    x, _, model = _inputs("w2")
    with torch.no_grad():
        plain = model(torch.from_numpy(x))
    fwd = spatial_shard_forward(model)
    outs = fwd(torch.from_numpy(x))
    assert fwd.exchanged_bytes == 0 and RowBands(65).band(33) == (0, 33)
    for got, ref in zip(outs, plain):
        assert type(got) is torch.Tensor
        _close(got.numpy(), ref.numpy(), 1e-5)


def test_unsharded_forward_never_enters_a_band_rule(monkeypatch):
    """Without a band every op takes its plain path: with each band rule
    (the DAG block's too) made to raise, the forward runs and its logits
    are bitwise the same, with the default, the flat and the packed cell
    executions."""
    x, v, model = _inputs("w2")
    models = [model] + [_inputs("w2", variables=v, **EXECUTIONS[ex])[2] for ex in ("flat", "packed")]
    with torch.no_grad():
        before = [m(torch.from_numpy(x)) for m in models]
        with monkeypatch.context() as patch:
            for name in ("conv2d", "max_pool_3x3", "avg_pool_3x3", "shift_up_left", "resize_bilinear", "mean_hw",
                         "broadcast_rows", "wrap", "_fetch", "block_windows"):
                patch.setattr(band, name, lambda *a, **k: pytest.fail("a band rule ran without a band"))
            after = [m(torch.from_numpy(x)) for m in models]
    for b, a in zip(before, after):
        assert all(torch.equal(p, q) for p, q in zip(b, a))


@pytest.mark.parametrize("execution", sorted(EXECUTIONS))
def test_other_cell_executions_run_on_one_band(execution):
    """``spatial_shard_forward`` takes a model of each other cell execution
    (it refused them before they had band rules): without a group, the
    same logits as its unsharded forward within the fp32 bound, nothing
    exchanged."""
    x, _, model = _inputs("w2", **EXECUTIONS[execution])
    with torch.no_grad():
        plain = model(torch.from_numpy(x))
    fwd = spatial_shard_forward(model)
    outs = fwd(torch.from_numpy(x))
    assert fwd.exchanged_bytes == 0
    for got, ref in zip(outs, plain):
        assert type(got) is torch.Tensor
        _close(got.numpy(), ref.numpy(), 1e-5)


def test_an_op_without_a_band_rule_raises():
    """A band fed to an op that reads across rows without a band rule
    (a plain conv, resize or slice) raises instead of computing a wrong
    band."""
    b = band.wrap(torch.randn(1, 2, 5, 4), 5, RowBands(5))
    for op in (lambda t: F.conv2d(t, torch.randn(2, 2, 3, 3), padding=1),
               lambda t: F.interpolate(t, size=(9, 4)), lambda t: t[:, :, 1:]):
        with pytest.raises(ValueError, match="band rule"):
            op(b)
    assert band.shape(F.relu(b) + b) == (1, 2, 5, 4)


@pytest.mark.parametrize("points", [(0, 12, 16, 96, 129), (0, 64, 129)], ids=["starts-0-4-8-88", "halves"])
def test_stems_on_a_window_match_the_whole_image(points):
    """The stems on each rank's band (their plain version on the CPU, as
    K1 on the card): windows from input rows 0, 4, 8 and 88 (the last
    band), the rows past each window's inner edges computed and thrown
    away, against the whole image's s0 and s1 rows."""
    from auto_dynamic_deeplab_torch.kernels.stems import stems_reference
    from auto_dynamic_deeplab_torch.models.decoded import _Stems
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn
    from torch_sharded_ranks import WindowBands

    g = torch.Generator().manual_seed(5)
    stems = randomize_bn(init_params(_Stems(), g), g).eval()
    x = torch.randn(1, 3, 129, 97, generator=g)
    with torch.no_grad():
        s0, s1 = stems_reference(stems, x)
        starts = []
        for rank in range(len(points) - 1):
            bands = WindowBands(129, points, rank, x)
            lo, hi = bands.band(129)
            b0, b1 = stems(band.wrap(x[:, :, lo:hi], 129, bands))
            (a0, e0), (a1, e1) = bands.band(65), bands.band(33)
            _close(band.local(b0).numpy(), s0[:, :, a0:e0].numpy(), 1e-5)
            _close(band.local(b1).numpy(), s1[:, :, a1:e1].numpy(), 1e-5)
            starts.append(max(0, min(4 * a1 - 8, 2 * a0 - 4)) // 4 * 4)
    if len(points) == 5:
        assert starts == [0, 4, 8, 88]


def _cl_state(c, rows, w, g):
    return torch.randn(1, rows, w, c, generator=g).permute(0, 3, 1, 2)  # channels_last


@pytest.mark.parametrize("names", [(n,) for n in sorted(band.ROW_RADIUS)] + [
    ("skip_connect", "dil_conv_5x5"), ("max_pool_3x3", "sep_conv_3x3")], ids="+".join)
def test_dag_block_on_windows_matches_the_whole_map(names):
    """The flat DAG's block rule: each edge kind (a block of one edge, and
    two blocks of two edges on two states) on the windows that
    ``band.block_windows`` fetches for bands from row 0, mid-map and the
    last band of a 33-row map (the plain versions on the CPU, routed as on
    the card), the rows within the block's radius of an inner edge
    computed and thrown away, against the whole map's rows
    (1e-5·max(1, max|ref|)); with one row less of halo the mid band's rows
    are wrong."""
    from auto_dynamic_deeplab_torch.kernels import cell_ops
    from auto_dynamic_deeplab_torch.ops.primitives import OPS
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn
    from torch_sharded_ranks import WindowBands

    c, rows, w, points = 8, 33, 21, (0, 5, 19, 33)
    g = torch.Generator().manual_seed(11)
    ops = [randomize_bn(init_params(OPS[n](c, 1), g), g).eval() for n in names]
    xs = [_cl_state(c, rows, w, g) for _ in names]
    radius = max(band.ROW_RADIUS[n] for n in names)
    with torch.no_grad():
        whole = torch.empty(1, c, rows, w)
        cell_ops._run_block(xs, names, ops, whole)
        for rank in range(len(points) - 1):
            bands = WindowBands(rows, points, rank, xs)
            lo, hi = bands.band(rows)
            wins, start = band.block_windows([x[:, :, lo:hi] for x in xs], rows, bands, names)
            assert start == lo - max(0, lo - radius)
            assert wins[0].shape[2] == min(rows, hi + radius) - max(0, lo - radius)
            dst = torch.empty(1, c, hi - lo, w)
            cell_ops._run_block(wins, names, ops, dst, start)
            _close(dst.numpy(), whole[:, :, lo:hi].numpy(), 1e-5)
            if rank == 1 and radius > 0:
                short = [x[:, :, lo - radius + 1:hi + radius - 1] for x in xs]
                cell_ops._run_block(short, names, ops, dst, radius - 1)
                assert (dst - whole[:, :, lo:hi]).abs().max() > 1e-3


def test_fetched_window_of_a_channels_last_band_is_channels_last():
    """``RowBands.fetch`` keeps a channels_last band channels_last (the cell
    kernels take nothing else), a channel slice of a channels_last buffer
    too, and fills past the global edges; an NCHW-contiguous band stays
    NCHW-contiguous."""
    g = torch.Generator().manual_seed(3)
    buf = _cl_state(12, 9, 7, g)
    bands = RowBands(9)
    for x in (buf, buf[:, 4:10]):
        win = bands.fetch(x, 9, 2, lambda r: (-2, 11), 0.0)
        assert win.shape == (1, x.shape[1], 13, 7) and win.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(win[:, :, 2:11], x) and not win[:, :, :2].any() and not win[:, :, 11:].any()
        own = bands.fetch(x, 9, 2, lambda r: (0, 9), 0.0)  # the band itself: no copy
        assert (own.data_ptr(), own.shape, own.stride()) == (x.data_ptr(), x.shape, x.stride())
    plain = buf.contiguous()
    win = bands.fetch(plain, 9, 2, lambda r: (-1, 9), 1.0)
    assert win.is_contiguous() and torch.equal(win[:, :, 1:], plain) and bool((win[:, :, 0] == 1).all())
