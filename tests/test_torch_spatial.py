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

Every exit's logits against JAX within rtol = atol = 2e-4 (the JAX test's
own bound), and against the port's unsharded forward within
1e-5·max(1, max|ref|) (fp32: a band's convs and resizes sum in another
order). The JAX side is recorded in tests/torch_sharded_ref.npz by
scripts/torch_record_sharded_ref.py; the inputs are rebuilt here and
checked against the recording's SHA-256.
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
PATH, C_INDEX = [1, 2, 2, 2, 3, 2], [1]
CASES = {"w2": (2, (65, 65), 21), "w4": (4, (64, 65), 22)}  # world, (H, W), seed: the recording's


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield np.asarray(v)


def _inputs(name):
    _, hw, seed = CASES[name]
    v = flax_variables(JxADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5), jnp.zeros((1, *hw, 3)),
                       train=False, seed=seed)
    x = np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)
    model = load_jax_variables(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5), v).eval()
    return x, v, model


@pytest.fixture(scope="module")
def recorded():
    with np.load(REF_PATH) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, recorded, tmp_path_factory):
    """The ranks' results on one case, the unsharded forward and the JAX
    recording."""
    name = request.param
    world = CASES[name][0]
    x, v, model = _inputs(name)
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in [x, *_leaves(v)])).hexdigest()
    assert digest == str(recorded[f"spatial/{name}/sha256"])
    with torch.no_grad():
        plain = [o.numpy() for o in model(torch.from_numpy(x))]
    tmp = tmp_path_factory.mktemp(name)
    torch.save({"state": model.state_dict(), "image": torch.from_numpy(x)}, tmp / "spec.pt")
    run_ranks(world, [os.path.join(TESTS, "torch_sharded_ranks.py"), "spatial", str(tmp / "spec.pt"),
                      str(tmp / "out{rank}.pt")], REPO)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]
    return {"name": name, "world": world, "x": x, "plain": plain, "jax": recorded[f"spatial/{name}/logits"],
            "program": str(recorded[f"spatial/{name}/program"]), "outs": outs}


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
    made to raise, the forward runs and its logits are bitwise the same."""
    x, _, model = _inputs("w2")
    with torch.no_grad():
        before = model(torch.from_numpy(x))
        for name in ("conv2d", "max_pool_3x3", "avg_pool_3x3", "shift_up_left", "resize_bilinear", "mean_hw",
                     "broadcast_rows", "wrap", "_fetch"):
            monkeypatch.setattr(band, name, lambda *a, **k: pytest.fail("a band rule ran without a band"))
        after = model(torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("flags", [dict(flat_eval=True), dict(packed_eval=True), dict(dense_sep_eval=True)],
                         ids=["flat", "packed", "dense-sep"])
def test_other_cell_executions_are_refused(flags):
    model = pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, 19, F=2, B=5, **flags)
    with pytest.raises(ValueError, match="default cell execution"):
        spatial_shard_forward(model)


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
