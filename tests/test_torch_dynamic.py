"""The port's dynamic modes (``infer_fused``, ``infer_batch``), its trained
weights reader, the beacon task and the NAS decoder against the JAX
package, on the CPU.

Sizes: the tiny ADD of tests/test_torch_model.py (path [1,2,2,2,3,2], F=4,
B=5, 7 classes, 33x65) with 2 exits, and its 3-exit variant; the trained
flagship topology (F=8, 7 classes) at 321x321 on 2 of its 32 validation
images. Tolerances: exit indices exact; confidences |Δ| ≤ 1e-4; logits
|Δ| ≤ 1e-3·max|ref| (the golden-test tolerance); the reader bitwise; the
decoder and the beacon copy exactly equal.
"""
import importlib.util
import json
import pathlib

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.cli import decode as pt_cli_decode
from auto_dynamic_deeplab_torch.data import beacon
from auto_dynamic_deeplab_torch.nas import decode as pt_decode
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine as PtEngine
from auto_dynamic_deeplab_torch.utils.restore import load_flax_msgpack, load_product_proof
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.cli import decode as jx_cli_decode
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
from auto_dynamic_deeplab_tpu.nas import decode as jx_decode
from auto_dynamic_deeplab_tpu.train.dynamic import DynamicInferenceEngine as JxEngine

from torch_port_helpers import assert_close_fp32_model, flax_variables, jx, port_module

REPO = pathlib.Path(__file__).resolve().parents[1]
ART = REPO / "artifacts" / "product_proof"
PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)
THREE_PATH, THREE_C_INDEX = [0, 1, 2, 3, 2, 2], [0, 3]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _models(path, c_index, seed):
    jm = jx_models.ADD(path, c_index, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=seed)
    pm = port_module(pt_models.ADD(path, c_index, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v)
    return jm, v, pm


@pytest.fixture(scope="module")
def two_exits():
    """JAX and port engines of the tiny 2-exit ADD, with an EDM."""
    jm, v, pm = _models(PATH, C_INDEX, seed=5)
    c_feat = pm.feature_channels(pm.exit_layers[0])
    jedm = jx_models.EDM()
    ev = flax_variables(jedm, jnp.zeros((1, 9, 17, c_feat)), seed=8)
    pedm = port_module(pt_models.EDM(c_feat), ev)
    return (JxEngine(jm, v, edm=jedm, edm_variables=ev, num_classes=NCLS),
            PtEngine(pm, edm=pedm, num_classes=NCLS, device="cpu"))


@pytest.fixture(scope="module")
def three_exits():
    """JAX and port engines of the 3-exit ADD (exits at levels 0 and 3 and
    the final one)."""
    jm, v, pm = _models(THREE_PATH, THREE_C_INDEX, seed=7)
    return JxEngine(jm, v, num_classes=NCLS), PtEngine(pm, num_classes=NCLS, device="cpu")


def _check_fused(engines, x, thr, confidence, want_exit):
    jeng, peng = engines
    l_r, k_r, _, c_r = jeng.infer_fused(jx(x), threshold=thr, confidence=confidence)
    logits, k, dt, c = peng.infer_fused(torch.from_numpy(x), threshold=thr, confidence=confidence)
    assert k == k_r == want_exit
    assert abs(c - c_r) <= 1e-4 and dt > 0
    assert logits.shape == (1, NCLS, *HW)
    assert_close_fp32_model(logits.numpy(), l_r)


# (confidence, threshold, exit): each signal exits at exit 0 and runs to the end
@pytest.mark.parametrize("confidence,thr,want_exit", [
    ("entropy", 2.0, 0), ("entropy", -1.0, 1), ("edm", 1e9, 0), ("edm", -1e9, 1),
])
def test_infer_fused_matches_jax(two_exits, confidence, thr, want_exit):
    """One JAX program (a lax.cond chain) against the port's segments; the
    JAX program takes the threshold at run time, so each signal compiles
    once."""
    _check_fused(two_exits, _x((1, *HW, 3), seed=4), thr, confidence, want_exit)


# the 3-exit model's input: entropy 0.258 at exit 0, 0.079 at exit 1; the
# confidence returned is the first decision's at every exit
@pytest.mark.parametrize("thr,want_exit", [(2.0, 0), (0.2, 1), (-1.0, 2)])
def test_infer_fused_matches_jax_at_three_exits(three_exits, thr, want_exit):
    _check_fused(three_exits, _x((1, *HW, 3), seed=6), thr, "entropy", want_exit)


def test_infer_fused_keeps_one_program_per_size(two_exits):
    """The program is kept by (size, confidence), as JAX keys it: a new
    threshold reuses it."""
    peng = two_exits[1]
    x = torch.from_numpy(_x((1, *HW, 3), seed=4))
    peng.infer_fused(x, 0.1, "max")
    programs = dict(peng._programs)
    peng.infer_fused(x, 0.9, "max")
    assert peng._programs == programs and ("fused", HW, "max") in programs
    with pytest.raises(ValueError, match="one"):
        peng.infer_fused(torch.zeros(2, *HW, 3), 0.5, "max")


def test_infer_batch_matches_jax(two_exits):
    """A batch of 3 whose first image exits at exit 0 (a threshold between
    the images' exit-0 entropies), so the other two are compacted into
    bucket 2 before the final segment."""
    jeng, peng = two_exits
    x = _x((3, *HW, 3), seed=11) * np.float32([2.0, 1.0, 0.5])[:, None, None, None]
    ents = [peng.infer_fused(torch.from_numpy(x[i:i + 1]), 0.0, "entropy")[3] for i in range(3)]
    assert ents[0] < min(ents[1:]) - 1e-3, ents
    thr = (ents[0] + min(ents[1:])) / 2
    l_r, k_r = jeng.infer_batch(jx(x), threshold=thr, confidence="entropy")
    logits, k = peng.infer_batch(torch.from_numpy(x), threshold=thr, confidence="entropy")
    assert k.dtype == torch.int64 and k.tolist() == list(k_r) == [0, 1, 1]
    assert logits.dtype == torch.float32 and logits.shape == (3, NCLS, *HW)
    for i in range(3):
        assert_close_fp32_model(logits[i].numpy(), l_r[i])


def test_infer_batch_at_three_exits_matches_per_image(three_exits):
    """Four images: the first exits at exit 0, so three go on in bucket 4
    with the last one repeated as its pad row. That image exits at exit 1,
    pad row and all, and the second goes on to exit 2. The JAX loop reads
    the pad row as a fourth image there and indexes past its list (an
    IndexError); the port reads only the real rows. Entropies at exits 0
    and 1: (0.125, 0.024), (0.363, 0.144), (0.355, 0.084), (0.312, 0.105)."""
    peng = three_exits[1]
    x = _x((4, *HW, 3), seed=12) * np.float32([4.0, 0.25, 0.5, 1.0])[:, None, None, None]
    logits, k = peng.infer_batch(torch.from_numpy(x), threshold=0.13, confidence="entropy")
    assert k.tolist() == [0, 2, 1, 1]
    for i in range(4):
        want, k_want, _, _ = peng.infer(torch.from_numpy(x[i:i + 1]), 0.13, "entropy")
        assert int(k[i]) == k_want
        assert_close_fp32_model(logits[i].numpy(), want[0].numpy())


# -------------------------------------------------------- trained weights


@pytest.fixture(scope="module")
def trained():
    """The trained artifacts through the port's reader, and the recorded
    JAX-CPU oracle."""
    backbone, edm, meta = load_product_proof(ART)
    ref = json.loads((REPO / "tests" / "torch_product_proof_ref.json").read_text())
    return backbone, edm, meta, ref


@pytest.mark.parametrize("name", ["backbone", "edm"])
def test_flax_msgpack_reader_matches_flax(trained, name):
    raw = (ART / f"{name}.msgpack").read_bytes()
    ref = fser.msgpack_restore(raw)
    out = trained[0] if name == "backbone" else trained[1]
    assert sorted(out) == (["batch_stats", "params"] if name == "backbone" else ["params"])

    def walk(a, b, path=""):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in a:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{path}/{k}"
                assert np.array_equal(a[k], b[k]), f"{path}/{k}"

    walk(out, ref)
    assert load_flax_msgpack(raw).keys() == out.keys()


def test_flax_msgpack_reader_rejects_other_ext_types():
    # fixext 1 of type 2 (flax's complex): not in the trained files' subset
    with pytest.raises(ValueError, match="ext type 2"):
        load_flax_msgpack(bytes([0x81, 0xA1, 0x61, 0xD4, 0x02, 0x00]))
    with pytest.raises(ValueError, match="truncated"):
        load_flax_msgpack(bytes([0x81, 0xA1, 0x61, 0xC4, 0x05, 0x00]))


def _trained_port(trained):
    backbone, edm_vars, meta, _ = trained
    m = meta["model"]
    cfg = NETWORK_ARCH[m["network_arch"]]
    model = pt_models.ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, m["num_classes"], F=m["F"],
                          B=m["B"], low_level_layer=cfg["low_level_layer"])
    load_jax_variables(model, backbone)  # raises on a missing or unused key
    edm = load_jax_variables(pt_models.EDM(model.feature_channels(model.exit_layers[0])), edm_vars)
    return PtEngine(model, edm=edm, num_classes=m["num_classes"], device="cpu")


def test_trained_weights_match_the_jax_oracle(trained):
    """The first two validation images (one each side of the threshold):
    the EDM's exit-0 confidence within 1e-4 of the JAX-CPU recording, and
    the same exit."""
    ref = trained[3]
    engine = _trained_port(trained)
    thr, hw = ref["threshold"], tuple(ref["hw"])
    for i in range(2):
        seed, want = ref["val_seeds"][i], ref["exit0_edm_confidence"][i]
        x = beacon.gen_item(seed, hw)["image"][None]
        logits, k, _, conf = engine.infer_fused(torch.from_numpy(x), thr, "edm")
        assert abs(conf - want) <= 1e-4, (seed, conf, want)
        assert k == (0 if want <= thr else 1) and abs(want - thr) > 1e-3
        assert logits.shape == (1, 7, *hw) and torch.isfinite(logits).all()


def test_beacon_copy_matches_the_script():
    spec = importlib.util.spec_from_file_location("product_proof", REPO / "scripts" / "product_proof.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ref, out = script.gen_item(9003, (97, 131)), beacon.gen_item(9003, (97, 131))
    assert out["rho"] == ref["rho"]
    np.testing.assert_array_equal(out["image"], ref["image"])
    np.testing.assert_array_equal(out["label"], ref["label"])


# ------------------------------------------------------------------ decode


def _shipped_alphas(rng):
    """α logits whose decode holds the shipped genotype's rows: each row's
    op far above the rest of its edge."""
    alphas = rng.randn(20, 8)
    for edge, op in np.asarray(AUTODEEPLAB_GENOTYPE):
        alphas[edge, op] += 20.0
    return alphas


@pytest.mark.parametrize("seed", ["shipped", 0, 1, 2, 3, 4])
def test_decode_matches_jax(seed):
    rng = np.random.RandomState(0 if seed == "shipped" else seed)
    betas = rng.randn(12, 4, 3).astype(np.float32)
    alphas = _shipped_alphas(rng) if seed == "shipped" else rng.randn(20, 8).astype(np.float32)
    for out, ref in zip(pt_decode.viterbi_decode(betas), jx_decode.viterbi_decode(betas)):
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(pt_decode.normalize_betas(betas), jx_decode.normalize_betas(betas))
    gene = pt_decode.genotype_decode(alphas, 5)
    np.testing.assert_array_equal(gene, jx_decode.genotype_decode(alphas, 5))
    if seed == "shipped":
        # the same rows; within a block they come by weight, not as shipped
        assert sorted(map(tuple, gene.tolist())) == sorted(map(tuple, np.asarray(AUTODEEPLAB_GENOTYPE).tolist()))
        for cfg in NETWORK_ARCH.values():
            np.testing.assert_array_equal(pt_decode.network_layer_to_space(cfg["path"]),
                                          jx_decode.network_layer_to_space(cfg["path"]))
    dec = pt_decode.ArchDecoder(alphas, betas, 5)
    np.testing.assert_array_equal(dec.genotype_decode(), gene)
    np.testing.assert_array_equal(dec.viterbi_decode()[0], jx_decode.viterbi_decode(betas)[0])


def test_cli_decode_writes_the_jax_files(tmp_path, capsys):
    rng = np.random.RandomState(7)
    np.save(tmp_path / "betas.npy", rng.randn(12, 4, 3).astype(np.float32))
    np.save(tmp_path / "alphas.npy", rng.randn(20, 8).astype(np.float32))
    args = ["--betas", str(tmp_path / "betas.npy"), "--alphas", str(tmp_path / "alphas.npy")]
    jx_cli_decode.main(args + ["--out-dir", str(tmp_path / "jax")])
    pt_cli_decode.main(args + ["--out-dir", str(tmp_path / "port")])
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["genotype.npy", "network_path.npy", "network_path_space.npy"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for name in files:
        ref, out = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == printed[2:]
