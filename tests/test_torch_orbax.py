"""The port's reader of the JAX package's orbax checkpoints
(auto_dynamic_deeplab_torch/utils/orbax_reader.py, utils/zstd.py and
csrc/zstd_decode.cpp), the bridge's optimizer carry-over and every restore
site, on the CPU, against ``zstandard``, orbax's own restore and the JAX
package's answers recorded in tests/torch_orbax_ref.npz on the run
directory tests/torch_orbax_fixture/ (scripts/torch_record_orbax_ref.py).

Tolerances: the decoder and the reader bitwise; the fixture's ADD (C=2,
F=4, 19 classes, 65x65) through ``cli.evaluate --resume --edm-resume``:
per-exit logits |Δ| ≤ 1e-3·max|ref| (the golden-test tolerance), EDM
confidences ≤ 1e-3, the exits equal (the threshold lies 7.7e-2 from every
confidence). One train step after ``--resume``: the loss ≤ 1e-5 relative
and the parameters after it ≤ 2e-2·max(1, max|ref|) per tensor, as
tests/test_torch_train.py holds the first step, and the update of every
parameter (after minus before) within 1e-1 of JAX's (L2, relative, over
seeded projections). This step is ill-conditioned in fp32 (the ASPP
image-pool BN over 4 values; the stems' kernels move most): against the
port's own float64 step the port's fp32 update reads 1.7e-2 with 8 threads
and 3.4e-2 with 1, JAX's 2.7e-2, so two fp32 runs part by up to ~6e-2
(scripts/torch_orbax_step_conditioning.py).
The carried momentum is 68% of the update's norm, so a lost or misplaced
momentum moves it by 5x the bound.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch.bridge import (
    _flatten,
    _per_edge,
    _to_torch_layout,
    load_jax_optimizer_state,
    load_jax_variables,
)
from auto_dynamic_deeplab_torch.cli import evaluate as pt_evaluate
from auto_dynamic_deeplab_torch.cli import search as pt_search
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation, make_data_loader
from auto_dynamic_deeplab_torch.models import ADD
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
from auto_dynamic_deeplab_torch.train.search_trainer import SearchConfig, SearchTrainer
from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer
from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer
from auto_dynamic_deeplab_torch.utils import zstd
from auto_dynamic_deeplab_torch.utils.initialize import init_params
from auto_dynamic_deeplab_torch.utils.orbax_reader import (
    OcdbtStore,
    is_orbax_checkpoint,
    read_orbax_checkpoint,
    read_zarr_array,
)
from auto_dynamic_deeplab_torch.utils.saver import Saver, find_latest_checkpoint, restore_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_orbax_fixture")
STAGE2 = os.path.join(FIXTURE, "synthetic", "ADD_C2_F4", "experiment_0")
EDM_RUN = os.path.join(FIXTURE, "synthetic", "edm_C2", "experiment_0")
SEARCH_RUN = os.path.join(FIXTURE, "synthetic", "search_net_supernet_F2", "experiment_0")
CHECKPOINTS = {"stage2": os.path.join(STAGE2, "checkpoint"), "edm": os.path.join(EDM_RUN, "edm"),
               "search": os.path.join(SEARCH_RUN, "checkpoint")}
REF = dict(np.load(os.path.join(HERE, "torch_orbax_ref.npz")))
F, NCLS, HW = 4, 19, (65, 65)
SCHEDULE = ("poly", 0.01, 2, 5)  # the fixture's (scripts/torch_record_orbax_ref.py)
FORBIDDEN = ("orbax", "tensorstore", "zstandard", "jax", "flax", "auto_dynamic_deeplab_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread keeps these small models from competing for the
    cores with the other test files' workers (as tests/test_torch_variants.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat_tree(tree, prefix=()):
    """{dotted path: leaf} of nested dicts and sequences (None leaves kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for k, v in enumerate(tree):
            out.update(_flat_tree(v, prefix + (str(k),)))
        return out
    return {".".join(prefix): tree}


def _as_f32_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(got, want):
    got, want = _flat_tree(got), _flat_tree(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        w = _as_f32_bits(w)
        g = got[k]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, (k, g, w.dtype, w.shape)
        assert g.tobytes() == w.tobytes(), k


def _ref_leaves(key: str) -> dict:
    """The recorded leaves of one fixture checkpoint: {path: array}."""
    out = {}
    for path, dt, shape, offset in json.loads(str(REF[f"leaves/{key}:index"])):
        blob = REF[f"leaves/{key}:{dt}"]
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        out[path] = blob[offset:offset + n].view(dt).reshape(shape)
    return out


# ---------------------------------------------------------------- decoder

def _decoder_inputs():
    rng = np.random.RandomState(0)
    text = open(os.path.join(HERE, "..", "auto_dynamic_deeplab_torch", "bridge.py"), "rb").read()
    weights = (rng.standard_normal(300_000) * 0.05).astype(np.float32)
    return {
        "empty": b"",
        "incompressible": rng.bytes(50_000),
        "rle_heavy": b"\x07" * 300_000 + b"ab" * 5_000 + b"\x00" * 70_000,
        "multi_block_1.3MB": weights.tobytes() + text * 4 + bytes(rng.randint(0, 4, 200_000).astype(np.uint8)),
        "text": text,
    }


DECODER_INPUTS = _decoder_inputs()


@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
def test_zstd_decoder_matches_zstandard(level):
    """Every input at ``level``, with and without the content checksum and
    the content size, decodes bitwise to what zstandard decodes."""
    zs = pytest.importorskip("zstandard")
    assert len(DECODER_INPUTS["multi_block_1.3MB"]) > 1 << 20
    for name, data in DECODER_INPUTS.items():
        for checksum in (False, True):
            for content_size in (False, True):
                if level >= 19 and len(data) > 1 << 20 and (checksum or not content_size):
                    continue  # one variant of the 1.3 MB input at the slow levels
                frame = zs.ZstdCompressor(level=level, write_checksum=checksum,
                                          write_content_size=content_size).compress(data)
                want = zs.ZstdDecompressor().decompress(frame, max_output_size=len(data) + 1)
                assert want == data
                assert zstd.decompress(frame) == want, (name, level, checksum, content_size)


def test_zstd_decoder_concatenated_and_streamed_frames():
    zs = pytest.importorskip("zstandard")
    a, b = DECODER_INPUTS["text"], DECODER_INPUTS["multi_block_1.3MB"]
    two = zs.ZstdCompressor(level=3).compress(a) + zs.ZstdCompressor(level=19, write_checksum=True).compress(b[:300_000])
    assert zstd.decompress(two) == a + b[:300_000]
    chunker = zs.ZstdCompressor(level=5, write_checksum=True).chunker(chunk_size=65536)
    streamed = b"".join([*chunker.compress(b), *chunker.finish()])  # no content size, many blocks
    assert zs.get_frame_parameters(streamed).content_size == zs.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(streamed) == b
    assert zstd.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_zstd_decoder_refuses_corrupt_frames():
    """Truncated data, a flipped checksum, a frame that names a dictionary
    and a frame after a good one that is cut raise ValueError."""
    zs = pytest.importorskip("zstandard")
    data = DECODER_INPUTS["multi_block_1.3MB"][:400_000]
    frame = zs.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (0, 3, 5, 9, 100, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    with pytest.raises(ValueError):
        zstd.decompress(frame + frame[:len(frame) // 3])
    bad = bytearray(frame)
    bad[-2] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    samples = [b"sample %d " % i + bytes(np.random.RandomState(i).randint(0, 3, 200).astype(np.uint8)) * 4
               for i in range(300)]
    dictionary = zs.train_dictionary(2048, samples)
    named = zs.ZstdCompressor(dict_data=dictionary).compress(samples[0])
    assert zs.get_frame_parameters(named).dict_id == dictionary.dict_id() != 0
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(named)
    with pytest.raises(ValueError, match="limit"):
        zstd.decompress(zs.ZstdCompressor(level=1).compress(data), limit=1000)


# ----------------------------------------------------------------- reader

@pytest.mark.parametrize("key", sorted(CHECKPOINTS))
def test_reader_matches_orbax_on_the_fixture(key):
    """Every leaf of the committed checkpoints bitwise as orbax restores it
    (the JAX package's restore_checkpoint), and as the npz recorded it."""
    from auto_dynamic_deeplab_tpu.utils.saver import restore_checkpoint as jx_restore

    path = CHECKPOINTS[key]
    assert is_orbax_checkpoint(path)
    got = read_orbax_checkpoint(path)
    _assert_trees_equal(got, jx_restore(path, None)[0])
    flat = {k: v for k, v in _flat_tree(got).items() if v is not None}
    ref = _ref_leaves(key)
    assert sorted(flat) == sorted(ref)
    assert all(flat[k].tobytes() == ref[k].tobytes() for k in ref)


def test_reader_matches_orbax_on_a_fresh_checkpoint(tmp_path):
    """A numpy tree with int32, 0-d, bfloat16, > 1024-byte leaves (stored
    out of line), a sequence and a None leaf, written by the JAX
    package's Saver, read bitwise, keys as the metadata says."""
    import ml_dtypes

    from auto_dynamic_deeplab_tpu.utils.saver import Saver as JxSaver
    from auto_dynamic_deeplab_tpu.utils.saver import restore_checkpoint as jx_restore

    rng = np.random.RandomState(3)
    tree = {
        "ints": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
        "zero_d": np.float32(-2.5),
        "step": np.int32(41),
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "big": {"kernel": rng.standard_normal((3, 3, 16, 24)).astype(np.float32)},
        "seq": [rng.standard_normal(7).astype(np.float32), np.ones((2, 2), np.int32)],
        "empty_state": None,
    }
    saver = JxSaver(str(tmp_path), "synthetic", "fresh")
    saver.save_checkpoint(tree, is_best=False, epoch=3, best_pred=0.5)
    path = os.path.join(saver.experiment_dir, "checkpoint")
    got = read_orbax_checkpoint(path)
    _assert_trees_equal(got, jx_restore(path, None)[0])
    assert set(got["seq"]) == {0, 1} and got["empty_state"] is None and got["zero_d"].shape == ()
    assert got["bf16"].dtype == np.float32
    state, meta = restore_checkpoint(path)
    assert meta == {"epoch": 3, "best_pred": 0.5} and state["step"] == 41
    assert find_latest_checkpoint(str(tmp_path), "synthetic", "fresh") == os.path.abspath(path)


def test_reader_walks_a_btree_of_any_height(tmp_path):
    """An OCDBT store written by tensorstore with small nodes (height 3,
    prefix-shared keys, inline and indirect values, two commits): every
    key and value of its newest version."""
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20,
                       "compression": {"id": "zstd", "level": 5}}}
    kv = ts.KvStore.open(spec).result()
    txn = ts.Transaction()
    for i in range(200):
        kv.with_transaction(txn)[f"group{i % 7}/key{i:04d}"] = b"v%d" % i * (1 + i % 13)
    txn.commit_async().result()
    kv.write("group3/key0003", b"rewritten").result()
    store = OcdbtStore(str(tmp_path))
    assert store.root_node[3] >= 2
    got = store.items()
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    assert got == want and got["group3/key0003"] == b"rewritten"


def _zarray(**kw):
    meta = {"chunks": [2, 3], "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None, "order": "C", "shape": [5, 7], "zarr_format": 2}
    meta.update(kw)
    return json.dumps(meta).encode()


def test_zarr_chunks_assemble_and_refuse_what_they_cannot_read():
    """Chunks of a (5, 7) array in (2, 3) tiles, the edge ones clipped, a
    missing one filled when the metadata allows it, raising otherwise;
    another compressor, dtype, order or zarr format raises, naming the
    array."""
    zs = pytest.importorskip("zstandard")
    full = np.arange(35, dtype=np.float32).reshape(5, 7)
    kv = {"w/.zarray": _zarray()}
    for i in range(3):
        for j in range(3):
            tile = np.zeros((2, 3), np.float32)
            part = full[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            tile[:part.shape[0], :part.shape[1]] = part
            kv[f"w/{i}.{j}"] = zs.ZstdCompressor(level=1).compress(tile.tobytes())
    assert np.array_equal(read_zarr_array(kv, "w", missing_is_fill=False), full)
    del kv["w/1.1"]
    with pytest.raises(ValueError, match="w/1.1"):
        read_zarr_array(kv, "w", missing_is_fill=False)
    kv["w/.zarray"] = _zarray(fill_value=-1.0)
    filled = read_zarr_array(kv, "w", missing_is_fill=True)
    assert (filled[2:4, 3:6] == -1).all() and np.array_equal(filled[:2], full[:2])
    for bad, match in ((dict(compressor={"id": "blosc"}), "compressor"), (dict(dtype="<f8"), "dtype"),
                       (dict(order="F"), "order"), (dict(zarr_format=3), "zarr format")):
        kv["w/.zarray"] = _zarray(**bad)
        with pytest.raises(ValueError, match=match) as e:
            read_zarr_array(kv, "w", missing_is_fill=True)
        assert "w" in str(e.value)


def test_reader_refuses_a_corrupt_or_unsupported_checkpoint(tmp_path):
    path = tmp_path / "edm"
    shutil.copytree(CHECKPOINTS["edm"], path)
    meta = json.loads((path / "_METADATA").read_text())
    (path / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr3"):
        read_orbax_checkpoint(str(path))
    (path / "_METADATA").write_text(json.dumps({**meta, "use_ocdbt": False}))
    with pytest.raises(ValueError, match="ocdbt"):
        read_orbax_checkpoint(str(path))
    (path / "_METADATA").write_text(json.dumps(meta))
    node = next((path / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[len(data) // 2] ^= 0x01
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        read_orbax_checkpoint(str(path))


# ------------------------------------------------- the flagship, full width

def test_flagship_width_tree_loads_into_the_port(tmp_path):
    """The flagship ADD's flax tree (C=2, F=20, B=5, 19 classes, 11.37 M
    parameters), saved by the JAX package's Saver, read by the port and
    loaded into its flagship ADD: every leaf and every port tensor equal
    bitwise."""
    import jax.numpy as jnp

    from auto_dynamic_deeplab_tpu import models as jx_models
    from auto_dynamic_deeplab_tpu.utils.saver import Saver as JxSaver
    from torch_port_helpers import flax_variables

    arch = NETWORK_ARCH[2]
    jm = jx_models.ADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, NCLS, F=20, B=5,
                       low_level_layer=arch["low_level_layer"])
    v = flax_variables(jm, jnp.zeros((1, 65, 65, 3)), train=False, seed=1)
    saver = JxSaver(str(tmp_path), "synthetic", "ADD_C2_F20")
    saver.save_checkpoint(v, is_best=False, epoch=0, best_pred=0.0)
    t0 = time.perf_counter()
    tree = read_orbax_checkpoint(os.path.join(saver.experiment_dir, "checkpoint"))
    print(f"flagship tree read in {time.perf_counter() - t0:.2f} s")
    _assert_trees_equal(tree, v)
    model = ADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, NCLS, F=20, B=5,
                low_level_layer=arch["low_level_layer"])
    load_jax_variables(model, tree)
    assert abs(sum(p.numel() for p in model.parameters()) - 11.37e6) < 0.01e6
    flat = {}
    for c in ("params", "batch_stats"):
        _flatten(v[c], "", flat)
    state = model.state_dict()
    assert sorted(flat) == sorted(state)
    assert all(np.array_equal(state[k].numpy(), _to_torch_layout(k, a)) for k, a in flat.items())


# ------------------------------------------------------ optimizer carry-over

def _cli_add():
    arch = NETWORK_ARCH[2]
    model = ADD(arch["path"], arch["C_index"], AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5,
                low_level_layer=arch["low_level_layer"])
    return init_params(model, torch.Generator().manual_seed(0))


def _port_layout(tree) -> dict:
    """{port name: array in the port's layout} of a params-shaped tree."""
    flat = {}
    _flatten(tree, "", flat)
    return {k: _to_torch_layout(k, a) for k, a in _per_edge(flat).items()}


def _port_state(tree, collections) -> dict:
    """The port's state_dict, as numpy, of a JAX tree's ``collections``."""
    out = {}
    for c in collections:
        out.update(_port_layout(tree[c]))
    return out


def _resumed_train_step():
    model = _cli_add()
    mode, lr, epochs, iters = SCHEDULE
    step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule(mode, lr, epochs, iters))
    step.load_state_dict(restore_checkpoint(CHECKPOINTS["stage2"])[0])
    return step


def test_stage2_optimizer_carries_over():
    """The momentum buffers are the layout-converted trace, bitwise; the
    step is the train state's; a trace for Adam, or a chain of another
    structure, raises naming the state."""
    tree = read_orbax_checkpoint(CHECKPOINTS["stage2"])
    step = _resumed_train_step()
    assert step.step == int(tree["step"]) == 2
    trace = _port_layout(tree["opt_state"][1][0]["trace"])
    named = dict(step.model.named_parameters())
    assert sorted(trace) == sorted(named)
    for name, p in named.items():
        assert np.array_equal(step.optimizer.state[p]["momentum_buffer"].numpy(), trace[name]), name
    assert tree["opt_state"][0] is None and int(tree["opt_state"][1][1]["count"]) == 2
    adam = torch.optim.Adam(step.model.parameters())
    with pytest.raises(ValueError, match="opt_state.1.0"):
        load_jax_optimizer_state(adam, step.model, tree["opt_state"])
    with pytest.raises(ValueError, match="opt_state.1.1"):
        load_jax_optimizer_state(step.optimizer, step.model, {0: None, 1: {0: tree["opt_state"][1][0],
                                                                           1: {"scale": np.float32(1)}}})
    with pytest.raises(KeyError, match="optimizer parameters without a flax key"):
        bad = dict(tree["opt_state"][1][0]["trace"])
        bad.pop("decoder")
        load_jax_optimizer_state(step.optimizer, step.model, {1: {0: {"trace": bad}}})


def _search_trainer(resume: str, tmp_path):
    args = pt_search.build_parser().parse_args(
        ["--device", "cpu", "--network", "net_supernet", "--num-layers", "4", "--exit-layers", "2", "--F", "2",
         "--B", "5", "--batch-size", "4", "--synthetic-crop", "65", "65", "--synthetic-length", "8",
         "--workers", "0"])
    loader_a, loader_b, val_loader, nclass = make_data_loader(
        "synthetic", 4, 1, supernet=True, num_workers=0, synthetic_length=8, synthetic_crop=HW)
    model = init_params(pt_search.build_model(args, nclass, "net_supernet", (2,)), torch.Generator().manual_seed(0))
    cfg = SearchConfig(epochs=2, alpha_epoch=0, lr=0.025, min_lr=0.003, arch_lr=3e-3, weight_decay=3e-4,
                       arch_weight_decay=1e-3, eval_interval=1, run_dir=str(tmp_path), dataset="synthetic",
                       checkname="search_net_supernet_F2", resume=resume)
    return SearchTrainer(model, loader_a, loader_b, val_loader, cfg, device="cpu")


def test_search_state_carries_over(tmp_path):
    """cli.search's supernet resumed from the JAX search checkpoint: the
    weights, BN statistics and arch, the weight optimizer's momentum, the
    Adam moments and step, the schedule's count and the epoch."""
    tree = read_orbax_checkpoint(CHECKPOINTS["search"])
    trainer = _search_trainer(SEARCH_RUN, tmp_path)
    steps, model = trainer.steps, trainer.model
    assert trainer.start_epoch == 1 and trainer.best_pred == pytest.approx(0.1)
    assert steps.step == int(tree["w_opt"][1][1]["count"]) == 3
    want = _port_state(tree, ("params", "batch_stats", "arch"))
    assert all(np.array_equal(t.numpy(), want[k]) for k, t in model.state_dict().items())
    trace = _port_layout(tree["w_opt"][1][0]["trace"])
    named = dict(model.named_parameters())
    for p in steps.w_params:
        name = next(n for n, q in named.items() if q is p)
        assert np.array_equal(steps.w_optimizer.state[p]["momentum_buffer"].numpy(), trace[name]), name
    adam = tree["a_opt"][1]
    mu, nu = _port_layout(adam["mu"]), _port_layout(adam["nu"])
    assert sorted(mu) == sorted(n for n, q in named.items() if any(q is a for a in steps.a_params))
    for name in mu:
        st = steps.a_optimizer.state[named[name]]
        assert np.array_equal(st["exp_avg"].numpy(), mu[name]) and np.array_equal(st["exp_avg_sq"].numpy(), nu[name])
        assert float(st["step"]) == int(adam["count"]) == 3
    # a search checkpoint saved without the optimizers resumes them fresh, as the JAX trainer does
    fresh = _search_trainer(None, tmp_path).steps
    with pytest.warns(UserWarning, match="no optimizer states"):
        fresh.load_state_dict({c: tree[c] for c in ("params", "batch_stats", "arch")})
    assert fresh.step == 0 and not fresh.w_optimizer.state and not fresh.a_optimizer.state


@pytest.mark.parametrize("B", [2, 3])
def test_search_supernet_below_five_blocks_takes_the_jax_tree(B):
    """cli.search's net_supernet at --B below the genotype's five blocks
    holds the ops its blocks call and no others, as the JAX supernet's
    tree (flax creates a submodule's parameters at its first call), so the
    JAX variables load."""
    import jax.numpy as jnp

    from auto_dynamic_deeplab_tpu.models import ModelNetSearch as JxModelNetSearch
    from torch_port_helpers import flax_variables

    v = flax_variables(JxModelNetSearch(NCLS, AUTODEEPLAB_GENOTYPE, C_index=(2,), num_layers=4, F=2, B=B),
                       jnp.zeros((1, *HW, 3)), train=False, seed=4)
    args = pt_search.build_parser().parse_args(["--device", "cpu", "--num-layers", "4", "--F", "2", "--B", str(B)])
    model = pt_search.build_model(args, NCLS, "net_supernet", (2,))
    load_jax_variables(model, v)
    n_ops = sum(1 for e, _ in AUTODEEPLAB_GENOTYPE if e < sum(2 + i for i in range(B)))
    assert {n.split(".")[1] for n, _ in model.named_parameters() if ".ops_" in n} == {f"ops_{k}" for k in range(n_ops)}


# ------------------------------------------------------- one step after resume

def _sketch(t: int, a: np.ndarray) -> np.ndarray:
    r = np.random.RandomState(1000 + t).standard_normal((8, a.size))
    return r @ a.reshape(-1).astype(np.float64)


def test_train_step_after_resume_matches_jax():
    step = _resumed_train_step()
    model = step.model
    before = {k: p.detach().double().clone() for k, p in model.named_parameters()}
    momentum = {k: step.optimizer.state[p]["momentum_buffer"].double().clone() for k, p in model.named_parameters()}
    data = SyntheticSegmentation(4, HW, NCLS, seed=7)
    image = torch.from_numpy(np.stack([data[i]["image"] for i in range(4)]))
    label = torch.from_numpy(np.stack([data[i]["label"] for i in range(4)]))
    lr = step.schedule(step.step)
    loss = step(image, label).item()
    want_loss = float(REF["step/loss"])
    assert abs(loss - want_loss) <= 1e-5 * want_loss, (loss, want_loss)
    assert step.step == int(REF["step/step"]) == 3
    names = json.loads(str(REF["step/names"]))
    assert sorted(names) == sorted(before)
    params = dict(model.named_parameters())
    update = {k: params[k].detach().double() - before[k] for k in names}
    got = np.stack([_sketch(t, update[k].numpy()) for t, k in enumerate(names)])
    want = REF["step/update_sketch"]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # the carried momentum's share of the update (Nesterov: lr·0.9·0.9·buffer)
    carried = np.stack([_sketch(t, 0.81 * lr * momentum[k].numpy()) for t, k in enumerate(names)])
    assert rel <= 1e-1 and np.linalg.norm(carried) / np.linalg.norm(want) >= 5 * 1e-1, rel
    whole = json.loads(str(REF["step/update_whole:index"]))
    at = 0
    for k in whole:
        n = update[k].numel()
        ref = REF["step/update_whole"][at:at + n].reshape(update[k].shape).astype(np.float64)
        at += n
        after = before[k].numpy() + ref
        err = np.abs(update[k].numpy() - ref).max()
        assert err <= 2e-2 * max(1.0, np.abs(after).max()), (k, err)
    stats = model.state_dict()
    at = 0
    for k, shape in json.loads(str(REF["step/stats:index"])):
        n = int(np.prod(shape))
        ref = REF["step/stats"][at:at + n].reshape(shape)
        at += n
        err = np.abs(stats[k].numpy() - ref).max()
        assert err <= 2e-2 * max(1.0, np.abs(ref).max()), (k, err)


# ------------------------------------------------------------------- CLIs

def _eval_argv():
    return ["--device", "cpu", "--F", str(F), "--synthetic-crop", *map(str, HW), "--synthetic-length",
            str(int(REF["eval/length"])), "--workers", "0", "--dynamic", "--confidence", "edm",
            "--threshold", repr(float(REF["eval/threshold"])), "--resume", STAGE2, "--edm-resume", EDM_RUN]


def test_cli_evaluate_restores_the_jax_run(capsys):
    """cli.evaluate --resume <JAX stage 2> --edm-resume <JAX EDM> --dynamic:
    the JAX package's per-exit logits, EDM confidences and exits."""
    argv = _eval_argv()
    evaluation, loader = pt_evaluate.build(pt_evaluate.build_parser().parse_args(argv))
    images = np.concatenate([b["image"] for b in loader])
    assert hashlib.sha256(np.ascontiguousarray(images)).hexdigest() == str(REF["eval/sha256"])
    n_logits = REF["eval/logits_0"].shape[0]
    with torch.no_grad():
        outs = evaluation.model.eval()(torch.from_numpy(images[:n_logits]))
    refs = [REF[f"eval/logits_{k}"] for k in range(len(outs))]
    for out, ref in zip(outs, refs):
        assert np.abs(out.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    for i in range(len(images)):
        logits, exit_idx, _, conf = evaluation.engine.infer_fused(images[i:i + 1], float(REF["eval/threshold"]), "edm")
        assert exit_idx == int(REF["eval/exit"][i]), i
        assert abs(conf - float(REF["eval/dynamic_confidence"][i])) <= 1e-3, i
        if i < n_logits:
            ref = refs[exit_idx][i]
            got = logits[0].permute(1, 2, 0).numpy()
            assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), i
    stats = pt_evaluate.main(argv)
    assert stats["exit_histogram"] == np.bincount(REF["eval/exit"], minlength=2).tolist()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"] == "cpu"


def _trainer(run_dir: str, resume: str, ft: bool = False) -> Trainer:
    train_loader, val_loader, _ = make_data_loader("synthetic", 2, 1, num_workers=0, synthetic_length=4,
                                                   synthetic_crop=HW)
    mode, lr, epochs, iters = SCHEDULE
    cfg = TrainConfig(epochs=epochs, lr=lr, lr_scheduler=mode, run_dir=run_dir, dataset="synthetic",
                      checkname="ADD_C2_F4", resume=resume, ft=ft)
    return Trainer(_cli_add(), train_loader, val_loader, cfg, device="cpu")


def test_trainer_ft_and_resume_auto_over_both_packages(tmp_path):
    """--ft takes the JAX checkpoint's weights and statistics only; --resume
    auto over a run dir of a JAX and a port experiment restores the newer,
    whichever package wrote it."""
    tree = read_orbax_checkpoint(CHECKPOINTS["stage2"])
    want = _port_state(tree, ("params", "batch_stats"))
    ft = _trainer(str(tmp_path / "ft"), STAGE2, ft=True)
    assert all(np.array_equal(t.numpy(), want[k]) for k, t in ft.model.state_dict().items())
    assert ft.train_step.step == 0 and ft.start_epoch == 0 and not ft.train_step.optimizer.state

    run = tmp_path / "run" / "synthetic" / "ADD_C2_F4"
    shutil.copytree(STAGE2, run / "experiment_0")
    port = Saver(str(tmp_path / "run"), "synthetic", "ADD_C2_F4")
    assert port.experiment_dir.endswith("experiment_1")
    model = _cli_add()
    port.save_checkpoint(TrainStep(model, make_optimizer(model.parameters()), lambda s: 0.0).state_dict(),
                         is_best=False, epoch=4, best_pred=0.5)
    newest = find_latest_checkpoint(str(tmp_path / "run"), "synthetic", "ADD_C2_F4")
    assert newest == os.path.join(port.experiment_dir, "checkpoint")
    assert _trainer(str(tmp_path / "run"), "auto").start_epoch == 5  # the port's, epoch 4
    shutil.copytree(STAGE2, run / "experiment_3")  # a JAX experiment after the trainer's own
    resumed = _trainer(str(tmp_path / "run"), "auto")
    assert find_latest_checkpoint(str(tmp_path / "run"), "synthetic", "ADD_C2_F4").endswith(
        os.path.join("experiment_3", "checkpoint"))
    assert resumed.start_epoch == 2 and resumed.train_step.step == 2 and resumed.best_pred == pytest.approx(0.25)
    assert all(np.array_equal(t.numpy(), want[k]) for k, t in resumed.model.state_dict().items())


def test_cli_search_resumes_the_jax_search(tmp_path, capsys):
    """cli.search --resume <JAX search experiment> trains on from epoch 1."""
    result = pt_search.main(
        ["--device", "cpu", "--network", "net_supernet", "--num-layers", "4", "--exit-layers", "2", "--F", "2",
         "--B", "5", "--batch-size", "4", "--synthetic-crop", "65", "65", "--synthetic-length", "8",
         "--epochs", "2", "--alpha-epoch", "0", "--eval-interval", "1", "--workers", "0",
         "--run-dir", str(tmp_path), "--resume", SEARCH_RUN])
    assert np.isfinite(result["train_loss"]) and len(result["step_losses"]) >= 1
    assert os.path.isdir(os.path.join(result["experiment_dir"], "arch_epoch_1"))
    assert not os.path.isdir(os.path.join(result["experiment_dir"], "arch_epoch_0"))


# ------------------------------------------------------------------ imports

def test_reading_imports_nothing_of_orbax_or_jax():
    """In a fresh interpreter: reading each fixture checkpoint and loading
    the train state leaves orbax, tensorstore, zstandard, jax, flax and the
    JAX package out of sys.modules; no port module or chip_smoke.py names
    them in an import."""
    code = (
        "import sys\n"
        "from auto_dynamic_deeplab_torch.utils.saver import restore_checkpoint\n"
        f"for p in {sorted(CHECKPOINTS.values())!r}:\n"
        "    restore_checkpoint(p)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('ok' if not bad else bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(HERE), timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", (res.stdout, res.stderr)
    import ast
    import pathlib

    pkg = pathlib.Path(HERE).parent / "auto_dynamic_deeplab_torch"
    for src in [*pkg.rglob("*.py"), pkg.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(src.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module and node.level == 0 else [])
            assert not [n for n in names if n.split(".")[0] in FORBIDDEN], (src, names)
