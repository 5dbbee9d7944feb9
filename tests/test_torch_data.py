"""The port's data layer (auto_dynamic_deeplab_torch/data) against the JAX
package's, on the CPU, on tiny Cityscapes- and Pascal-shaped trees written
from a numpy seed (96x128 frames).

Tolerances: the host paths (numpy/PIL and the native C++ engine), the raw
cache, the datasets' items, the loaders' batches and the search split are
bitwise equal; the device augmentation (torch ops here, JAX's jitted XLA
program there) is held to 1e-5·max(1, max|ref|) on the images, labels
equal.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from auto_dynamic_deeplab_torch import data as pt_data
from auto_dynamic_deeplab_torch.cli import evaluate as pt_evaluate
from auto_dynamic_deeplab_torch.cli import search as pt_search
from auto_dynamic_deeplab_torch.cli import search_layer as pt_search_layer
from auto_dynamic_deeplab_torch.cli import train as pt_train
from auto_dynamic_deeplab_torch.cli import train_edm as pt_train_edm
from auto_dynamic_deeplab_torch.data import cityscapes as pt_city
from auto_dynamic_deeplab_torch.data import device_transforms as pt_dt
from auto_dynamic_deeplab_torch.data import native as pt_native
from auto_dynamic_deeplab_torch.data import transforms as pt_T
from auto_dynamic_deeplab_torch.models import ADD
from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_torch.train.trainer import TrainConfig, Trainer
from auto_dynamic_deeplab_tpu import data as jx_data
from auto_dynamic_deeplab_tpu.data import cityscapes as jx_city
from auto_dynamic_deeplab_tpu.data import device_transforms as jx_dt
from auto_dynamic_deeplab_tpu.data import native as jx_native
from auto_dynamic_deeplab_tpu.data import rawcache as jx_rawcache
from auto_dynamic_deeplab_tpu.data import transforms as jx_T

HW = (96, 128)
CROP = (65, 65)
VOID = [0, 1, 4, 255]


def _frame(rng, hw=HW):
    img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    raw = rng.choice(pt_city.VALID_CLASSES + VOID, size=hw).astype(np.uint8)
    return img, raw


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """6 train frames over two cities, 1 val frame (validation pads it to
    the 1025x2049 eval canvas: a forward there costs seconds on the CPU)."""
    root = tmp_path_factory.mktemp("cityscapes")
    rng = np.random.RandomState(0)
    for split, cities, n in (("train", ["aachen", "bochum"], 3), ("val", ["frankfurt"], 1)):
        for c in cities:
            (root / "leftImg8bit" / split / c).mkdir(parents=True)
            (root / "gtFine" / split / c).mkdir(parents=True)
            for k in range(n):
                img, raw = _frame(rng)
                Image.fromarray(img).save(root / "leftImg8bit" / split / c / f"{c}_{k:06d}_000019_leftImg8bit.png")
                Image.fromarray(raw).save(root / "gtFine" / split / c / f"{c}_{k:06d}_000019_gtFine_labelIds.png")
    return str(root)


@pytest.fixture(scope="module")
def pascal(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    base = root / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (base / d).mkdir(parents=True)
    rng = np.random.RandomState(1)
    for split, names in (("train", ["2007_000001", "2007_000002"]), ("val", ["2007_000003"])):
        (base / "ImageSets" / "Segmentation" / f"{split}.txt").write_text("\n".join(names) + "\n")
        for name in names:
            Image.fromarray(rng.randint(0, 256, (70, 90, 3)).astype(np.uint8)).save(base / "JPEGImages" / f"{name}.jpg")
            label = rng.choice(list(range(21)) + [255], size=(70, 90)).astype(np.uint8)
            Image.fromarray(label).save(base / "SegmentationClass" / f"{name}.png")
    return str(root)


def _pil(rng, hw=(50, 70)):
    img, raw = _frame(rng, hw)
    return Image.fromarray(img), Image.fromarray(pt_city.encode_segmap(raw))


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ transforms


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_transforms_match_jax(seed):
    """train_preprocess from twin RandomStates (flip, scale, crop draws in
    order), eval_preprocess and full_image_eval_preprocess: bitwise."""
    img, mask = _pil(np.random.RandomState(seed))
    for crop in ((33, 65), (65, 97)):  # a crop inside the image and one padded
        got = pt_T.train_preprocess(img, mask, crop, rng=np.random.RandomState(seed))
        want = jx_T.train_preprocess(img, mask, crop, rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        got = pt_T.eval_preprocess(img, mask, crop, rng=np.random.RandomState(seed))
        want = jx_T.eval_preprocess(img, mask, crop, rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(pt_T.full_image_eval_preprocess(img, mask, (57, 81)),
                    jx_T.full_image_eval_preprocess(img, mask, (57, 81))):
        np.testing.assert_array_equal(g, w)


def test_encode_segmap_on_every_id():
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(pt_city.encode_segmap(ids), jx_city.encode_segmap(ids))
    np.testing.assert_array_equal(pt_city.LUT, jx_city._LUT)


def test_data_imports_without_pillow():
    """``import auto_dynamic_deeplab_torch.data`` in a process where PIL
    cannot be imported."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['PIL'] = None\n"
            "import auto_dynamic_deeplab_torch.data as d\n"
            "assert 'PIL.Image' not in sys.modules and d.make_data_loader\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------- native


def test_native_library_is_the_ports_own():
    """Built from the port's copy of the source into build/torch_kernels/,
    under a name that changes with the source, the flags and the CPU."""
    lib = pt_native.get_lib(strict=True)
    path = pt_native.library_path()
    assert path.exists() and path.parent.name == "torch_kernels" and lib._name == str(path)
    assert "libaugment" not in path.name and pt_native.SOURCE.parent.parent.name == "auto_dynamic_deeplab_torch"
    assert pt_native.library_path("cpu a") != pt_native.library_path("cpu b") != path
    assert pt_native.cpu_key() and pt_native.library_path(pt_native.cpu_key()) == path


@pytest.mark.parametrize("scale", [1.0, 0.7, 1.6])
def test_native_matches_jax_binding(scale):
    """The port's binding against the JAX package's, both flips, crops inside
    and past the scaled image: bitwise, the same C++ on both sides."""
    assert jx_native.available()
    rng = np.random.RandomState(int(scale * 10))
    img, raw = _frame(rng, (50, 70))
    mask = pt_city.encode_segmap(raw)
    mean, std = pt_T.CITYSCAPES_MEAN, pt_T.CITYSCAPES_STD
    for flip in (False, True):
        for crop, i, j in (((33, 45), 3, 5), ((97, 81), 0, 0)):
            got = pt_native.augment_train_native(img, mask, crop, mean, std, scale, flip, i, j)
            want = jx_native.augment_train_native(img, mask, crop, mean, std, scale, flip, i, j)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(pt_native.eval_full_native(img, mask, (57, 81), mean, std),
                    jx_native.eval_full_native(img, mask, (57, 81), mean, std)):
        np.testing.assert_array_equal(g, w)


def test_native_encode_labels_and_host_paths():
    """encode_labels against the JAX binding and the table; the native
    train path at scale 1 and the eval path against numpy/PIL (the engine
    multiplies by 1/std where numpy divides: within 1e-5)."""
    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, (40, 30)).astype(np.uint8)
    got = pt_native.encode_labels_native(raw, pt_city.LUT)
    np.testing.assert_array_equal(got, jx_native.encode_labels_native(raw, jx_city._LUT))
    np.testing.assert_array_equal(got, pt_city.encode_segmap(raw))
    img, mask = _pil(rng, (80, 90))
    for nat, ref in (
        (pt_T.train_preprocess_native(img, mask, CROP, scale=1.0, rng=np.random.RandomState(5)),
         pt_T.train_preprocess(img, mask, CROP, scale=1.0, rng=np.random.RandomState(5))),
        (pt_T.full_image_eval_preprocess_native(img, mask, (97, 97)),
         pt_T.full_image_eval_preprocess(img, mask, (97, 97))),
    ):
        np.testing.assert_allclose(nat[0], ref[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(nat[1], ref[1])


# ------------------------------------------------------- Cityscapes, Pascal


@pytest.mark.parametrize("engine", ["native", "pil"])
def test_cityscapes_items_match_jax(city, monkeypatch, engine):
    """Items of every mode (train, val, raw, full, search) from the same
    RandomState, on either preprocessing engine."""
    monkeypatch.setenv("ADD_TPU_NATIVE", "1" if engine == "native" else "0")
    modes = [dict(split="train", crop_size=CROP), dict(split="val"), dict(split="train", raw=True),
             dict(split="train", full=True), dict(split="train", search=True)]
    for kw in modes:
        pt, jx = pt_city.CityscapesSegmentation(city, **kw), jx_city.CityscapesSegmentation(city, **kw)
        assert pt.files == jx.files and pt.native == (engine == "native" and not kw.get("raw"))
        for i in (0, len(pt) - 1):
            _equal_items(pt.__getitem__(i, rng=np.random.RandomState(i)),
                         jx.__getitem__(i, rng=np.random.RandomState(i)))


def test_two_train_seg_matches_jax(city):
    for seed in (0, 3):
        pa, pb = pt_city.two_train_seg(city, seed=seed)
        ja, jb = jx_city.two_train_seg(city, seed=seed)
        assert pa.files == ja.files and pb.files == jb.files and len(pa) == len(pb) == 3
        assert sorted(pa.files + pb.files) == pt_city.recursive_glob(os.path.join(city, "leftImg8bit", "train"))
        assert pa.crop_size == (321, 321) and pa.search
    with pytest.raises(FileNotFoundError):
        pt_city.two_train_seg(os.path.join(city, "missing"), seed=0)


def test_pascal_items_match_jax(pascal):
    from auto_dynamic_deeplab_tpu.data.pascal import VOCSegmentation as JxVOC

    for split in ("train", "val"):
        pt, jx = pt_data.VOCSegmentation(pascal, split), JxVOC(pascal, split)
        assert pt.ids == jx.ids and pt.NUM_CLASSES == 21
        for i in range(len(pt)):
            _equal_items(pt.__getitem__(i, rng=np.random.RandomState(i)),
                         jx.__getitem__(i, rng=np.random.RandomState(i)))


def test_raw_cache_round_trips_between_packages(city, tmp_path):
    """The port reads a cache the JAX package built and the other way round;
    both give the raw dataset's items."""
    pt_raw = pt_city.CityscapesSegmentation(city, "train", raw=True)
    jx_raw = jx_city.CityscapesSegmentation(city, "train", raw=True)
    pt_built = pt_data.RawArrayCache.build(pt_raw, str(tmp_path / "pt"))
    jx_built = jx_rawcache.RawArrayCache.build(jx_raw, str(tmp_path / "jx"))
    pt_reads_jx = pt_data.RawArrayCache(str(tmp_path / "jx"))
    jx_reads_pt = jx_rawcache.RawArrayCache(str(tmp_path / "pt"))
    for f in ("meta.json", "images.npy", "labels.npy"):
        assert (tmp_path / "pt" / f).read_bytes() == (tmp_path / "jx" / f).read_bytes(), f
    assert len(pt_reads_jx) == len(jx_reads_pt) == len(pt_raw) == 6
    for i in range(len(pt_raw)):
        want = pt_raw[i]
        for cache in (pt_built, jx_built, pt_reads_jx, jx_reads_pt):
            _equal_items(cache[i], want)
    # a cache whose arrays do not match its meta.json is refused
    (tmp_path / "pt" / "meta.json").write_text('{"n": 5, "h": 96, "w": 128}')
    with pytest.raises(ValueError, match="meta.json"):
        pt_data.RawArrayCache(str(tmp_path / "pt"))


# ------------------------------------------------------ device transforms


@pytest.fixture(scope="module")
def jx_augment():
    """JAX's jitted programs, one per source shape (one compile each)."""
    return {hw: jx_dt.make_train_augment(hw, CROP) for hw in (HW, (40, 60))}


def _augment_inputs(hw, seed):
    """6 samples: scales {0.5, 1, 1.7} x both flips, crops drawn inside the
    padded scaled image."""
    rng = np.random.RandomState(seed)
    frames = [_frame(rng, hw) for _ in range(6)]
    images = np.stack([f[0] for f in frames])
    masks = np.stack([pt_city.encode_segmap(f[1]) for f in frames])
    scales = np.repeat(np.float32([0.5, 1.0, 1.7]), 2)
    flips = np.tile([False, True], 3)
    offs_i, offs_j = [], []
    for s in scales:
        nh, nw = int(round(hw[0] * s)), int(round(hw[1] * s))
        offs_i.append(rng.randint(0, max(nh, CROP[0]) - CROP[0] + 1))
        offs_j.append(rng.randint(0, max(nw, CROP[1]) - CROP[1] + 1))
    return images, masks, scales, flips, np.int32(offs_i), np.int32(offs_j)


def _assert_augment_close(got, want):
    image, label = got
    ref = np.asarray(want[0])
    assert image.dtype == torch.float32 and label.dtype == torch.int64 and image.shape == ref.shape
    assert np.abs(image.numpy() - ref).max() <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_array_equal(label.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("hw", [HW, (40, 60)], ids=["96x128", "40x60_pad"])
def test_device_augment_matches_jax(jx_augment, hw):
    args = _augment_inputs(hw, seed=hw[0])
    got = pt_dt.make_train_augment(hw, CROP, device="cpu")(*args)
    want = jx_augment[hw](*(jnp.asarray(a) for a in args))
    _assert_augment_close(got, want)
    if hw == (40, 60):  # sample 0 at scale 0.5 is 20x30: rows and columns past it are pad (0, 255)
        assert not got[0][0, 20:].any() and not got[0][0, :, 30:].any() and got[0][0, :20, :30].any()
        assert (got[1][0, 20:] == 255).all() and (got[1][0, :, 30:] == 255).all()


def test_device_eval_preprocess_and_draws_match_jax():
    rng = np.random.RandomState(7)
    frames = [_frame(rng) for _ in range(2)]
    images = np.stack([f[0] for f in frames])
    masks = np.stack([pt_city.encode_segmap(f[1]) for f in frames])
    out = (97, 129)
    x, m = pt_dt.make_eval_preprocess(HW, out, device="cpu")(images, masks)
    jx_x, jx_m = jx_dt.make_eval_preprocess(HW, out)(jnp.asarray(images), jnp.asarray(masks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx_x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jx_m))
    for seed in range(20):
        for scale in (0.0, 0.5):
            got = pt_dt.sample_augment_params(HW, CROP, scale, np.random.RandomState(seed))
            want = jx_dt.sample_augment_params(HW, CROP, scale, np.random.RandomState(seed))
            assert got == want and [type(v) for v in got] == [type(v) for v in want]


def test_device_augment_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        pt_dt.make_train_augment(HW, CROP)


# ---------------------------------------------------------------- loaders


def _first_batch(loader):
    return pt_data.peek_batch(loader)


@pytest.mark.parametrize("dataset,kw", [("cityscapes", {}), ("cityscapes", {"raw_train": True}),
                                        ("cityscapes_edm", {}), ("pascal", {}), ("cityscapes", {"supernet": True})],
                         ids=["cityscapes", "raw", "cityscapes_edm", "pascal", "supernet"])
def test_make_data_loader_matches_jax(city, pascal, dataset, kw):
    root = pascal if dataset == "pascal" else city
    common = dict(root=root, num_workers=2, seed=3, crop_size=CROP, **kw)
    pt = pt_data.make_data_loader(dataset, 2, 1, **common)
    jx = jx_data.make_data_loader(dataset, 2, 1, **common)
    assert len(pt) == len(jx) == (4 if kw.get("supernet") else 3) and pt[-1] == jx[-1]
    for p, j in zip(pt[:-1], jx[:-1]):
        assert len(p) == len(j) and len(p.dataset) == len(j.dataset)
        _equal_items(_first_batch(p), _first_batch(j))


def test_default_roots_exports_and_unknown_dataset():
    assert set(pt_data.DEFAULT_ROOTS) == set(jx_data.DEFAULT_ROOTS)
    assert set(jx_data.__all__) <= set(pt_data.__all__)
    with pytest.raises(NotImplementedError):
        pt_data.make_data_loader("ade20k", 2)


# ---------------------------------------------------------------- trainer


def _tiny_add():
    model = ADD([1, 2, 2, 2, 3, 2], [1], AUTODEEPLAB_GENOTYPE, 19, F=4, B=5)
    from auto_dynamic_deeplab_torch.utils.initialize import init_params

    return init_params(model, torch.Generator().manual_seed(0))


def test_trainer_device_augment_matches_jax(city, jx_augment, tmp_path):
    """The trainer's first raw batch (6 frames) against JAX augment_batch
    fed the same per-sample seeds: RandomState(seed·7919 + epoch·613 +
    b·127 + k)."""
    train, val, _ = pt_data.make_data_loader("cityscapes", 6, 1, root=city, num_workers=2, seed=2,
                                             crop_size=CROP, raw_train=True)
    cfg = TrainConfig(epochs=1, run_dir=str(tmp_path), dataset="cityscapes", device_augment=True, crop_size=CROP)
    trainer = Trainer(_tiny_add(), train, val, cfg, device="cpu", seed=2)
    train.set_epoch(1)
    batch = _first_batch(train)
    got = trainer._device_augment(batch, epoch=1, b=0)
    rngs = [np.random.RandomState(2 * 7919 + 613 + k) for k in range(6)]
    want = jx_dt.augment_batch(jx_augment[HW], batch["image_u8"], batch["label_u8"], HW, CROP, rngs=rngs)
    _assert_augment_close(got, want)
    with pytest.raises(ValueError, match="crop_size"):
        Trainer(_tiny_add(), train, val, TrainConfig(run_dir=str(tmp_path), device_augment=True), device="cpu")


# ------------------------------------------------------------------- CLIs


_CITY = ["--device", "cpu", "--dataset", "cityscapes", "--workers", "2", "--F", "4"]


def test_cli_train_device_augment_on_cityscapes(city, tmp_path):
    """cli.train --device-augment on the tree, one epoch (3 steps at 33x65)
    with validation at the full eval canvas (1025x2049)."""
    argv = _CITY + ["--data-root", city, "--device-augment", "--crop-size", "33", "65", "--batch-size", "2",
                    "--epochs", "1", "--run-dir", str(tmp_path)]
    result = pt_train.main(argv)
    assert np.isfinite(result["train_loss"]) and len(result["step_ms"]) == 3 and len(result["miou"]) == 2
    assert os.path.exists(os.path.join(result["experiment_dir"], "checkpoint"))


def test_cli_train_edm_and_dynamic_evaluate_on_cityscapes(city, tmp_path):
    """cli.train_edm --dataset cityscapes_edm (two full-size train frames),
    then cli.evaluate --dynamic --confidence edm on the val frame."""
    loss = pt_train_edm.main(["--device", "cpu", "--dataset", "cityscapes_edm", "--data-root", city, "--workers", "2",
                              "--F", "4", "--epochs", "1", "--edm-batch-size", "2", "--max-items", "2",
                              "--run-dir", str(tmp_path)])
    assert np.isfinite(loss)
    feats = list((tmp_path / "cityscapes_edm" / "edm_C2" / "experiment_0").glob("feature_*.npy"))
    assert len(feats) == 1 and np.load(feats[0]).shape[:3] == (2, 65, 129)
    stats = pt_evaluate.main(_CITY + ["--data-root", city, "--dynamic", "--confidence", "edm", "--edm-resume",
                                      str(tmp_path / "cityscapes_edm" / "edm_C2" / "experiment_0")])
    assert sum(stats["exit_histogram"]) == 1


@pytest.mark.parametrize("cli", ["search", "search_layer"])
def test_search_clis_on_cityscapes(city, tmp_path, cli):
    """One bilevel epoch on the two_train_seg halves (3 frames each, batch 2:
    one weight and one arch step), validation on the val frame."""
    argv = ["--device", "cpu", "--dataset", "cityscapes", "--data-root", city, "--workers", "2", "--num-layers", "4",
            "--F", "2", "--B", "2", "--batch-size", "2", "--epochs", "1", "--alpha-epoch", "0",
            "--run-dir", str(tmp_path)]
    if cli == "search":
        result = pt_search.main(argv + ["--exit-layers", "2"])
    else:
        result = pt_search_layer.main(argv + ["--network", "baseline_path", "--exit-layer", "2"])
    assert np.isfinite(result["train_loss"]) and len(result["step_ms"]["arch"]) == 1
    assert result["experiment_dir"].startswith(str(tmp_path / "cityscapes"))
