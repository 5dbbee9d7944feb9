"""The port's EDM stage (make_edm_dataset, train_edm) against the JAX
package's, on the CPU, with the tiny ADD of tests/test_torch_model.py
(path [1,2,2,2,3,2], exit at cell 1, F=4, B=5, 7 classes, 33x65).

``make_edm_dataset`` is held to the model it drives: each feature is the
port's ``get_feature`` (whose logits and feature tests/test_torch_model.py
holds to JAX) in the JAX package's NHWC layout, bitwise, and each entropy
is the JAX package's ``normalized_shannon_entropy`` of the port's exit
logits, |Δ| ≤ 1e-6; the cache files carry the JAX package's names. Three
epochs of ``train_edm`` from the JAX package's own EDM initialization
(``EDM().init(PRNGKey(seed), features[:1])``, carried over by the bridge)
against JAX ``train_edm`` on the same features: the final parameters
|Δ| ≤ 1e-5·max(1, max|ref|) per tensor, the last epoch's L1 ≤ 1e-5
relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auto_dynamic_deeplab_torch import models as pt_models
from auto_dynamic_deeplab_torch.bridge import load_jax_variables
from auto_dynamic_deeplab_torch.data import DataLoader as PtLoader
from auto_dynamic_deeplab_torch.data import SyntheticSegmentation as PtSynthetic
from auto_dynamic_deeplab_torch.train.edm_trainer import make_edm_dataset, train_edm
from auto_dynamic_deeplab_tpu import models as jx_models
from auto_dynamic_deeplab_tpu.nas import AUTODEEPLAB_GENOTYPE
from auto_dynamic_deeplab_tpu.ops.confidence import normalized_shannon_entropy as jx_entropy
from auto_dynamic_deeplab_tpu.train.edm_trainer import train_edm as jx_train_edm

from torch_port_helpers import flax_variables

PATH, C_INDEX, NCLS, F, HW = [1, 2, 2, 2, 3, 2], [1], 7, 4, (33, 65)


@pytest.fixture(scope="module")
def tiny():
    jm = jx_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5)
    v = flax_variables(jm, jnp.zeros((1, *HW, 3)), train=False, seed=5)
    return load_jax_variables(pt_models.ADD(PATH, C_INDEX, AUTODEEPLAB_GENOTYPE, NCLS, F=F, B=5), v)


def _loader(n=5):
    return PtLoader(PtSynthetic(n, HW, NCLS), 1, shuffle=False, num_workers=1)


@pytest.fixture(scope="module")
def dataset(tiny, tmp_path_factory):
    cache = tmp_path_factory.mktemp("edm_cache")
    return make_edm_dataset(tiny, _loader(), NCLS, cache_dir=str(cache), device="cpu"), cache


def test_make_edm_dataset_matches_the_model_and_jax_entropy(tiny, dataset):
    (features, entropies), cache = dataset
    assert features.dtype == entropies.dtype == np.float32
    assert features.shape == (5, 3, 5, tiny.feature_channels(tiny.exit_layers[0])) and entropies.shape == (5,)
    with torch.inference_mode():
        for i, batch in enumerate(_loader()):
            logits, feature = tiny.get_feature(torch.as_tensor(batch["image"]))
            np.testing.assert_array_equal(features[i], feature.permute(0, 2, 3, 1)[0].numpy())
            want = float(jx_entropy(jnp.asarray(logits.numpy()), NCLS)[0])
            assert abs(entropies[i] - want) <= 1e-6, (i, entropies[i], want)
    key = "arch122232_F4_B5"  # the JAX package's cache key: arch digits, F, B
    for name in (f"feature_{key}.npy", f"entropy_{key}.npy"):
        assert os.path.exists(cache / name), name
    again = make_edm_dataset(tiny, None, NCLS, cache_dir=str(cache), device="cpu")  # from the cache
    np.testing.assert_array_equal(again[0], features)
    capped = make_edm_dataset(tiny, _loader(), NCLS, max_items=2, device="cpu")
    np.testing.assert_array_equal(capped[1], entropies[:2])


def test_train_edm_matches_jax(dataset):
    (features, entropies), _ = dataset
    kw = dict(epochs=3, batch_size=2, lr=1e-3, seed=0)
    _, ref_vars, ref_loss = jx_train_edm(features, entropies, **kw)
    init = jx_models.EDM().init(jax.random.PRNGKey(0), jnp.asarray(features[:1]))
    start = load_jax_variables(pt_models.EDM(features.shape[-1]), init)
    edm, loss = train_edm(features, entropies, device="cpu", edm=start, **kw)
    assert not edm.training
    ref = load_jax_variables(pt_models.EDM(features.shape[-1]), jax.device_get(ref_vars)).state_dict()
    for name, t in edm.state_dict().items():
        err = float((t - ref[name]).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref[name].abs().max())), (name, err)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)


def test_train_edm_small_sets_and_seeded_init(dataset):
    (features, entropies), _ = dataset
    # batch larger than the set: one full batch per epoch, as in JAX
    edm, loss = train_edm(features[:3], entropies[:3], epochs=2, batch_size=16, device="cpu")
    assert np.isfinite(loss)
    again, _ = train_edm(features[:3], entropies[:3], epochs=2, batch_size=16, device="cpu")
    for name, t in edm.state_dict().items():
        assert torch.equal(t, again.state_dict()[name]), name  # seeded: the same EDM twice
    _, nan = train_edm(features, entropies, epochs=0, device="cpu")
    assert np.isnan(nan)
    with pytest.raises(ValueError, match="empty"):
        train_edm(features[:0], entropies[:0], device="cpu")


def test_edm_entry_points_default_to_cuda(tiny, dataset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path is not reachable")
    (features, entropies), _ = dataset
    with pytest.raises(RuntimeError, match="cuda"):
        make_edm_dataset(tiny, _loader(), NCLS)
    with pytest.raises(RuntimeError, match="cuda"):
        train_edm(features, entropies, epochs=1)


def test_dense_init_is_flax_truncated_normal():
    """``init_params`` draws a Dense kernel as flax's default (lecun_normal:
    variance_scaling(1, fan_in, truncated_normal)): a normal truncated at
    ±2σ with σ = sqrt(1/fan_in)/0.87962566. On a 512 x 2048 layer the
    sample variance is within 2% of 1/fan_in and every draw within ±2σ,
    as flax's own draw of the same shape; the EDM's three layers stay
    within ±2σ too."""
    from flax.linen.linear import default_kernel_init

    from auto_dynamic_deeplab_torch.ops.primitives import Dense
    from auto_dynamic_deeplab_torch.utils.initialize import init_params

    fan_in, out = 512, 2048
    sigma = np.sqrt(1.0 / fan_in) / 0.87962566
    port = init_params(Dense(fan_in, out), torch.Generator().manual_seed(0)).kernel.detach().double().numpy()
    ref = np.asarray(default_kernel_init(jax.random.PRNGKey(0), (fan_in, out)), np.float64)
    for draw in (port, ref):
        assert abs(draw.var() * fan_in - 1.0) <= 0.02
        assert abs(draw.mean()) <= 0.01 * np.sqrt(1.0 / fan_in)
        assert np.abs(draw).max() <= 2 * sigma * (1 + 1e-6)
        assert np.abs(draw).max() >= 1.9 * sigma  # the tails reach the cut
    edm = init_params(pt_models.EDM(40), torch.Generator().manual_seed(1))
    for layer in (edm.fc1, edm.fc2, edm.fc3):
        w = layer.kernel.detach().double()
        assert w.abs().max() <= 2 * np.sqrt(1.0 / w.shape[1]) / 0.87962566 * (1 + 1e-6)
