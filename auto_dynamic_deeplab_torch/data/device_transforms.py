"""On-device input preprocessing (auto_dynamic_deeplab_tpu/data/
device_transforms.py in torch ops on the tensors' own device): the host
uploads raw uint8 pixels, the card flips, scales, crops, normalizes and
pads them.

  train:  random hflip → random log-uniform scale [0.5, 2] → normalize →
          zero-pad (mask 255) → random crop
  eval:   normalize → pad to the eval canvas

The scaled image is never materialized. For a fixed output crop, flip,
scale, crop and pad compose into an affine index map per axis, so the
augmentation is two separable bilinear gathers (``index`` along rows, then
along columns) over the whole batch at once; the four augmentation
scalars of each sample enter as tensors. Bilinear replaces the host
path's LANCZOS (exact at scale 1); labels sample nearest, with 255
outside the image; pad pixels are 0 in normalized space.

``sample_augment_params`` draws (flip, scale, i, j) on the host in the
draw order of ``transforms.train_preprocess_native``, so seeded runs are
comparable across the host, native and device engines.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from .transforms import CITYSCAPES_MEAN, CITYSCAPES_STD, IGNORE_LABEL

INV_255 = float(np.float32(1.0) / np.float32(255.0))


def sample_augment_params(
    src_hw: Tuple[int, int],
    crop_size: Tuple[int, int],
    scale: float = 0.0,
    rng: Optional[np.random.RandomState] = None,
):
    """One sample's (scale, flip, crop i, crop j), drawn in the order
    flip, scale (when ``scale`` is 0), i, j."""
    rng = rng or np.random
    h, w = src_hw
    flip = rng.random_sample() < 0.5
    if scale == 0.0:
        lo, hi = math.log(0.5, 2), math.log(2.0, 2)
        s = 2.0 ** (lo + rng.random_sample() * (hi - lo))
    else:
        s = scale
    nh, nw = int(round(h * s)), int(round(w * s))
    pad_h, pad_w = max(nh, crop_size[0]), max(nw, crop_size[1])
    i = rng.randint(0, pad_h - crop_size[0] + 1)
    j = rng.randint(0, pad_w - crop_size[1] + 1)
    return np.float32(s), bool(flip), np.int32(i), np.int32(j)


def _axis_indices(out_len: int, off, scale, src_len: int, flip):
    """Bilinear source indices and weights along one axis for output pixels
    [off, off + out_len) of each sample's virtually scaled (and optionally
    flipped) image: (i0, i1, frac, valid), each (N, out_len)."""
    dst = torch.arange(out_len, dtype=torch.float32, device=off.device)[None] + off.float()[:, None]
    s = scale[:, None]
    # pixel-centre convention (PIL): src = (dst + 0.5) / s - 0.5
    src = (dst + 0.5) / s - 0.5
    src = torch.where(flip[:, None], (src_len - 1) - src, src)
    valid = dst < torch.round(src_len * s)  # inside the scaled image
    src = src.clamp(0.0, float(src_len - 1))  # border replicate
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=src_len - 1)
    return i0, i1, src - i0.float(), valid


def _normalize(x: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor) -> torch.Tensor:
    """(x / 255 - mean) / std in the JAX program's arithmetic (XLA on the
    CPU): x·fl(1/255) - mean rounded once, as a fused multiply-add (exact
    in float64 before the rounding), then · fl(1/std)."""
    return (x.double() * INV_255 - mean.double()).float() * inv_std


def _augment(images, masks, scales, flips, offs_i, offs_j, crop, mean, inv_std):
    """(N, H, W, 3) uint8 + (N, H, W) uint8 → (N, ch, cw, 3) f32 + (N, ch, cw) i64."""
    n, h, w = images.shape[:3]
    ch, cw = crop
    no_flip = torch.zeros_like(flips)
    y0, y1, fy, vy = _axis_indices(ch, offs_i, scales, h, no_flip)
    x0, x1, fx, vx = _axis_indices(cw, offs_j, scales, w, flips)
    b = torch.arange(n, device=images.device)[:, None]

    # rows first (gather along H), then columns
    rows = images[b, y0].float() * (1.0 - fy)[..., None, None] + images[b, y1].float() * fy[..., None, None]

    def cols(t, idx):  # t (N, ch, W, ...) → (N, ch, cw, ...)
        index = idx[:, None, :].expand(n, ch, cw)
        if t.dim() == 4:
            index = index[..., None].expand(n, ch, cw, t.shape[3])
        return t.gather(2, index)

    out = cols(rows, x0) * (1.0 - fx)[:, None, :, None] + cols(rows, x1) * fx[:, None, :, None]
    out = _normalize(out, mean, inv_std)
    valid = vy[:, :, None] & vx[:, None, :]
    out = torch.where(valid[..., None], out, torch.zeros((), device=out.device))

    # nearest for labels
    my = torch.where(fy >= 0.5, y1, y0)
    mx = torch.where(fx >= 0.5, x1, x0)
    m = cols(masks[b, my], mx).long()
    m = torch.where(valid, m, torch.full((), IGNORE_LABEL, dtype=m.dtype, device=m.device))
    return out, m


def _upload(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor on ``device``, uint8 kept uint8."""
    t = torch.as_tensor(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)


def make_train_augment(
    src_hw: Tuple[int, int],
    crop_size: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
    device="cuda",
):
    """fn(images_u8 (N, H, W, 3), masks_u8 (N, H, W), scales (N,), flips
    (N,) bool, offs_i (N,), offs_j (N,)) → (images (N, ch, cw, 3) f32 NHWC,
    labels (N, ch, cw) int64) on ``device`` (cuda unless the caller asks
    for the CPU). Host inputs are uploaded as they are: uint8 pixels, not
    float32."""
    dev = resolve_device(device)
    crop = tuple(int(v) for v in crop_size)
    mean_t = torch.tensor(np.asarray(mean, np.float32), device=dev)
    inv_std = torch.tensor(1.0 / np.asarray(std, np.float32), device=dev)

    def augment(images, masks, scales, flips, offs_i, offs_j):
        images, masks = _upload(images, dev), _upload(masks, dev)
        if images.dtype != torch.uint8 or masks.dtype != torch.uint8:
            raise TypeError(f"want uint8 images and masks, got {images.dtype} and {masks.dtype}")
        return _augment(
            images, masks, _upload(scales, dev, torch.float32), _upload(flips, dev, torch.bool),
            _upload(offs_i, dev, torch.int32), _upload(offs_j, dev, torch.int32), crop, mean_t, inv_std,
        )

    return augment


def make_eval_preprocess(
    src_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    mean=CITYSCAPES_MEAN,
    std=CITYSCAPES_STD,
    device="cuda",
):
    """fn(images_u8, masks_u8) → normalized images padded to ``out_hw``
    (0) and int64 masks (255) on ``device``: e.g. 1024x2048 → 1025x2049
    (custom_transforms.py:322-347)."""
    dev = resolve_device(device)
    h, w = src_hw
    ph, pw = max(0, out_hw[0] - h), max(0, out_hw[1] - w)
    mean_t = torch.tensor(np.asarray(mean, np.float32), device=dev)
    inv_std = torch.tensor(1.0 / np.asarray(std, np.float32), device=dev)

    def preprocess(images, masks):
        x = _normalize(_upload(images, dev).float(), mean_t, inv_std)
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
        m = torch.nn.functional.pad(_upload(masks, dev).long(), (0, pw, 0, ph), value=IGNORE_LABEL)
        return x, m

    return preprocess


def augment_batch(
    augment_fn,
    images_u8,
    masks_u8,
    src_hw: Tuple[int, int],
    crop_size: Tuple[int, int],
    scale: float = 0.0,
    rngs=None,
):
    """Draw each sample's parameters on the host (``rngs``: one
    RandomState a sample, the loader's per-item streams, or None for
    numpy's global one) and run ``augment_fn`` on the batch."""
    n = images_u8.shape[0]
    params = [
        sample_augment_params(src_hw, crop_size, scale=scale, rng=(rngs[k] if rngs is not None else None))
        for k in range(n)
    ]
    s, f, i, j = (np.asarray([p[k] for p in params]) for k in range(4))
    return augment_fn(images_u8, masks_u8, s.astype(np.float32), f.astype(bool), i.astype(np.int32),
                      j.astype(np.int32))
