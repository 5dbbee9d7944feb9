"""ctypes binding of the native C++ augmentation engine
(``auto_dynamic_deeplab_torch/csrc/augment.cpp``; the same three entry
points as auto_dynamic_deeplab_tpu/data/native.py).

At first use the source is compiled with ``g++ -O3 -march=native`` into
``build/torch_kernels/`` at the root of the checkout (git-ignored), under
a name keyed by a hash of the source, the flags and the host CPU's model
and feature flags, so a library built for one CPU is never loaded on
another. ``available()`` is False when no compiler is there or the build
fails; callers then take the numpy/PIL path. ``ADD_TPU_NATIVE=0`` (the
JAX package's switch) turns the engine off for both packages.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-march=native"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def enabled() -> bool:
    """The switch: ``ADD_TPU_NATIVE`` unset or 1."""
    return os.environ.get("ADD_TPU_NATIVE", "1") == "1"


def cpu_key() -> str:
    """The host CPU as ``-march=native`` sees it: the first ``model name``
    and ``flags`` lines of /proc/cpuinfo (the machine's name elsewhere)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine
    keep = {}
    for line in lines:
        key = line.split(":", 1)[0].strip()
        if key in ("model name", "flags") and key not in keep:
            keep[key] = line
    return "\n".join(keep[k] for k in sorted(keep))


def library_path(cpu: Optional[str] = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update((cpu_key() if cpu is None else cpu).encode())
    return BUILD_DIR / f"augment-{digest.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.augment_train.argtypes = [
        _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, _f32p, _i32p,
    ]
    lib.augment_train.restype = None
    lib.eval_preprocess_full.argtypes = [
        _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, _f32p, _i32p,
    ]
    lib.eval_preprocess_full.restype = None
    lib.encode_labels.argtypes = [_u8p, ctypes.c_int, _u8p, _u8p]
    lib.encode_labels.restype = None
    return lib


def get_lib(strict: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None when the build
    failed (``strict``: raise instead)."""
    global _lib, _failed
    with _lock:
        if _lib is None and (strict or not _failed):
            try:
                _lib = _build()
            except (OSError, RuntimeError):
                _failed = True
                if strict:
                    raise
    return _lib


def available() -> bool:
    return get_lib() is not None


def _required() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native augmentation engine did not build (see native.get_lib(strict=True))")
    return lib


def _image_and_mask(img: np.ndarray, mask: np.ndarray):
    img = np.ascontiguousarray(img, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or mask.shape != img.shape[:2]:
        raise ValueError(f"want an (h, w, 3) image and an (h, w) mask, got {img.shape} and {mask.shape}")
    return img, mask


def augment_train_native(
    img: np.ndarray,
    mask: np.ndarray,
    crop_size: Tuple[int, int],
    mean,
    std,
    scale: float,
    flip: bool,
    crop_i: int,
    crop_j: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale, flip, normalize, pad and crop in one pass. img (h, w, 3)
    uint8, mask (h, w) uint8; the caller draws the geometry."""
    lib = _required()
    img, mask = _image_and_mask(img, mask)
    h, w = img.shape[:2]
    out_img = np.empty((crop_size[0], crop_size[1], 3), np.float32)
    out_mask = np.empty(tuple(crop_size), np.int32)
    lib.augment_train(
        img, mask, h, w, ctypes.c_float(scale), int(flip), int(crop_i), int(crop_j),
        int(crop_size[0]), int(crop_size[1]),
        np.asarray(mean, np.float32), np.asarray(std, np.float32), out_img, out_mask,
    )
    return out_img, out_mask


def eval_full_native(img, mask, out_size, mean, std):
    """Normalize and pad to ``out_size`` (image 0, mask 255)."""
    lib = _required()
    img, mask = _image_and_mask(img, mask)
    h, w = img.shape[:2]
    out_img = np.empty((out_size[0], out_size[1], 3), np.float32)
    out_mask = np.empty(tuple(out_size), np.int32)
    lib.eval_preprocess_full(
        img, mask, h, w, int(out_size[0]), int(out_size[1]),
        np.asarray(mean, np.float32), np.asarray(std, np.float32), out_img, out_mask,
    )
    return out_img, out_mask


def encode_labels_native(raw: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """``lut[raw]`` for a uint8 label image and a 256-entry uint8 table."""
    lib = _required()
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"want a 256-entry table, got {lut.shape}")
    flat = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    out = np.empty_like(flat)
    lib.encode_labels(flat, flat.size, lut, out)
    return out.reshape(raw.shape)
