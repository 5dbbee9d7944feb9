"""ctypes binding of the port's Zstandard decoder
(``auto_dynamic_deeplab_torch/csrc/zstd_decode.cpp``, written from RFC
8878), with the CRC-32C that OCDBT's envelopes carry.

At first use the source is compiled with ``g++`` into
``build/torch_kernels/`` at the root of the checkout (git-ignored), under a
name keyed by a hash of the source and the flags. There is no fallback: when
the build fails, every call raises with the compiler's message, and
``ADD_TPU_NATIVE`` does not switch it off. A corrupt or truncated input
raises ``ValueError`` and never returns bytes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "zstd_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_ERR_CAP = 512


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"zstd_decode-{digest.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the zstd decoder needs g++ to build: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (code {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
    lib.zstd_decode.restype = ctypes.c_int64
    lib.zstd_take.argtypes = [ctypes.c_void_p]
    lib.zstd_take.restype = None
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def decompress_array(data: bytes, limit: int = 0) -> np.ndarray:
    """Every frame of ``data`` decoded, as a uint8 array; ``limit`` > 0
    caps the decoded size (beyond it: ValueError)."""
    lib = get_lib()
    err = ctypes.create_string_buffer(_ERR_CAP)
    n = lib.zstd_decode(data, len(data), limit, err, _ERR_CAP)
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    out = np.empty(n, np.uint8)
    lib.zstd_take(out.ctypes.data)
    return out


def decompress(data: bytes, limit: int = 0) -> bytes:
    """Every frame of ``data`` decoded (see ``decompress_array``)."""
    return decompress_array(data, limit).tobytes()


def crc32c(data: bytes) -> int:
    return int(get_lib().crc32c(data, len(data)))
