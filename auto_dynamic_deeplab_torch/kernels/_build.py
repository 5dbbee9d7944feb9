"""Build the port's CUDA C++ kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and may include the
shared device code of ``csrc/*.cuh``. At first use it is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the root of the
checkout (git-ignored), under a name keyed by a hash of the source, every
header and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. No PyTorch headers are included, so a build
takes seconds. ptxas's register and spill report is kept beside the
library as ``<name>-<hash>.log``. ``build_variant`` compiles a copy
changed by text substitution, for the scripts that time a kernel with one
part changed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str) -> Dict[str, Path]:
    """``csrc/<name>.cu`` and every header it may include, by file name."""
    paths = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    return {p.name: p for p in paths}


def library_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(name).values()))
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> List[Path]:
    """Compile every source at once, one nvcc each."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]


def build_variant(name: str, subs: Sequence[Tuple[str, str]], out_dir: Path, tag: str) -> Tuple[Path, str]:
    """Compile a copy of ``csrc/<name>.cu`` and the headers, each (old, new)
    of ``subs`` replaced where ``old`` occurs (exactly once over the source
    and the headers), into ``out_dir/<name>_<tag>.so``. Returns the library
    and ptxas's report. Raises when a substitution no longer matches."""
    texts = {f: p.read_text() for f, p in _sources(name).items()}
    for old, new in subs:
        hits = [f for f, text in texts.items() if old in text]
        if len(hits) != 1 or texts[hits[0]].count(old) != 1:
            raise RuntimeError(f"variant {tag}: the kernel's text changed; update the substitution {old[:60]!r}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    src_dir = out_dir / f"{name}_{tag}"
    src_dir.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (src_dir / f).write_text(text)
    so = out_dir / f"{name}_{tag}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src_dir / f"{name}.cu")], check=True,
                          capture_output=True, text=True)
    return so, proc.stdout + proc.stderr
