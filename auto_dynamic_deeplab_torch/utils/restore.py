"""Restore helpers: a tolerant copy of one state_dict into another
(``copy_state_dict``, utils/restore.py of the JAX package; the reference's
utils/copy_state_dict.py), and a reader of the flax msgpack files that
``flax.serialization.to_bytes`` writes (the trained weights under
artifacts/product_proof/), without flax or the ``msgpack`` package.

``load_flax_msgpack`` returns the tree as nested dicts of numpy arrays,
ready for ``bridge.load_jax_variables``. It decodes the subset of msgpack
that flax writes: maps, arrays (as lists), str, bin, nil, bool, ints,
floats, and two of flax's ext types: 1, an ndarray packed as the msgpack
triple (shape, dtype name, C-order bytes), and 3, a numpy scalar packed
the same way. Any other ext type, a dtype numpy does not know (bfloat16),
a truncated buffer or trailing bytes raise ``ValueError``.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

# fixed-width formats by their first byte: (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# lengths of str (0xd9-0xdb), bin (0xc4-0xc6), array (0xdc-0xdd), map
# (0xde-0xdf) and ext (0xc7-0xc9): (kind, length format, size)
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
    0xC7: ("ext", ">B", 1), 0xC8: ("ext", ">H", 2), 0xC9: ("ext", ">I", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos} (wants {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt, size = _SIZED[b]
            n = self.unpack(fmt, size)
            if kind == "str":
                return self.str(n)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at byte {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code} (flax writes 1, ndarray, and 3, numpy scalar)")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray ext payload: the msgpack triple (shape, dtype name,
    C-order bytes)."""
    shape, dtype, raw = _decode_one(data)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    try:
        dt = np.dtype(dtype)
    except TypeError as exc:
        raise ValueError(f"unsupported ndarray dtype {dtype!r} in flax msgpack data") from exc
    return np.frombuffer(raw, dtype=dt).reshape(tuple(shape)).copy()


def _decode_one(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the msgpack value")
    return out


def load_flax_msgpack(path_or_bytes: Union[str, os.PathLike, bytes]) -> Any:
    """The tree in a flax msgpack file (or its bytes): nested dicts with
    numpy arrays at the leaves."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return _decode_one(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return _decode_one(f.read())


def load_product_proof(root: Union[str, os.PathLike]) -> Tuple[dict, dict, dict]:
    """(backbone variables, EDM variables, meta.json) of a trained-weights
    directory that scripts/product_proof.py wrote."""
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    return (load_flax_msgpack(os.path.join(root, "backbone.msgpack")),
            load_flax_msgpack(os.path.join(root, "edm.msgpack")), meta)


def copy_state_dict(target, source: Mapping[str, Any], verbose: bool = True) -> Tuple[Any, Dict[str, List[str]]]:
    """Copy every entry of ``source`` whose name and shape match one of
    ``target`` (a module, whose weights are then loaded, or a state_dict),
    report the rest instead of failing. Returns (updated target, report):
    report lists 'missing' (in the target only), 'unexpected' (in the
    source only) and 'mismatched' (present with another shape; the
    target's value is kept)."""
    module = target if isinstance(target, torch.nn.Module) else None
    state = dict(module.state_dict() if module is not None else target)
    report: Dict[str, List[str]] = {"missing": [], "unexpected": [], "mismatched": []}
    for key, leaf in state.items():
        if key not in source:
            report["missing"].append(key)
            continue
        cand = torch.as_tensor(source[key])
        if tuple(cand.shape) != tuple(leaf.shape):
            report["mismatched"].append(f"{key}: {tuple(cand.shape)} vs {tuple(leaf.shape)}")
            continue
        state[key] = cand.to(leaf.device, leaf.dtype)
    report["unexpected"] = [k for k in source if k not in state]
    if verbose:
        for kind in ("missing", "unexpected", "mismatched"):
            for k in report[kind]:
                print(f"copy_state_dict {kind}: {k}")
    if module is not None:
        module.load_state_dict(state)
        return module, report
    return state, report
