"""Read the JAX package's orbax checkpoints without orbax, tensorstore or
zstandard: numpy, the standard library and the port's own Zstandard decoder
(``utils/zstd.py``).

The JAX package saves every checkpoint with orbax's ``StandardCheckpointer``
(orbax-checkpoint 0.11, utils/saver.py there): a directory holding

  * ``_METADATA``: JSON. ``tree_metadata`` names every leaf of the saved
    tree: its ``key_metadata`` (each key with ``key_type`` 1, a sequence
    index, or 2, a dict key) and its ``value_metadata`` (``value_type``;
    ``skip_deserialize`` for a ``None`` leaf, such as an optax
    ``EmptyState``). ``use_ocdbt`` must be true and ``use_zarr3`` false;
    ``store_array_data_equal_to_fill_value`` says whether a chunk equal to
    the fill value may be missing.
  * ``manifest.ocdbt`` and the files under ``d/`` and ``ocdbt.process_*/d/``:
    one OCDBT key-value store (tensorstore's on-disk B-tree). The manifest
    and every B-tree node are an envelope: the magic (0x0cdb3a2a for the
    manifest, 0x0cdb20de for a node, big-endian), the envelope's length
    (uint64 LE), a varint format version (0), a varint compression (0 none,
    1 zstd), the body and a CRC-32C (uint32 LE) of everything before it.
    The manifest's body is the config (16-byte uuid, manifest kind,
    max inline value bytes, max decoded node bytes, version tree arity log2
    as one byte, compression, a zstd level as int32 LE), a data-file table
    and the versions, column by column (generation, root height, the root's
    file, offset and length, three statistics, commit time); the newest
    version's root is read. A node's body is its height (one byte), a
    data-file table and its entries: the keys prefix-coded against the key
    before them, then for a leaf each value's length and kind (0 inline,
    1 a file and offset of an indirect value) and the inline bytes, and for
    an interior node each child's common-prefix length, file, offset,
    length and statistics. Every key under a child starts with the child's
    key cut to that prefix, which the child stores without.
  * Each leaf is a zarr v2 array in that store: ``{path}/.zarray`` (JSON:
    shape, chunks, dtype, ``compressor`` zstd, C order, "." between chunk
    indices) and a chunk per key ``{path}/{i.j...}`` (``{path}/0`` for a
    0-d array), each one zstd frame of the chunk's C-order bytes; ``path``
    is the leaf's keys joined by ".".

``read_orbax_checkpoint`` returns the tree as nested dicts: a dict key as a
``str``, a sequence index as an ``int``, a ``None`` leaf as ``None`` and
every array as numpy. The dtypes read are those the JAX package's
checkpoints hold, float32 and int32, and bfloat16, which numpy lacks and
which comes back as float32 holding the same values. Anything else raises,
naming the leaf: another compressor or filters, zarr v3, a checkpoint
without OCDBT, a numbered manifest, another dtype or order, a corrupt
envelope or chunk. There is no fallback.
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# the zarr dtypes of the JAX package's checkpoints, and bfloat16
DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4"), "bfloat16": np.dtype("<u2")}
ARRAY_TYPES = ("np.ndarray", "jax.Array")


def is_orbax_checkpoint(path: str) -> bool:
    """True when ``path`` is a directory written by orbax (it holds a
    ``_METADATA``)."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, "_METADATA"))


class _Reader:
    """Varints, bytes and fixed-width integers off a body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _envelope(data: bytes, magic: int, what: str, limit: int = 0) -> bytes:
    """The body of a manifest or node envelope, its CRC-32C checked."""
    if len(data) < 17:
        raise ValueError(f"{what}: truncated ({len(data)} bytes)")
    if struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: magic {data[:4].hex()}, want {magic:08x}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"{what}: length {struct.unpack('<Q', data[4:12])[0]} != {len(data)} bytes")
    if zstd.crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, limit)
    raise ValueError(f"{what}: compression {compression}")


def _file_table(r: _Reader) -> List[str]:
    """A data-file table: each path prefix-coded against the one before,
    with the length of its base path (part of the path, not needed here)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data-file prefix beyond the previous path")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    return prefix, r.varints(n)


def _key_bytes(r: _Reader, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: key prefix beyond the previous key")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys


class OcdbtStore:
    """The key-value pairs of an OCDBT store at ``root`` (the newest
    version)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, bytes] = {}
        body = _envelope(self._file("manifest.ocdbt"), MANIFEST_MAGIC, "manifest.ocdbt")
        r = _Reader(body, "manifest.ocdbt")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"manifest.ocdbt: manifest kind {kind} (numbered manifests are not read)")
        r.varint()  # max inline value bytes
        self.max_node_bytes = r.varint()
        r.byte()  # version tree arity log2
        compression = r.varint()
        if compression == 1:
            r.take(4)  # zstd level
        elif compression != 0:
            raise ValueError(f"manifest.ocdbt: compression {compression}")
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            raise ValueError("manifest.ocdbt: no version")
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        r.take(8 * n)  # commit times
        v = generation.index(max(generation))
        self.root_node = (files[file_id[v]], offset[v], length[v], height[v])

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.normpath(os.path.join(self.root, rel))
            if os.path.commonpath([path, self.root]) != self.root:
                raise ValueError(f"OCDBT data file {rel!r} lies outside the checkpoint")
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise ValueError(f"{rel}: [{offset}, {offset + length}) beyond its {len(data)} bytes")
        return data[offset:offset + length]

    def items(self) -> Dict[str, bytes]:
        """Every key (as str) and its value."""
        out: Dict[str, bytes] = {}
        path, offset, length, height = self.root_node
        self._node(path, offset, length, height, b"", out)
        return out

    def _node(self, rel: str, offset: int, length: int, want_height: int, prefix: bytes, out: Dict[str, bytes]):
        what = f"B-tree node {rel}@{offset}"
        r = _Reader(_envelope(self._slice(rel, offset, length), NODE_MAGIC, what, self.max_node_bytes), what)
        height = r.byte()
        if height != want_height:
            raise ValueError(f"{what}: height {height}, its parent says {want_height}")
        files = _file_table(r)
        n = r.varint()
        key_prefix, key_suffix = _keys(r, n)
        if height == 0:
            keys = _key_bytes(r, key_prefix, key_suffix)
            value_length = r.varints(n)
            kinds = [r.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                raise ValueError(f"{what}: value kind {max(kinds)}")
            n_indirect = sum(kinds)
            ref_file, ref_offset = r.varints(n_indirect), r.varints(n_indirect)
            j = 0
            for key, size, kind in zip(keys, value_length, kinds):
                if kind:
                    value = self._slice(files[ref_file[j]], ref_offset[j], size)
                    j += 1
                else:
                    value = r.take(size)
                out[(prefix + key).decode()] = value
            r.end()
            return
        common = r.varints(n)
        keys = _key_bytes(r, key_prefix, key_suffix)
        child_file, child_offset, child_length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        r.end()
        for key, c, f, o, ln in zip(keys, common, child_file, child_offset, child_length):
            self._node(files[f], o, ln, height - 1, prefix + key[:c], out)


def _fill(meta: dict, name: str):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in special:
            raise ValueError(f"{name}: fill_value {value!r}")
        return special[value]
    return value


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_zarr_array(kv: Dict[str, bytes], name: str, missing_is_fill: bool) -> np.ndarray:
    """The zarr v2 array ``name`` of the store ``kv``."""
    try:
        meta = json.loads(kv[f"{name}/.zarray"])
    except KeyError:
        raise ValueError(f"{name}: no {name}/.zarray in the checkpoint") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    compressor = meta.get("compressor") or {}
    if compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {meta.get('compressor')} (only zstd is read)")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']}")
    sep = meta.get("dimension_separator") or "."
    if sep != ".":
        raise ValueError(f"{name}: dimension separator {sep!r}")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{name}: dtype {meta.get('dtype')!r} is not read (only {sorted(DTYPES)})")
    stored = DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: shape {shape} and chunks {chunks}")
    out = np.empty(shape, stored)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * stored.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, index)) or '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if key not in kv:
            if not missing_is_fill:
                raise ValueError(f"{name}: chunk {key} is missing")
            fill = _fill(meta, name)
            if meta["dtype"] == "bfloat16":
                out[region] = (np.asarray(fill, np.float32).view(np.uint32) >> 16).astype(np.uint16)
            else:
                out[region] = fill
            continue
        try:
            raw = zstd.decompress_array(kv[key], chunk_bytes)
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
        if raw.size != chunk_bytes:
            raise ValueError(f"{key}: {raw.size} bytes, want {chunk_bytes}")
        chunk = raw.view(stored).reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return _bf16_to_f32(out)
    return out.astype(stored.newbyteorder("="), copy=False)


def _insert(tree: dict, keys: List[Any], value, name: str):
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"{name}: a leaf and a subtree share a key")
    if keys[-1] in node:
        raise ValueError(f"{name}: two leaves share a key")
    node[keys[-1]] = value


def read_orbax_checkpoint(path: str) -> Dict[Any, Any]:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path`` (see
    the module doc)."""
    with open(os.path.join(path, "_METADATA")) as f:
        metadata = json.load(f)
    if not metadata.get("use_ocdbt", False):
        raise ValueError(f"{path}: use_ocdbt is false (only OCDBT checkpoints are read)")
    if metadata.get("use_zarr3", False):
        raise ValueError(f"{path}: use_zarr3 is true (only zarr v2 is read)")
    if "tree_metadata" not in metadata:
        raise ValueError(f"{path}: _METADATA has no tree_metadata")
    missing_is_fill = not metadata.get("store_array_data_equal_to_fill_value", False)
    kv = OcdbtStore(path).items()
    tree: Dict[Any, Any] = {}
    for entry in metadata["tree_metadata"].values():
        keys = []
        for km in entry["key_metadata"]:
            if km["key_type"] == 1:
                keys.append(int(km["key"]))
            elif km["key_type"] == 2:
                keys.append(str(km["key"]))
            else:
                raise ValueError(f"{path}: key {km['key']!r} of key type {km['key_type']}")
        name = ".".join(str(k) for k in keys)
        value_meta = entry["value_metadata"]
        kind = value_meta.get("value_type")
        if value_meta.get("skip_deserialize") or kind == "None":
            if kind != "None":
                raise ValueError(f"{name}: a skipped leaf of type {kind!r}")
            value: Optional[np.ndarray] = None
        elif kind in ARRAY_TYPES:
            value = read_zarr_array(kv, name, missing_is_fill)
        else:
            raise ValueError(f"{name}: value type {kind!r} is not read")
        _insert(tree, keys, value, name)
    return tree
