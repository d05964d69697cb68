"""Orbax checkpoint directories without orbax: the JAX package's
``-ckpt_backend orbax`` checkpoints, read and written by the port.

The JAX package saves ``PREFIX_weights.orbax`` with
``orbax.checkpoint.StandardCheckpointer`` (``mixstage_tpu/bookkeeping.py:
228-250``): a directory holding ``_METADATA`` (JSON: the tree's key paths,
each leaf's kind, ``use_ocdbt``, ``use_zarr3``), ``_CHECKPOINT_METADATA``
(JSON) and the arrays as zarr v2 arrays, one per leaf, named by the leaf's
dotted key path (``model.g_params.gen.decoder0.conv.kernel``): ``<name>/
.zarray`` (JSON: shape, chunks, dtype, compressor) and one value per chunk
(``<name>/0.0``).  Where those values live is the layout:

* **OCDBT** (orbax's default, what JAX writes): one key-value store
  (tensorstore's "optionally-cooperative distributed B+tree").  The root
  ``manifest.ocdbt`` names the latest version's B-tree root; nodes and
  large values sit in data files (``d/<hash>``,
  ``ocdbt.process_0/d/<hash>``).  Every manifest and node is
  ``magic (u32 big-endian) | length (u64) | version | compression |
  body | CRC-32C (u32)``, its body a zstd frame; values of at most
  ``max_inline_value_bytes`` sit inside the leaf nodes, larger ones at an
  offset of a data file.  ``_OcdbtStore`` reads it in plain Python and
  checks every CRC-32C.
* **plain** (``"use_ocdbt": false``): each ``<name>/<chunk>`` is a file.

Chunks are compressed as ``.zarray`` says: JAX writes zstd (level 1),
decoded here by the system's libzstd through ``ctypes``
(``ctypes.util.find_library("zstd")``; without it reading a zstd chunk or
an OCDBT node raises ``RuntimeError`` naming the library).  ``null`` needs
no library.

``write_directory`` writes the plain layout with ``"compressor": null``,
which needs no compression library and which orbax's restore reads (the
JAX package's ``_load_orbax``).  ``read_directory`` returns the tree in
flax's state-dict form, what ``interop/flax_msgpack.py`` returns for the
same checkpoint written as msgpack: nested dicts with string keys (a
tuple's items under ``"0"``, ``"1"`` …), numpy leaves (bfloat16 leaves as
``torch.bfloat16`` tensors), ``{}`` where orbax kept no value (an empty
dict, ``None``, optax's ``EmptyState`` and ``MaskedNode``).  A malformed
directory raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import struct
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
# orbax's tree-metadata key types
KEY_SEQUENCE, KEY_DICT = 1, 2
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


# --------------------------------------------------------------- CRC-32C
def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every OCDBT manifest and
    node."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ------------------------------------------------------------------ zstd
_zstd: Optional[ctypes.CDLL] = None
ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2


def libzstd() -> ctypes.CDLL:
    """The system's libzstd, loaded at first use; ``RuntimeError`` without
    it (no quiet fallback)."""
    global _zstd
    if _zstd is None:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError(
                "libzstd (libzstd.so.1) is not installed: it decodes the "
                "zstd frames of orbax's OCDBT nodes and zarr chunks")
        lib = ctypes.CDLL(name)
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
        _zstd = lib
    return _zstd


class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` / ``ZSTD_outBuffer``: pointer, size, position."""

    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _zstd_check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: zstd: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def _zstd_stream(lib, data: bytes, limit: int, what: str) -> bytes:
    """Decode a frame whose header states no size (a streamed one), at
    most ``limit`` bytes."""
    src = ctypes.create_string_buffer(data, len(data))
    inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    step = 1 << 20
    dst = ctypes.create_string_buffer(step)
    out = bytearray()
    ds = lib.ZSTD_createDStream()
    try:
        _zstd_check(lib, lib.ZSTD_initDStream(ds), what)
        while True:
            outb = _Buffer(ctypes.cast(dst, ctypes.c_void_p), step, 0)
            left = _zstd_check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), what)
            out += dst.raw[:outb.pos]
            if len(out) > limit:
                raise ValueError(f"{what}: zstd frame decodes past "
                                 f"{limit} bytes")
            if left == 0:
                return bytes(out)
            if inb.pos == inb.size and outb.pos < step:
                raise ValueError(f"{what}: truncated zstd frame")
    finally:
        lib.ZSTD_freeDStream(ds)


def zstd_decompress(data: bytes, size: Optional[int], what: str,
                    limit: int = 1 << 31) -> bytes:
    """Decode one zstd frame of ``size`` bytes (``None``: the size the
    frame header states, or for a streamed frame whatever it decodes to,
    at most ``limit``).  ``ValueError`` naming ``what`` when the frame is
    malformed or decodes to another size."""
    lib = libzstd()
    stated = lib.ZSTD_getFrameContentSize(data, len(data))
    if stated == ZSTD_CONTENTSIZE_ERROR:
        raise ValueError(f"{what}: not a zstd frame")
    if size is None:
        if stated == ZSTD_CONTENTSIZE_UNKNOWN:
            return _zstd_stream(lib, data, limit, what)
        size = int(stated)
    out = ctypes.create_string_buffer(max(size, 1))
    n = _zstd_check(lib, lib.ZSTD_decompress(out, size, data, len(data)),
                    what)
    if n != size:
        raise ValueError(f"{what}: zstd frame decodes to {n} bytes, "
                         f"{size} expected")
    return out.raw[:size]


# ----------------------------------------------------------------- OCDBT
class _Body:
    """A cursor over a decoded OCDBT body (LEB128 varints, fixed-width
    little-endian integers); ``ValueError`` naming the file past its
    end."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.take(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _open_envelope(blob: bytes, magic: int, what: str) -> _Body:
    """Check an OCDBT file's header, length and CRC-32C; its body,
    decompressed."""
    if len(blob) < 18:
        raise ValueError(f"{what}: truncated ({len(blob)} bytes)")
    got_magic, length = struct.unpack(">I", blob[:4])[0], \
        struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, "
                         f"{magic:#010x} expected")
    if length != len(blob):
        raise ValueError(f"{what}: truncated (header says {length} bytes, "
                         f"{len(blob)} present)")
    if crc32c(blob[:-4]) != struct.unpack("<I", blob[-4:])[0]:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Body(blob[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    rest = head.data[head.pos:]
    if compression == 0:
        return _Body(rest, what)
    if compression == 1:
        return _Body(zstd_decompress(rest, None, what), what)
    raise ValueError(f"{what}: compression format {compression}")


def _data_file_table(body: _Body) -> List[str]:
    """Paths of the data files a node or manifest refers to, relative to
    the store's root (each entry prefix-compressed against the previous:
    the shared prefix length, the suffix length, the base-path length)."""
    n = body.varint()
    prefix = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    body.varints(n)                       # base-path lengths: not needed
    paths, prev = [], ""
    for i in range(n):
        path = prev[:prefix[i]] + body.take(suffix[i]).decode()
        paths.append(path)
        prev = path
    return paths


def _keys(body: _Body, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + body.varints(n - 1) if n else []
    return prefix, body.varints(n)


class _OcdbtStore:
    """The key-value map of an OCDBT directory at its latest version:
    ``{key: bytes | (data file, offset, length)}``, read eagerly."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[bytes, Any] = {}
        self._files: Dict[str, bytes] = {}
        manifest = os.path.join(root, "manifest.ocdbt")
        body = _open_envelope(self._read(manifest), MANIFEST_MAGIC, manifest)
        body.take(16)                                   # uuid
        kind = body.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: numbered manifests (kind {kind}) "
                             f"are not read")
        body.varint()                                   # max inline bytes
        body.varint()                                   # max node bytes
        body.u8()                                       # version arity log2
        if body.varint() == 1:                          # zstd: its level
            body.i32()
        files = _data_file_table(body)
        n = body.varint()
        if n == 0:
            return                                      # an empty store
        gens = body.varints(n)
        heights = [body.u8() for _ in range(n)]
        ids, offsets, lengths = (body.varints(n) for _ in range(3))
        latest = max(range(n), key=gens.__getitem__)
        if ids[latest] >= len(files):
            raise ValueError(f"{manifest}: data file {ids[latest]} of "
                             f"{len(files)}")
        self._walk(files[ids[latest]], offsets[latest], lengths[latest],
                   heights[latest], b"")

    def _read(self, path: str) -> bytes:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:
            raise ValueError(f"{path}: cannot read ({e})") from e

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            self._files[rel] = self._read(os.path.join(self.root, rel))
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int, what: str) -> bytes:
        blob = self._file(rel)
        if offset + length > len(blob):
            raise ValueError(f"{os.path.join(self.root, rel)}: truncated "
                             f"({what} at {offset}+{length}, file of "
                             f"{len(blob)} bytes)")
        return blob[offset:offset + length]

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{os.path.join(self.root, rel)}@{offset}"
        body = _open_envelope(self._slice(rel, offset, length, "a node"),
                              BTREE_NODE_MAGIC, what)
        if body.u8() != height:
            raise ValueError(f"{what}: node height differs from its "
                             f"parent's record")
        files = _data_file_table(body)
        n = body.varint()
        key_prefix, key_suffix = _keys(body, n)
        if height > 0:
            common = body.varints(n)
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:key_prefix[i]] + body.take(key_suffix[i])
            keys.append(prev)
        if height > 0:
            ids, offsets, lengths = (body.varints(n) for _ in range(3))
            for i in range(n):
                self._walk(self._path(files, ids[i], what), offsets[i],
                           lengths[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        value_len = body.varints(n)
        kinds = body.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: unknown value kind")
        ids = body.varints(len(indirect))
        offsets = body.varints(len(indirect))
        for j, i in enumerate(indirect):
            self.entries[prefix + keys[i]] = (
                self._path(files, ids[j], what), offsets[j], value_len[i])
        for i in range(n):
            if kinds[i] == 0:
                self.entries[prefix + keys[i]] = body.take(value_len[i])

    @staticmethod
    def _path(files: List[str], i: int, what: str) -> str:
        if i >= len(files):
            raise ValueError(f"{what}: data file {i} of {len(files)}")
        return files[i]

    def get(self, key: str) -> Optional[bytes]:
        value = self.entries.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        rel, offset, length = value
        return self._slice(rel, offset, length, f"the value of {key}")


class _PlainStore:
    """orbax's plain layout: a file per key."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.root, key)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


# ------------------------------------------------------------------ zarr
def _dtype(name: str):
    """A zarr v2 dtype: numpy's, or ``bfloat16`` (read as uint16)."""
    if name == "bfloat16":
        return np.dtype("<u2")
    return np.dtype(name)


def _decode_chunk(raw: bytes, compressor, nbytes: int, what: str) -> bytes:
    if compressor is None:
        data = raw
    elif compressor.get("id") == "zstd":
        data = zstd_decompress(raw, nbytes, what)
    else:
        raise ValueError(f"{what}: compressor {compressor.get('id')!r} is "
                         f"not read (zstd or none)")
    if len(data) != nbytes:
        raise ValueError(f"{what}: truncated chunk ({len(data)} of "
                         f"{nbytes} bytes)")
    return data


def _read_array(store, name: str, where: str):
    zarray = store.get(f"{name}/.zarray")
    if zarray is None:
        raise ValueError(f"{where}: no array {name} (its .zarray is missing)")
    try:
        meta = json.loads(zarray)
        shape, chunks = list(meta["shape"]), list(meta["chunks"])
        dtype_name = meta["dtype"]
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{where}: {name}/.zarray is malformed ({e})") from e
    if meta.get("zarr_format", 2) != 2 or meta.get("filters") or \
            meta.get("order", "C") != "C":
        raise ValueError(f"{where}: {name} is not a plain C-ordered zarr v2 "
                         f"array")
    dtype = _dtype(dtype_name)
    out = np.empty(shape, dtype)
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = sep.join(str(i) for i in index) if index else "0"
        raw = store.get(f"{name}/{key}")
        if raw is None:          # orbax stores every chunk, fill values too
            raise ValueError(f"{where}: chunk {name}/{key} is missing")
        data = _decode_chunk(raw, meta.get("compressor"), nbytes,
                             f"{where}: {name}/{key}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ------------------------------------------------------------------ read
def read_directory(path: str) -> Dict[str, Any]:
    """The whole tree of an orbax checkpoint directory (either layout), in
    flax's state-dict form (see the module docstring)."""
    meta_path = os.path.join(path, METADATA)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        leaves = meta["tree_metadata"]
    except OSError as e:
        raise ValueError(f"{meta_path}: cannot read ({e})") from e
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{meta_path}: malformed orbax metadata "
                         f"({e})") from e
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: zarr v3 arrays are not read")
    store = (_OcdbtStore(path) if meta.get("use_ocdbt", True)
             else _PlainStore(path))
    tree: Dict[str, Any] = {}
    for entry in leaves.values():
        try:
            keys = [str(k["key"]) for k in entry["key_metadata"]]
            value_meta = entry["value_metadata"]
        except (KeyError, TypeError) as e:
            raise ValueError(f"{meta_path}: malformed leaf entry "
                             f"({e})") from e
        if value_meta.get("skip_deserialize"):
            value = {}
        else:
            value = _read_array(store, ".".join(keys), path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def array_leaves(tree, path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[str, np.ndarray, str]]:
    """(dotted key path, the array's bytes as C-ordered numpy, dtype name)
    of every array of a ``read_directory`` tree; a bfloat16 leaf's bytes
    as uint16."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from array_leaves(v, path + (str(k),))
    elif torch.is_tensor(tree):
        yield ".".join(path), tree.contiguous().view(torch.int16).numpy() \
            .view("<u2"), "bfloat16"
    else:
        arr = np.asarray(tree, order="C")
        yield ".".join(path), arr, arr.dtype.name


# ----------------------------------------------------------------- write
def _flatten(tree, path=(), kinds=()
             ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], Any]]:
    """(keys, key types, leaf) of a tree of dicts (and named tuples'
    fields as dicts) and tuples; ``None`` and an empty dict are leaves."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),), kinds + (KEY_DICT,))
    elif isinstance(tree, (tuple, list)) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),), kinds + (KEY_SEQUENCE,))
    else:
        yield path, kinds, tree


def _leaf_array(value) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as a C-ordered numpy array and its zarr dtype."""
    if torch.is_tensor(value):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view("<u2"), "bfloat16"
        value = value.numpy()
    arr = np.asarray(value, order="C")      # ascontiguousarray makes 0-d 1-d
    if arr.dtype.name == "bfloat16":                    # ml_dtypes
        return arr.view("<u2"), "bfloat16"
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return arr, arr.dtype.str


def write_directory(path: str, tree) -> None:
    """Write ``tree`` as an orbax checkpoint directory in the plain layout
    (``use_ocdbt`` false, zarr v2, ``"compressor": null``, one chunk per
    array).  ``tree``: nested dicts and tuples (a named tuple as the dict
    of its fields) of arrays (numpy, torch); ``None`` is recorded as orbax
    records an empty named tuple or ``None``, ``{}`` as an empty dict.
    ``path`` must not exist."""
    os.makedirs(path)
    init = time.time_ns()
    leaves: Dict[str, Any] = {}
    for keys, kinds, value in _flatten(tree):
        if not keys:
            raise ValueError("an orbax checkpoint holds a tree, not a leaf")
        meta = {"key_metadata": [{"key": k, "key_type": t}
                                 for k, t in zip(keys, kinds)]}
        if value is None or (isinstance(value, dict) and not value):
            meta["value_metadata"] = {
                "value_type": "None" if value is None else "Dict",
                "skip_deserialize": True}
        else:
            arr, dtype = _leaf_array(value)
            name = os.path.join(path, ".".join(keys))
            os.makedirs(name)
            shape = list(arr.shape)
            with open(os.path.join(name, ".zarray"), "w") as f:
                json.dump({"chunks": [max(s, 1) for s in shape],
                           "compressor": None, "dimension_separator": ".",
                           "dtype": dtype, "fill_value": None,
                           "filters": None, "order": "C", "shape": shape,
                           "zarr_format": 2}, f)
            if arr.size:
                key = ".".join("0" for _ in shape) or "0"
                with open(os.path.join(name, key), "wb") as f:
                    f.write(arr.tobytes())
            meta["value_metadata"] = {"value_type": "np.ndarray",
                                      "skip_deserialize": False}
        leaves[str(tuple(keys))] = meta
    with open(os.path.join(path, METADATA), "w") as f:
        json.dump({"tree_metadata": leaves, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": init,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
