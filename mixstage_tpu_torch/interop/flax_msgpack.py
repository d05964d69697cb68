"""Flax's msgpack checkpoint format, read and written in plain Python.

The port's counterpart of ``flax.serialization.msgpack_restore`` (the
JAX package reads its checkpoints with it, ``mixstage_tpu/bookkeeping.py
:406``) and of ``msgpack_serialize`` (``:174-176``), for the subset of
msgpack that flax writes: maps with str keys, arrays, str (``use_bin_type``),
bin, ints, floats, nil and bool, and flax's ext types:

  1  ndarray         payload: a packed ``[shape, dtype name, C-order bytes]``
  2  native complex  payload: a packed ``[real, imag]``
  3  numpy scalar    payload: as ndarray, unpacked to a 0-d value

An array over ``MAX_CHUNK_SIZE`` bytes is stored as a chunked leaf
(``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
{"0": ..}}``) and rejoined on reading, as flax's
``_unchunk_array_leaves_in_place`` does.

``bfloat16`` leaves carry a dtype name numpy lacks; ``unpackb`` gives them
as ``torch.bfloat16`` tensors made from the raw bytes (a bf16 numpy scalar
as a 0-d tensor), and ``packb`` takes such tensors back (as arrays).
Every other leaf is a numpy array (or a numpy scalar for ext 3).  ``packb`` writes what ``flax.serialization.msgpack_serialize``
writes for the same tree, byte for byte; the package imports no
``msgpack``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_SCALAR = 1, 2, 3


class MsgpackError(ValueError):
    """Bytes that are not the msgpack subset flax writes."""


# --------------------------------------------------------------- reading

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw            # str as bytes (flax's inner ndarray read)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise MsgpackError(f"type byte 0x{b:02x} at offset {self.pos - 1} "
                           f"is not in flax's msgpack subset")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int):
        raw = bytes(self.take(n))
        if self.raw:
            return raw
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"str at offset {self.pos - n}: {e}") from e

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"map key {key!r} is not a str")
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_bytes(payload)
        if code == EXT_SCALAR:
            arr = _array_from_bytes(payload)
            return arr if torch.is_tensor(arr) else arr[()]
        if code == EXT_COMPLEX:
            re, im = _unpack_whole(payload)
            return complex(re, im)
        raise MsgpackError(f"ext type {code} is not one of flax's")


def _unpack_whole(data: bytes, raw: bool = False):
    reader = _Reader(data, raw=raw)
    out = reader.obj()
    if reader.pos != len(data):
        raise MsgpackError(f"{len(data) - reader.pos} bytes after the "
                           f"object")
    return out


def _array_from_bytes(payload: bytes):
    shape, name, buf = _unpack_whole(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"dtype {name!r}: {e}") from e
    return np.frombuffer(buf, dtype).reshape(shape)


def _unchunk(tree):
    """Rejoin chunked leaves, as flax's ``_unchunk_array_leaves_in_place``
    (which looks one level into dicts for chunked children, and at the
    tree itself)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and torch.is_tensor(chunks[0]):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def unpackb(data: bytes):
    """The tree of a flax msgpack blob (``msgpack_restore``); raises
    ``MsgpackError`` (a ``ValueError``) on anything else."""
    return _unchunk(_unpack_whole(bytes(data)))


# --------------------------------------------------------------- writing

def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack(">B", n)
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    for lo, hi, head, fmt in ((0x80, 0xFF, 0xCC, ">B"),
                              (-0x80, -1, 0xD0, ">b"),
                              (0x100, 0xFFFF, 0xCD, ">H"),
                              (-0x8000, -0x81, 0xD1, ">h"),
                              (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -0x8001, 0xD2, ">i"),
                              (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -0x80000001, 0xD3,
                               ">q")):
        if lo <= n <= hi:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack")


def _pack_sized(n: int, fix: Tuple[int, int], heads, what: str) -> bytes:
    """The header of a str / bin / array / map of ``n`` items: the fix form
    (``fix`` = (first byte, most items)) or the smallest sized one."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for limit, head, fmt in heads:
        if n <= limit:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"{what} of {n} items does not fit msgpack")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_sized(len(raw), (0xA0, 0x1F),
                       ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"),
                        (0xFFFFFFFF, 0xDB, ">I")), "str") + raw


def _pack_bin(b: bytes) -> bytes:
    return _pack_sized(len(b), None,
                       ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"),
                        (0xFFFFFFFF, 0xC6, ">I")), "bin") + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _pack_sized(n, None, ((0xFF, 0xC7, ">B"), (0xFFFF, 0xC8, ">H"),
                                     (0xFFFFFFFF, 0xC9, ">I")), "ext")
    return head + struct.pack(">b", code) + payload


def _array_bytes(shape, name: str, buf: bytes) -> bytes:
    """``msgpack.packb((shape, name, buf), use_bin_type=True)``."""
    return (_pack_sized(3, (0x90, 0x0F), (), "array")
            + _pack_sized(len(shape), (0x90, 0x0F),
                          ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I")),
                          "array")
            + b"".join(_pack_int(int(s)) for s in shape)
            + _pack_str(name) + _pack_bin(buf))


def _leaf_payload(x) -> bytes:
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _array_bytes(tuple(x.shape), "bfloat16",
                                x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise TypeError("object and structured dtypes are not serializable")
    return _array_bytes(x.shape, x.dtype.name, x.tobytes("C"))


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    flat = x.reshape(-1)
    itemsize = x.element_size() if torch.is_tensor(x) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.numel() if torch.is_tensor(flat) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif type(x) is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_pack_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.append(_pack_str(x))
    elif type(x) is bytes:
        out.append(_pack_bin(x))
    elif type(x) is dict:
        out.append(_pack_sized(len(x), (0x80, 0x0F),
                               ((0xFFFF, 0xDE, ">H"),
                                (0xFFFFFFFF, 0xDF, ">I")), "map"))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif type(x) is list:
        out.append(_pack_sized(len(x), (0x90, 0x0F),
                               ((0xFFFF, 0xDC, ">H"),
                                (0xFFFFFFFF, 0xDD, ">I")), "array"))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray) or torch.is_tensor(x):
        out.append(_pack_ext(EXT_NDARRAY, _leaf_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_pack_ext(EXT_SCALAR, _leaf_payload(np.asarray(x))))
    elif type(x) is complex:
        payload = (_pack_sized(2, (0x90, 0x0F), (), "array")
                   + b"\xcb" + struct.pack(">d", x.real)
                   + b"\xcb" + struct.pack(">d", x.imag))
        out.append(_pack_ext(EXT_COMPLEX, payload))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _sorted(tree):
    """A copy of ``tree`` with every map in sorted key order, as the tree
    copy of ``msgpack_serialize`` (``jax.tree_util.tree_map``) leaves it."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _chunk_leaves(tree):
    """Oversized array leaves as chunked dicts (flax's
    ``_chunk_array_leaves_in_place``, on a copy)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if (isinstance(tree, np.ndarray) or torch.is_tensor(tree)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree) -> bytes:
    """Flax msgpack of ``tree`` (dicts with str keys, lists, Python
    scalars, numpy arrays and scalars, tensors): the bytes that
    ``flax.serialization.msgpack_serialize`` writes for the same tree, its
    maps in sorted key order as that function's tree copy leaves them."""
    out: list = []
    _pack(_chunk_leaves(_sorted(tree)), out)
    return b"".join(out)


def is_flax_msgpack(head: bytes) -> bool:
    """Whether a file's first byte opens a msgpack map (flax writes a
    checkpoint as one): a fixmap, map16 or map32."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
