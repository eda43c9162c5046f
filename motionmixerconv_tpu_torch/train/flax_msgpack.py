"""The subset of msgpack that flax writes, read and written without the
``msgpack`` package.

Counterpart of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize`` as the JAX package's ``train/state.py`` uses them for
its ``.ckpt`` blobs. The card's machine has no ``msgpack`` and no
``ml_dtypes``, so this module decodes and encodes the format itself, in
plain Python and numpy:

- maps with str keys, arrays (read as lists), nil, bool, ints, float32 and
  float64, str and bin;
- ext 1: an ndarray, whose payload is a msgpack array ``[shape, dtype
  name, C-order bytes]``; ext 3: a numpy scalar with the same payload;
  ext 2: a complex, ``[real, imag]``;
- a ``bfloat16`` leaf (no numpy dtype without ``ml_dtypes``) is read from
  its raw bytes as a ``torch.bfloat16`` tensor, and such a tensor is
  written as one;
- a ``__msgpack_chunked_array__`` map (flax splits arrays over 2**30
  bytes) is joined back together, and such arrays are split on writing.

Anything else (another ext code or dtype, a non-str map key, trailing or
truncated bytes) raises ``ValueError`` naming what it met: nothing is
guessed. The writer follows msgpack-python's packer byte for byte (the
smallest header for each int, str, bin, array, map and ext), so flax's own
encoding of the same tree is the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit on one array leaf's bytes
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
# the array dtypes read as numpy arrays: numpy's own numeric types (a name
# that ml_dtypes adds to numpy, where it is loaded, is refused all the same)
NUMPY_DTYPES = frozenset(
    ["bool", "float16", "float32", "float64", "complex64", "complex128"]
    + [f"{u}int{b}" for u in ("", "u") for b in (8, 16, 32, 64)])


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes: flax reads an ext payload so

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(needs {n} more of {len(self.data)})")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, at)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return self.take(self.unpack((">B", ">H", ">I")[b - 0xc4]))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack((">B", ">H", ">I")[b - 0xc7])
            return self.ext(n, at)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xd9]))
        if b in (0xdc, 0xdd):
            n = self.unpack((">H", ">I")[b - 0xdc])
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack((">H", ">I")[b - 0xde]), at)
        raise ValueError(f"msgpack: byte 0x{b:02x} at {at} is not a type "
                         "flax writes")

    def str(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map at byte {at} has a "
                                 f"{type(key).__name__} key {key!r}; flax "
                                 "writes str keys")
            out[key] = self.value()
        return out

    def ext(self, n: int, at: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from_bytes(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            re, im = _decode(payload, raw=False)
            return complex(re, im)
        raise ValueError(f"msgpack: ext type {code} at byte {at} is not one "
                         "flax writes (1 ndarray, 2 complex, 3 numpy scalar)")


def _decode(data: bytes, raw: bool) -> Any:
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         f"left after the value ending at byte {reader.pos}")
    return out


def _array_from_bytes(payload: bytes):
    """flax's ``_ndarray_from_bytes``: a numpy array, or a torch.bfloat16
    tensor for a bfloat16 leaf."""
    parts = _decode(payload, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3
            and isinstance(parts[0], list) and isinstance(parts[2], bytes)):
        raise ValueError("msgpack: an ndarray payload is [shape, dtype name, "
                         f"bytes], got {type(parts).__name__}")
    shape, name, buf = parts
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        if not buf:  # frombuffer refuses an empty buffer
            return torch.empty(shape, dtype=torch.bfloat16)
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    if name not in NUMPY_DTYPES:
        raise ValueError(f"msgpack: ndarray dtype {name!r} is not numpy's "
                         "own numeric type or bfloat16")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps back into
    arrays, at the top and in nested maps."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """The tree flax's ``msgpack_restore`` gives for ``data``: dicts, lists,
    Python scalars, numpy arrays and scalars, and torch.bfloat16 tensors
    where flax gives ml_dtypes bfloat16 arrays."""
    return _unchunk_leaves(_decode(bytes(data), raw=False))


# ---------------------------------------------------------------- writing


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: fix | n up to ``fix_max``, else the first of
    ``codes`` (8-, 16- or 32-bit length; None where the type has none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif 0 <= v <= 0xffffffffffffffff:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
    elif v >= -0x8000000000000000:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
    else:
        raise ValueError(f"msgpack: int {v} does not fit 64 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += data


def _array_payload(x) -> bytes:
    """flax's ``_ndarray_to_bytes`` of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _encode((list(x.shape), "bfloat16",
                            x.view(torch.int16).numpy().tobytes()))
        x = x.numpy()
    if x.dtype.name not in NUMPY_DTYPES:
        raise ValueError(f"msgpack: cannot write an array of dtype {x.dtype}")
    return _encode((list(x.shape), x.dtype.name, x.tobytes("C")))


def _pack(out: bytearray, x) -> None:
    t = type(x)  # exact types, as flax's packb(strict_types=True)
    if x is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if x else 0xc2)
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif t is str:
        raw = x.encode("utf-8")
        _header(out, len(raw), 0xa0, 0x1f, (0xd9, 0xda, 0xdb))
        out += raw
    elif t in (bytes, bytearray):
        _header(out, len(x), None, 0, (0xc4, 0xc5, 0xc6))
        out += x
    elif t in (list, tuple):
        _header(out, len(x), 0x90, 0x0f, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _header(out, len(x), 0x80, 0x0f, (None, 0xde, 0xdf))
        for k, v in x.items():
            if type(k) is not str:
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif t is complex:
        _pack_ext(out, EXT_COMPLEX, _encode((x.real, x.imag)))
    else:
        raise ValueError(f"msgpack: cannot write a {t.__name__}")


def _encode(x) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array split into MAX_CHUNK_SIZE pieces."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(d):
    """A copy of the dict tree with arrays over MAX_CHUNK_SIZE bytes
    chunked (flax's ``_chunk_array_leaves_in_place``)."""
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    if isinstance(d, (np.ndarray, torch.Tensor)) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(tree) -> bytes:
    """``tree`` (dicts with str keys; lists, tuples, Python scalars, numpy
    arrays and scalars, torch tensors) as the bytes flax's
    ``msgpack_serialize`` writes."""
    return _encode(_chunk_leaves(tree))
