"""A small MessagePack reader and writer for flax's ``params.msgpack``.

The JAX package stores a U-Net's parameters with
``flax.serialization.to_bytes``: a MessagePack map of maps whose leaves are
ndarrays packed as extension type 1, the payload being the MessagePack array
``[shape, dtype name, raw C-order bytes]``.  The port reads and writes that
format itself, so that one checkpoint directory serves both packages; the
card's host has neither ``msgpack`` nor ``flax``.

The writer emits the bytes the ``msgpack`` package's packer emits for the
same tree (the smallest header for each size, floats as 64-bit, strings as
str and bytes as bin).  Covered types: maps, arrays, strings, bin, ints,
floats, nil, booleans and ext; the ndarray payload may name ``bfloat16``,
which numpy lacks: such leaves come back as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

NDARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray


class ExtType:
    """An extension value: a type code and its raw payload."""

    def __init__(self, code: int, data: bytes):
        self.code = int(code)
        self.data = bytes(data)


def _header(out: bytearray, n: int, small, codes) -> None:
    """A length header: ``small`` (base, limit) for the fix form, then one
    code each for 8-, 16- and 32-bit lengths (None where the form has none)."""
    base, limit = small
    if n < limit:
        out.append(base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v < 0x80:
            out.append(v)
        elif -32 <= v < 0:
            out.append(v & 0xFF)
        elif v >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if v < top:
                    out.append(code)
                    out += struct.pack(fmt, v)
                    return
            raise OverflowError(f"integer {v} does not fit 64 bits")
        else:
            for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                   (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if v >= low:
                    out.append(code)
                    out += struct.pack(fmt, v)
                    return
            raise OverflowError(f"integer {v} does not fit 64 bits")
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCB)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), (0, 0), (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, ExtType):
        n = len(obj.data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _header(out, n, (0, 0), (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code)
        out += obj.data
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack(ExtType(NDARRAY_EXT, ndarray_to_bytes(obj)), out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of ``obj``; ndarray and tensor leaves become flax's
    ndarray extension."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        raw = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return raw

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext_hook(code: int, data: bytes):
    if code == NDARRAY_EXT:
        return ndarray_from_bytes(data)
    return ExtType(code, data)


def unpackb(data: bytes) -> Any:
    """The value packed in ``data``; flax's ndarray extension comes back as a
    numpy array (a ``torch.bfloat16`` tensor for bfloat16 leaves)."""
    reader = _Reader(data, _ext_hook)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the MessagePack value")
    return out


def ndarray_to_bytes(arr) -> bytes:
    """flax's ndarray payload: ``[shape, dtype name, C-order bytes]``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serialisable")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def ndarray_from_bytes(data: bytes):
    shape, name, raw = _Reader(data, _ext_hook).value()
    shape: Tuple[int, ...] = tuple(int(s) for s in shape)
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
