"""Chunked-array storage: local zarr v2 and n5 directory stores.

The port's own copy of the part of ``cluster_tools_tpu/utils/store.py`` the
watershed path needs, with the same on-disk formats, so a volume written by
either package is read by the other:

  * ``.zarr`` → zarr v2 (``.zarray``, ``i.j.k`` chunk files, raw/zlib/gzip);
  * ``.n5``   → n5 (``attributes.json``, reversed dimension order, big-endian
    mode-0 chunks, raw/gzip);
  * region read/write (read-modify-write on partially covered chunks),
    ``read_chunk`` / ``write_chunk``;
  * ``RaggedDataset``: one ``.npy`` array per grid position (the per-block
    side outputs such as the watershed's max ids).

Gzip is deterministic (level 1, mtime 0), so equal arrays give equal chunk
bytes.  Blosc, hdf5, the object-store backend and the decoded-chunk cache are
not ported yet (ROADMAP Queue A); opening a dataset that needs them raises.
Parallel writers must write disjoint chunk-aligned regions.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import shutil
import struct
import threading
import zlib
from itertools import product
from typing import Any, Optional, Sequence

import numpy as np

from .blocking import _ceil_div

__all__ = ["file_reader", "File", "Group", "Dataset", "RaggedDataset", "atomic_write_bytes"]


def atomic_write_bytes(path: str, payload: bytes) -> None:
    """tmp file (unique per process and thread) + fsync + ``os.replace``."""
    tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=2).encode())


def _gzip_compress(raw: bytes) -> bytes:
    return gzip.compress(raw, 1, mtime=0)


def _unsupported_codec(what: str, path: str):
    return NotImplementedError(
        f"{what} in {path}: the PyTorch port's store reads raw, zlib and gzip "
        "chunks only (blosc is ROADMAP Queue A work)"
    )


class _ZarrFormat:
    array_meta = ".zarray"
    group_meta = ".zgroup"

    @staticmethod
    def chunk_key(grid_pos, separator: str = ".") -> str:
        return separator.join(str(p) for p in grid_pos)

    @staticmethod
    def write_meta(path, shape, chunks, dtype: np.dtype, compression) -> None:
        _write_json(os.path.join(path, _ZarrFormat.array_meta), {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": dtype.str,
            "compressor": None if compression is None else {"id": "zlib", "level": 1},
            "fill_value": 0,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        })

    @staticmethod
    def read_meta(path: str):
        meta = _read_json(os.path.join(path, _ZarrFormat.array_meta))
        comp = meta.get("compressor")
        if comp is None:
            compression = None
        elif comp.get("id") in ("zlib", "gzip"):
            compression = comp["id"]
        else:
            raise _unsupported_codec(f"zarr compressor {comp.get('id')!r}", path)
        if meta.get("filters"):
            raise ValueError(f"zarr filters are not supported ({path})")
        if meta.get("order", "C") != "C":
            raise ValueError(f"only C-order zarr arrays are supported ({path})")
        fill = meta.get("fill_value", 0)
        return {
            "shape": tuple(meta["shape"]),
            "chunks": tuple(meta["chunks"]),
            "dtype": np.dtype(meta["dtype"]),
            "compression": compression,
            "separator": meta.get("dimension_separator", "."),
            "fill_value": 0 if fill is None else fill,
        }

    @staticmethod
    def encode_chunk(data: np.ndarray, chunks, compression) -> bytes:
        # zarr v2 stores edge chunks at full chunk shape, padded with zeros
        if tuple(data.shape) != tuple(chunks):
            full = np.zeros(chunks, dtype=data.dtype)
            full[tuple(slice(0, s) for s in data.shape)] = data
            data = full
        raw = np.ascontiguousarray(data).tobytes()
        if compression == "gzip":
            return _gzip_compress(raw)
        return zlib.compress(raw, 1) if compression else raw

    @staticmethod
    def decode_chunk(payload: bytes, chunk_shape, dtype: np.dtype, compression):
        if compression == "gzip":
            payload = gzip.decompress(payload)
        elif compression:
            payload = zlib.decompress(payload)
        return np.frombuffer(payload, dtype=dtype).reshape(chunk_shape)

    @staticmethod
    def is_array(path: str) -> bool:
        return os.path.exists(os.path.join(path, _ZarrFormat.array_meta))

    @staticmethod
    def init_group(path: str) -> None:
        _write_json(os.path.join(path, _ZarrFormat.group_meta), {"zarr_format": 2})


class _N5Format:
    array_meta = "attributes.json"
    group_meta = "attributes.json"

    _DTYPES = {
        "uint8": "|u1", "uint16": ">u2", "uint32": ">u4", "uint64": ">u8",
        "int8": "|i1", "int16": ">i2", "int32": ">i4", "int64": ">i8",
        "float32": ">f4", "float64": ">f8",
    }

    @staticmethod
    def chunk_key(grid_pos, separator: str = "/") -> str:
        return os.path.join(*[str(p) for p in reversed(tuple(grid_pos))])

    @staticmethod
    def write_meta(path, shape, chunks, dtype: np.dtype, compression) -> None:
        meta_path = os.path.join(path, _N5Format.array_meta)
        meta = _read_json(meta_path) if os.path.exists(meta_path) else {}
        meta.update({
            "dimensions": list(reversed(shape)),
            "blockSize": list(reversed(chunks)),
            "dataType": dtype.name,
            "compression": {"type": "raw"} if compression is None
            else {"type": "gzip", "level": 1},
        })
        _write_json(meta_path, meta)

    @staticmethod
    def read_meta(path: str):
        meta = _read_json(os.path.join(path, _N5Format.array_meta))
        ctype = meta.get("compression", {"type": "raw"})["type"]
        if ctype not in ("raw", "gzip"):
            raise _unsupported_codec(f"n5 compression {ctype!r}", path)
        return {
            "shape": tuple(reversed(meta["dimensions"])),
            "chunks": tuple(reversed(meta["blockSize"])),
            "dtype": np.dtype(meta["dataType"]),
            "compression": None if ctype == "raw" else "gzip",
            "separator": "/",
            "fill_value": 0,
        }

    @staticmethod
    def encode_chunk(data: np.ndarray, chunks, compression) -> bytes:
        # mode-0 header: mode, ndim, then the dims in n5 (reversed) order, BE
        header = struct.pack(">HH", 0, data.ndim) + struct.pack(
            f">{data.ndim}I", *reversed(data.shape)
        )
        be = data.astype(_N5Format._DTYPES[data.dtype.name], copy=False)
        raw = np.ascontiguousarray(be).tobytes()
        return header + (_gzip_compress(raw) if compression else raw)

    @staticmethod
    def decode_chunk(payload: bytes, chunk_shape, dtype: np.dtype, compression):
        mode, ndim = struct.unpack(">HH", payload[:4])
        if mode != 0:
            raise ValueError(f"n5 chunk mode {mode} (varlength) is not supported")
        dims = struct.unpack(f">{ndim}I", payload[4: 4 + 4 * ndim])
        raw = payload[4 + 4 * ndim:]
        if compression:
            raw = gzip.decompress(raw)
        arr = np.frombuffer(raw, dtype=_N5Format._DTYPES[dtype.name]).astype(dtype)
        shape = tuple(reversed(dims))
        if shape == tuple(chunk_shape):
            return arr.reshape(chunk_shape)
        full = np.zeros(chunk_shape, dtype=dtype)  # n5 stores clipped edge chunks
        full[tuple(slice(0, s) for s in shape)] = arr.reshape(shape)
        return full

    @staticmethod
    def is_array(path: str) -> bool:
        meta_path = os.path.join(path, _N5Format.array_meta)
        return os.path.exists(meta_path) and "dimensions" in _read_json(meta_path)

    @staticmethod
    def init_group(path: str) -> None:
        meta_path = os.path.join(path, _N5Format.group_meta)
        if not os.path.exists(meta_path):
            _write_json(meta_path, {"n5": "2.0.0"})


def _format_for(path: str):
    ext = os.path.splitext(path.rstrip("/"))[1].lower()
    if ext in (".zarr", ".zr"):
        return _ZarrFormat
    if ext == ".n5":
        return _N5Format
    raise ValueError(
        f"unsupported container extension: {path} (the PyTorch port reads "
        ".zarr and .n5; hdf5 is ROADMAP Queue A work)"
    )


class Dataset:
    def __init__(self, path: str, fmt, readonly: bool = False):
        self.path = path
        self._fmt = fmt
        self._readonly = readonly
        spec = fmt.read_meta(path)
        self.shape = spec["shape"]
        self.chunks = spec["chunks"]
        self.dtype = spec["dtype"]
        self.compression = spec["compression"]
        self.fill_value = spec["fill_value"]
        self._separator = spec["separator"]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk_path(self, grid_pos) -> str:
        return os.path.join(self.path, self._fmt.chunk_key(grid_pos, self._separator))

    def _chunk_extent(self, grid_pos):
        return tuple(
            (g * c, min(g * c + c, s))
            for g, c, s in zip(grid_pos, self.chunks, self.shape)
        )

    def _decoded_chunk(self, grid_pos) -> Optional[np.ndarray]:
        """One chunk at full chunk shape (edge chunks zero-padded), or None."""
        try:
            with open(self._chunk_path(grid_pos), "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            return None
        return self._fmt.decode_chunk(payload, self.chunks, self.dtype, self.compression)

    def read_chunk(self, grid_pos) -> Optional[np.ndarray]:
        """One chunk cropped to the volume, or None if unwritten."""
        full = self._decoded_chunk(grid_pos)
        if full is None:
            return None
        crop = tuple(slice(0, e - b) for b, e in self._chunk_extent(grid_pos))
        return full[crop].copy()

    def write_chunk(self, grid_pos, data: np.ndarray) -> None:
        if self._readonly:
            raise PermissionError(f"dataset opened read-only: {self.path}")
        expected = tuple(e - b for b, e in self._chunk_extent(grid_pos))
        if tuple(data.shape) != expected:
            raise ValueError(
                f"chunk {tuple(grid_pos)} expects shape {expected}, got {data.shape}"
            )
        p = self._chunk_path(grid_pos)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        atomic_write_bytes(p, self._fmt.encode_chunk(
            np.asarray(data, dtype=self.dtype), self.chunks, self.compression
        ))

    def _normalize_bb(self, bb):
        if not isinstance(bb, tuple):
            bb = (bb,)
        if Ellipsis in bb:
            i = bb.index(Ellipsis)
            bb = bb[:i] + (slice(None),) * (self.ndim - len(bb) + 1) + bb[i + 1:]
        bb = bb + (slice(None),) * (self.ndim - len(bb))
        out, int_axes = [], []
        for axis, (sl, s) in enumerate(zip(bb, self.shape)):
            if isinstance(sl, (int, np.integer)):
                idx = int(sl) + s if sl < 0 else int(sl)
                if not 0 <= idx < s:
                    raise IndexError(f"index {sl} out of range for axis {axis} ({s})")
                int_axes.append(axis)
                sl = slice(idx, idx + 1)
            if sl.step not in (None, 1):
                raise ValueError("strided access is not supported")
            start = 0 if sl.start is None else (sl.start if sl.start >= 0 else s + sl.start)
            stop = s if sl.stop is None else (sl.stop if sl.stop >= 0 else s + sl.stop)
            out.append((max(0, start), min(s, stop)))
        return tuple(out), tuple(int_axes)

    def _chunks_overlapping(self, bb):
        return product(*[
            range(b // c, _ceil_div(e, c) if e > b else b // c + 1)
            for (b, e), c in zip(bb, self.chunks)
        ])

    @staticmethod
    def _overlap(extent, bb):
        lo = [max(cb, rb) for (cb, _), (rb, _) in zip(extent, bb)]
        hi = [min(ce, re) for (_, ce), (_, re) in zip(extent, bb)]
        return lo, hi

    def __getitem__(self, bb) -> np.ndarray:
        bb, int_axes = self._normalize_bb(bb)
        out_shape = tuple(e - b for b, e in bb)
        out = np.full(out_shape, self.fill_value, dtype=self.dtype)
        for grid_pos in self._chunks_overlapping(bb):
            chunk = self._decoded_chunk(grid_pos)
            if chunk is None:
                continue
            extent = self._chunk_extent(grid_pos)
            lo, hi = self._overlap(extent, bb)
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            src = tuple(slice(l - cb, h - cb) for l, h, (cb, _) in zip(lo, hi, extent))
            dst = tuple(slice(l - rb, h - rb) for l, h, (rb, _) in zip(lo, hi, bb))
            out[dst] = chunk[src]
        if int_axes:
            out = out.reshape(tuple(s for ax, s in enumerate(out_shape) if ax not in int_axes))
        return out

    def __setitem__(self, bb, value) -> None:
        if self._readonly:
            raise PermissionError(f"dataset opened read-only: {self.path}")
        bb, _ = self._normalize_bb(bb)
        region_shape = tuple(e - b for b, e in bb)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), region_shape)
        for grid_pos in self._chunks_overlapping(bb):
            extent = self._chunk_extent(grid_pos)
            lo, hi = self._overlap(extent, bb)
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            src = tuple(slice(l - rb, h - rb) for l, h, (rb, _) in zip(lo, hi, bb))
            if all(l == cb and h == ce for l, h, (cb, ce) in zip(lo, hi, extent)):
                self.write_chunk(grid_pos, value[src])
                continue
            chunk = self.read_chunk(grid_pos)
            if chunk is None:
                chunk = np.zeros(tuple(ce - cb for cb, ce in extent), dtype=self.dtype)
            dst = tuple(slice(l - cb, h - cb) for l, h, (cb, _) in zip(lo, hi, extent))
            chunk[dst] = value[src]
            self.write_chunk(grid_pos, chunk)


class RaggedDataset:
    """One 1d array of any length per grid position, stored as ``.npy``."""

    META = ".ragged.json"

    def __init__(self, path: str):
        self.path = path
        meta = _read_json(os.path.join(path, self.META))
        self.grid_shape = tuple(meta["grid_shape"])
        self.dtype = np.dtype(meta["dtype"])

    @classmethod
    def create(cls, path: str, grid_shape, dtype) -> "RaggedDataset":
        os.makedirs(path, exist_ok=True)
        _write_json(
            os.path.join(path, cls.META),
            {"grid_shape": list(grid_shape), "dtype": np.dtype(dtype).str},
        )
        return cls(path)

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, cls.META))

    def _chunk_path(self, grid_pos) -> str:
        if isinstance(grid_pos, (int, np.integer)):
            grid_pos = np.unravel_index(int(grid_pos), self.grid_shape)
        return os.path.join(self.path, ".".join(str(p) for p in grid_pos) + ".npy")

    def read_chunk(self, grid_pos) -> Optional[np.ndarray]:
        try:
            with open(self._chunk_path(grid_pos), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        return np.load(io.BytesIO(raw), allow_pickle=False)

    def write_chunk(self, grid_pos, data: np.ndarray) -> None:
        buf = io.BytesIO()
        np.save(buf, np.asarray(data, dtype=self.dtype))
        atomic_write_bytes(self._chunk_path(grid_pos), buf.getvalue())


class Group:
    def __init__(self, root: str, fmt, rel: str = "", readonly: bool = False):
        self._root = root
        self._fmt = fmt
        self._rel = rel
        self._readonly = readonly
        self.path = os.path.join(root, rel) if rel else root
        if not readonly:
            os.makedirs(self.path, exist_ok=True)
            fmt.init_group(self.path)

    def __contains__(self, key: str) -> bool:
        return os.path.isdir(os.path.join(self.path, key))

    def __getitem__(self, key: str):
        p = os.path.join(self.path, key)
        if not os.path.isdir(p):
            raise KeyError(key)
        if self._fmt.is_array(p):
            return Dataset(p, self._fmt, readonly=self._readonly)
        if RaggedDataset.exists(p):
            return RaggedDataset(p)
        rel = os.path.join(self._rel, key) if self._rel else key
        return Group(self._root, self._fmt, rel, readonly=self._readonly)

    def require_group(self, key: str) -> "Group":
        if self._readonly and key not in self:
            raise PermissionError(f"container opened read-only: {self.path}")
        rel = os.path.join(self._rel, key) if self._rel else key
        return Group(self._root, self._fmt, rel, readonly=self._readonly)

    def create_dataset(
        self,
        key: str,
        shape: Optional[Sequence[int]] = None,
        dtype=None,
        chunks: Optional[Sequence[int]] = None,
        compression: Optional[str] = "gzip",
        data: Optional[np.ndarray] = None,
        exist_ok: bool = False,
    ) -> Dataset:
        """``compression``: None/"raw" or "gzip" (the default; "default",
        the JAX package's house codec, resolves to gzip here)."""
        if self._readonly:
            raise PermissionError(f"container opened read-only: {self.path}")
        if data is not None:
            data = np.asarray(data)
            shape = data.shape if shape is None else shape
            dtype = data.dtype if dtype is None else dtype
        if shape is None or dtype is None:
            raise ValueError("shape and dtype (or data) are required")
        if chunks is None:
            chunks = tuple(min(s, 64) for s in shape)
        chunks = tuple(min(c, s) if s > 0 else c for c, s in zip(chunks, shape))
        if compression in ("raw", None):
            compression = None
        elif compression in ("gzip", "zlib", "default"):
            compression = "gzip"
        else:
            raise _unsupported_codec(f"compression {compression!r}", key)
        p = os.path.join(self.path, key)
        if self._fmt.is_array(p):
            if not exist_ok:
                raise ValueError(f"dataset exists: {p}")
            if data is None:
                return Dataset(p, self._fmt)
            shutil.rmtree(p)
        grp = self
        parts = key.split("/")
        for part in parts[:-1]:
            grp = grp.require_group(part)
        dpath = os.path.join(grp.path, parts[-1])
        os.makedirs(dpath, exist_ok=True)
        self._fmt.write_meta(dpath, tuple(shape), tuple(chunks), np.dtype(dtype), compression)
        ds = Dataset(dpath, self._fmt)
        if data is not None:
            ds[tuple(slice(0, s) for s in shape)] = data
        return ds

    def require_dataset(self, key: str, shape=None, dtype=None, chunks=None,
                        compression="gzip") -> Dataset:
        p = os.path.join(self.path, key)
        if self._fmt.is_array(p):
            ds = Dataset(p, self._fmt)
            if shape is not None and tuple(shape) != ds.shape:
                raise ValueError(f"shape mismatch for {p}: {shape} vs {ds.shape}")
            return ds
        return self.create_dataset(key, shape=shape, dtype=dtype, chunks=chunks,
                                   compression=compression)

    def create_ragged_dataset(self, key: str, grid_shape, dtype) -> RaggedDataset:
        if self._readonly:
            raise PermissionError(f"container opened read-only: {self.path}")
        p = os.path.join(self.path, key)
        if RaggedDataset.exists(p):
            return RaggedDataset(p)
        return RaggedDataset.create(p, grid_shape, dtype)


class File(Group):
    """Root of a zarr/n5 container."""

    def __init__(self, path: str, mode: str = "a"):
        fmt = _format_for(path)
        if mode == "r" and not os.path.isdir(path):
            raise FileNotFoundError(path)
        super().__init__(path, fmt, readonly=(mode == "r"))
        self.mode = mode


def file_reader(path: str, mode: str = "a") -> File:
    """Open a local ``.zarr`` / ``.n5`` container."""
    return File(path, mode)
