"""Chunked-array storage: local zarr v2 and n5 directory stores and an hdf5
passthrough.

The port's own copy of ``cluster_tools_tpu/utils/store.py``'s local part,
with the same on-disk formats, so a volume written by either package is read
by the other:

  * ``.zarr`` → zarr v2 (``.zarray``, ``i.j.k`` chunk files, raw/zlib/gzip/
    blosc);
  * ``.n5``   → n5 (``attributes.json``, reversed dimension order, big-endian
    mode-0 chunks and mode-1 varlength chunks, raw/gzip/blosc);
  * blosc through the system ``libblosc`` (``utils/blosc.py``): every cname,
    byte and bit shuffle; equal arrays and parameters give the JAX package's
    chunk bytes.  ``"default"`` — the house codec of scratch datasets — is
    blosc-lz4 where the library loads and gzip where it does not
    (``default_compression``, pinned by ``CTT_DEFAULT_COMPRESSION``);
  * ``.h5`` / ``.hdf5`` / ``.hdf`` → h5py behind a process-wide handle cache,
    so one task may read and write the same file (``_h5_open``); a task
    with an hdf5 path reads with one thread (``runtime/task.py``);
  * region read/write (read-modify-write on partially covered chunks),
    ``read_chunk`` / ``write_chunk``;
  * ``RaggedDataset``: one ``.npy`` array per grid position (the per-block
    side outputs such as the watershed's max ids);
  * JSON attributes (``.zattrs`` / n5 ``attributes.json``) as ``ds.attrs``;
  * a process-global LRU of decoded chunks (``CTT_CHUNK_CACHE_MB``, default
    64, 0 disables; ``set_chunk_cache_budget``), so the chunks that halo'd
    block reads share are decoded once;
  * the ``store.bytes_read`` / ``store.bytes_written`` counters
    (``obs/metrics.py``) of chunk payloads, where the JAX package counts
    them; an LRU hit counts nothing, so traffic is measured at budget 0;
  * ``Dataset.region_signature``: the per-chunk file signatures of a
    region, the device-buffer cache's freshness key.

Gzip is deterministic (level 1, mtime 0), so equal arrays give equal chunk
bytes.  The object-store backend is not ported (ROADMAP Queue A 13).
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
from collections import OrderedDict
from itertools import product
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from .blocking import _ceil_div

try:  # optional: without h5py an .h5 path raises as in the JAX package
    import h5py
except ImportError:
    h5py = None

__all__ = [
    "file_reader", "File", "Group", "Dataset", "RaggedDataset", "Attributes",
    "atomic_write_bytes", "set_chunk_cache_budget", "chunk_cache_budget",
    "chunk_cache_counts", "default_compression", "release_h5_handles",
]


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


# striped locks for the read-modify-write of partial chunks (one process)
_CHUNK_LOCKS = [threading.Lock() for _ in range(64)]


def _chunk_lock(path: str) -> threading.Lock:
    return _CHUNK_LOCKS[hash(path) % len(_CHUNK_LOCKS)]


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=2).encode())


def _gzip_compress(raw: bytes) -> bytes:
    return gzip.compress(raw, 1, mtime=0)


class _DecodedChunkCache:
    """Process-global LRU of decoded (full chunk shape) chunks.

    Halo'd block reads decode every shared chunk up to 2^ndim times; the
    cache makes each decode happen once.  Entries are keyed by the chunk
    file path and carry the file's ``(st_ino, st_mtime_ns, st_size)``
    signature: a mismatch (another process rewrote the chunk —
    ``os.replace`` changes the inode) is a miss, so freshness across
    processes degrades to a re-decode, never to stale data.  Writers in this
    process invalidate explicitly (``write_chunk``).  Cached arrays are
    read-only and shared; readers that hand out data copy it
    (``Dataset.read_chunk``, ``Dataset.__getitem__``).  ``hits`` and
    ``misses`` count the lookups of the cache's life.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[Any, np.ndarray]]" = OrderedDict()
        self._bytes = 0

    def get(self, path: str, sig) -> Optional[np.ndarray]:
        with self._lock:
            entry = self._entries.get(path)
            if entry is None or entry[0] != sig:
                self.misses += 1
                return None
            self._entries.move_to_end(path)
            self.hits += 1
            return entry[1]

    def put(self, path: str, sig, arr: np.ndarray) -> None:
        if arr.nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(path, None)
            if old is not None:
                self._bytes -= old[1].nbytes
            self._entries[path] = (sig, arr)
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes

    def invalidate(self, path: str) -> None:
        with self._lock:
            old = self._entries.pop(path, None)
            if old is not None:
                self._bytes -= old[1].nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


def _chunk_cache_budget_bytes() -> int:
    """``CTT_CHUNK_CACHE_MB`` (default 64, 0 disables); a malformed value
    degrades to the default."""
    raw = os.environ.get("CTT_CHUNK_CACHE_MB")
    try:
        mb = float(raw) if raw is not None else 64.0
    except (TypeError, ValueError):
        mb = 64.0
    return max(int(mb * 1024 * 1024), 0)


_CHUNK_CACHE = _DecodedChunkCache(_chunk_cache_budget_bytes())


def set_chunk_cache_budget(max_bytes: Optional[int]) -> int:
    """Set the decoded-chunk LRU's byte budget in this process (0 disables
    it, ``None`` restores the ``CTT_CHUNK_CACHE_MB`` value) and return the
    previous one; any change drops the cached entries."""
    prev = _CHUNK_CACHE.max_bytes
    _CHUNK_CACHE.max_bytes = (
        _chunk_cache_budget_bytes() if max_bytes is None else max(int(max_bytes), 0)
    )
    _CHUNK_CACHE.clear()
    return prev


def chunk_cache_budget() -> int:
    """The decoded-chunk LRU's byte budget (0: disabled)."""
    return _CHUNK_CACHE.max_bytes


def chunk_cache_counts() -> Dict[str, int]:
    """Hits and misses of the decoded-chunk LRU in this process so far."""
    with _CHUNK_CACHE._lock:
        return {"hits": _CHUNK_CACHE.hits, "misses": _CHUNK_CACHE.misses}


class Attributes:
    """JSON-file attribute mapping (``.zattrs``, or n5's ``attributes.json``
    with the format's own keys hidden)."""

    _N5_RESERVED = ("dimensions", "blockSize", "dataType", "compression", "n5")

    def __init__(self, path: str, reserved: Sequence[str] = ()):
        self._path = path
        self._reserved = tuple(reserved)

    def _load(self) -> Dict[str, Any]:
        try:
            return _read_json(self._path)
        except FileNotFoundError:
            return {}

    def __getitem__(self, key: str) -> Any:
        if key in self._reserved:
            raise KeyError(key)
        return self._load()[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if key in self._reserved:
            raise KeyError(f"attribute key {key!r} is reserved")
        obj = self._load()
        obj[key] = value
        _write_json(self._path, obj)

    def __contains__(self, key: str) -> bool:
        return key not in self._reserved and key in self._load()

    def get(self, key: str, default: Any = None) -> Any:
        return default if key in self._reserved else self._load().get(key, default)

    def keys(self):
        return [k for k in self._load() if k not in self._reserved]


def _blosc_mod():
    from . import blosc

    return blosc


# internal compression spec: None | "zlib" | "gzip" | blosc dict
def _is_blosc(compression) -> bool:
    return isinstance(compression, dict) and compression.get("id") == "blosc"


def _clamp_chunks(chunks, shape):
    """Chunk dims never exceed the shape; zero-size dims keep the chunk
    (h5py and zarr both reject zero chunks)."""
    return tuple(min(c, s) if s > 0 else c for c, s in zip(chunks, shape))


def default_compression() -> str:
    """The house codec of the datasets the tasks create as scratch: blosc
    (lz4) where the system libblosc loads, else gzip.  An explicit
    ``compression=`` always wins; the string ``"default"`` resolves here.
    ``CTT_DEFAULT_COMPRESSION`` (``gzip`` or ``blosc``) pins the resolution
    where nodes differ in what they have installed."""
    pinned = os.environ.get("CTT_DEFAULT_COMPRESSION")
    if pinned in ("gzip", "blosc"):
        return pinned
    return "blosc" if _blosc_mod().available() else "gzip"


def _normalize_blosc(spec, itemsize: Optional[int] = None) -> dict:
    """A blosc spec with the ecosystem's defaults (zarr-python: lz4, clevel
    5, byte shuffle, automatic block size) filled in; ``spec`` is the string
    ``"blosc"``, a zarr compressor dict or an n5 compression dict.  The
    shuffle -1 (numcodecs' automatic one, which reads fine but cannot be
    written) becomes what it resolves to: byte shuffle above one byte per
    item, none for single bytes."""
    src = spec if isinstance(spec, dict) else {}
    shuffle = int(src.get("shuffle", 1))
    if shuffle == -1:
        shuffle = 1 if (itemsize or 0) > 1 else 0
    if shuffle not in (0, 1, 2):
        raise ValueError(
            f"unsupported blosc shuffle {src.get('shuffle')!r} "
            "(supported: 0=none, 1=byte, 2=bit, -1=auto)"
        )
    return {
        "id": "blosc",
        "cname": src.get("cname", "lz4"),
        "clevel": int(src.get("clevel", 5)),
        "shuffle": shuffle,
        "blocksize": int(src.get("blocksize", 0)),
    }


def _blosc_compress(raw: bytes, itemsize: int, compression: dict) -> bytes:
    return _blosc_mod().compress(
        raw, itemsize, cname=compression["cname"], clevel=compression["clevel"],
        shuffle=compression["shuffle"], blocksize=compression["blocksize"],
    )


def _blosc_decompress(payload: bytes, chunk_shape, dtype: np.dtype) -> bytes:
    """Bounded by what the chunk may hold: a forged header cannot make a
    multi-GB buffer."""
    return _blosc_mod().decompress(
        payload, expected_nbytes=int(np.prod(chunk_shape)) * dtype.itemsize
    )


class _ZarrFormat:
    array_meta = ".zarray"
    group_meta = ".zgroup"
    attrs_file = ".zattrs"
    attrs_reserved: Tuple[str, ...] = ()

    @staticmethod
    def chunk_key(grid_pos, separator: str = ".") -> str:
        return separator.join(str(p) for p in grid_pos)

    @staticmethod
    def write_meta(path, shape, chunks, dtype: np.dtype, compression) -> None:
        if compression is None:
            compressor = None
        elif _is_blosc(compression):
            compressor = dict(compression)
        else:
            compressor = {"id": "zlib", "level": 1}
        _write_json(os.path.join(path, _ZarrFormat.array_meta), {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": dtype.str,
            "compressor": compressor,
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
        elif comp.get("id") == "blosc":
            compression = _normalize_blosc(comp, itemsize=np.dtype(meta["dtype"]).itemsize)
        else:
            raise ValueError(
                f"unsupported zarr compressor {comp.get('id')!r} in {path} "
                "(supported: null, zlib, gzip, blosc)"
            )
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
        if _is_blosc(compression):
            return _blosc_compress(raw, data.dtype.itemsize, compression)
        if compression == "gzip":
            return _gzip_compress(raw)
        return zlib.compress(raw, 1) if compression else raw

    @staticmethod
    def decode_chunk(payload: bytes, chunk_shape, dtype: np.dtype, compression):
        if _is_blosc(compression):
            payload = _blosc_decompress(payload, chunk_shape, dtype)
        elif compression == "gzip":
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
    attrs_file = "attributes.json"
    attrs_reserved = Attributes._N5_RESERVED

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
        if compression is None:
            n5_comp = {"type": "raw"}
        elif _is_blosc(compression):
            n5_comp = {"type": "blosc", **{k: v for k, v in compression.items() if k != "id"},
                       "nthreads": 1}
        else:
            n5_comp = {"type": "gzip", "level": 1}
        meta.update({
            "dimensions": list(reversed(shape)),
            "blockSize": list(reversed(chunks)),
            "dataType": dtype.name,
            "compression": n5_comp,
        })
        _write_json(meta_path, meta)

    @staticmethod
    def read_meta(path: str):
        meta = _read_json(os.path.join(path, _N5Format.array_meta))
        n5_comp = meta.get("compression", {"type": "raw"})
        ctype = n5_comp["type"]
        if ctype == "raw":
            compression = None
        elif ctype == "gzip":
            compression = "gzip"
        elif ctype == "blosc":
            compression = _normalize_blosc(n5_comp, itemsize=np.dtype(meta["dataType"]).itemsize)
        else:
            raise ValueError(f"unsupported n5 compression {ctype!r} in {path}")
        return {
            "shape": tuple(reversed(meta["dimensions"])),
            "chunks": tuple(reversed(meta["blockSize"])),
            "dtype": np.dtype(meta["dataType"]),
            "compression": compression,
            "separator": "/",
            "fill_value": 0,
        }

    @staticmethod
    def pack_chunk(data: np.ndarray, dims, compression, n_varlen=None) -> bytes:
        """The chunk wire format: a mode-0 header (mode, ndim, the dims in n5's
        reversed order, big-endian) or a mode-1 (varlength) one with the
        element count ``n_varlen`` after the dims, then the big-endian
        payload, compressed."""
        mode = 0 if n_varlen is None else 1
        header = struct.pack(">HH", mode, len(dims)) + struct.pack(
            f">{len(dims)}I", *reversed(tuple(dims))
        )
        if n_varlen is not None:
            header += struct.pack(">I", n_varlen)
        be = data.astype(_N5Format._DTYPES[data.dtype.name], copy=False)
        raw = np.ascontiguousarray(be).tobytes()
        if _is_blosc(compression):
            raw = _blosc_compress(raw, be.dtype.itemsize, compression)
        elif compression:
            raw = _gzip_compress(raw)
        return header + raw

    @staticmethod
    def encode_chunk(data: np.ndarray, chunks, compression) -> bytes:
        return _N5Format.pack_chunk(data, data.shape, compression)

    @staticmethod
    def decode_chunk(payload: bytes, chunk_shape, dtype: np.dtype, compression):
        mode, ndim = struct.unpack(">HH", payload[:4])
        dims = struct.unpack(f">{ndim}I", payload[4: 4 + 4 * ndim])
        offset = 4 + 4 * ndim + (4 if mode == 1 else 0)  # mode 1 adds an element count
        raw = payload[offset:]
        if _is_blosc(compression):
            raw = _blosc_decompress(raw, chunk_shape, dtype)
        elif compression:
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
    raise ValueError(f"unsupported container extension: {path}")


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
        self.attrs = Attributes(os.path.join(path, fmt.attrs_file), fmt.attrs_reserved)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def chunk_grid(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    def _chunk_path(self, grid_pos) -> str:
        return os.path.join(self.path, self._fmt.chunk_key(grid_pos, self._separator))

    def _chunk_extent(self, grid_pos):
        return tuple(
            (g * c, min(g * c + c, s))
            for g, c, s in zip(grid_pos, self.chunks, self.shape)
        )

    def _decoded_chunk(self, grid_pos) -> Optional[np.ndarray]:
        """One chunk at full chunk shape (edge chunks zero-padded), read-only,
        through the decoded-chunk LRU; None if the chunk is unwritten.  A
        rewrite between the signature probe and the read can at worst cache
        fresh content under the old signature, which the next probe turns
        into a miss."""
        p = self._chunk_path(grid_pos)
        sig = None
        if _CHUNK_CACHE.max_bytes > 0:
            try:
                st = os.stat(p)
            except FileNotFoundError:
                return None
            sig = (st.st_ino, st.st_mtime_ns, st.st_size)
            hit = _CHUNK_CACHE.get(p, sig)
            if hit is not None:
                return hit
        try:
            with open(p, "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            return None
        # counted at the codec boundary: the compressed bytes that crossed
        # the filesystem (an LRU hit above crossed nothing)
        obs_metrics.inc("store.chunks_read")
        obs_metrics.inc("store.bytes_read", len(payload))
        full = self._fmt.decode_chunk(payload, self.chunks, self.dtype, self.compression)
        full.setflags(write=False)  # shared across cache readers
        if sig is not None:
            _CHUNK_CACHE.put(p, sig, full)
        return full

    def read_chunk(self, grid_pos) -> Optional[np.ndarray]:
        """One chunk cropped to the volume (a writable copy: the decoded
        chunk may be the cache's), or None if unwritten."""
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
        try:
            self._commit(p, self._fmt.encode_chunk(
                np.asarray(data, dtype=self.dtype), self.chunks, self.compression
            ))
        finally:
            _CHUNK_CACHE.invalidate(p)

    @staticmethod
    def _commit(p: str, payload: bytes) -> None:
        obs_metrics.inc("store.chunks_written")
        obs_metrics.inc("store.bytes_written", len(payload))
        atomic_write_bytes(p, payload)

    def write_chunk_varlen(self, grid_pos, data: np.ndarray) -> None:
        """Write a 1d payload of any length as an n5 mode-1 (varlength)
        chunk (the JAX package's label multisets are stored this way)."""
        if self._readonly:
            raise PermissionError(f"dataset opened read-only: {self.path}")
        if self._fmt is not _N5Format:
            raise NotImplementedError("varlength chunks are n5-only")
        data = np.ascontiguousarray(data, dtype=self.dtype)
        p = self._chunk_path(grid_pos)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        try:
            self._commit(p, _N5Format.pack_chunk(
                data, self.chunks, self.compression, n_varlen=data.size))
        finally:
            _CHUNK_CACHE.invalidate(p)

    def read_chunk_varlen(self, grid_pos) -> Optional[np.ndarray]:
        """A mode-1 (varlength) chunk as a flat array, or None if unwritten."""
        if self._fmt is not _N5Format:
            raise NotImplementedError("varlength chunks are n5-only")
        try:
            with open(self._chunk_path(grid_pos), "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            return None
        obs_metrics.inc("store.chunks_read")
        obs_metrics.inc("store.bytes_read", len(payload))
        mode, ndim = struct.unpack(">HH", payload[:4])
        if mode != 1:
            raise ValueError(f"chunk {tuple(grid_pos)} is not varlength")
        offset = 4 + 4 * ndim
        (n_elements,) = struct.unpack(">I", payload[offset: offset + 4])
        raw = payload[offset + 4:]
        if _is_blosc(self.compression):
            raw = _blosc_mod().decompress(raw)
        elif self.compression:
            raw = gzip.decompress(raw)
        out = np.frombuffer(raw, dtype=_N5Format._DTYPES[self.dtype.name])
        if out.size < n_elements:
            raise ValueError(
                f"varlen chunk {tuple(grid_pos)} holds {out.size} elements, "
                f"its header promises {n_elements}"
            )
        return out[:n_elements].astype(self.dtype)

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

    def region_signature(self, bb) -> Optional[tuple]:
        """``(st_ino, st_mtime_ns, st_size)`` of every chunk file
        overlapping ``bb`` (None for an unwritten chunk: it reads as the
        fill value) — the freshness key of the device-buffer cache
        (``runtime/hbm.py``), the decoded-chunk LRU's own signatures.  A
        rewrite replaces the file, so its signature changes."""
        bb, _ = self._normalize_bb(bb)
        sigs = []
        for grid_pos in self._chunks_overlapping(bb):
            try:
                st = os.stat(self._chunk_path(grid_pos))
            except FileNotFoundError:
                sigs.append(None)
                continue
            sigs.append((st.st_ino, st.st_mtime_ns, st.st_size))
        return tuple(sigs)

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
            # a partial chunk is read, modified and written: two writers of
            # one chunk (blocks that do not cover whole chunks, written by
            # two threads) take the chunk's lock so neither loses the other's
            with _chunk_lock(self._chunk_path(grid_pos)):
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
        # a group may carry "dataType" (the bdv setup's metadata); the other
        # structural keys stay guarded so that it is never taken for an array
        self.attrs = Attributes(os.path.join(self.path, fmt.attrs_file),
                                tuple(k for k in fmt.attrs_reserved if k != "dataType"))

    def __contains__(self, key: str) -> bool:
        return os.path.isdir(os.path.join(self.path, key))

    def keys(self):
        return [k for k in sorted(os.listdir(self.path))
                if os.path.isdir(os.path.join(self.path, k))]

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
        compression: Optional[str] = "default",
        data: Optional[np.ndarray] = None,
        exist_ok: bool = False,
    ) -> Dataset:
        """``compression``: None/"raw", "gzip" (any other name but blosc's
        becomes gzip), "blosc" or a blosc dict, or "default", the house codec
        (``default_compression()``).  It is checked before an existing
        dataset is overwritten, so a missing libblosc deletes nothing."""
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
        chunks = _clamp_chunks(chunks, shape)
        if compression == "default":
            compression = default_compression()
        if compression == "blosc" or _is_blosc(compression):
            compression = _normalize_blosc(compression, itemsize=np.dtype(dtype).itemsize)
            if not _blosc_mod().available():
                raise RuntimeError("compression='blosc' requires the system libblosc")
        elif compression in ("raw", None):
            compression = None
        else:
            compression = "gzip"
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
                        compression="default") -> Dataset:
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
    """Root of a zarr/n5 container (a context manager with nothing to
    close, as the JAX package's)."""

    def __init__(self, path: str, mode: str = "a"):
        fmt = _format_for(path)
        if mode == "r" and not os.path.isdir(path):
            raise FileNotFoundError(path)
        super().__init__(path, fmt, readonly=(mode == "r"))
        self.mode = mode

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        pass


_H5_HANDLES: Dict[str, Any] = {}
# open façades per path: the last close really closes the cached handle (and
# releases the HDF5 file lock); handles opened without close() stay cached
_H5_REFS: Dict[str, int] = {}
# re-entrant: dataset proxies reopen through _h5_cached_handle under it
_H5_LOCK = threading.RLock()


def is_hdf5_path(path: Optional[str]) -> bool:
    return bool(path) and os.path.splitext(str(path))[1].lower() in (".h5", ".hdf5", ".hdf")


def _h5_cached_handle(key: str):
    """The cached read handle for a proxy's re-resolution (the refcount is
    left alone: nobody closes a proxy's implicit reopen)."""
    cached = _H5_HANDLES.get(key)
    if cached is None or not bool(cached):
        cached = h5py.File(key, "r")
        _H5_HANDLES[key] = cached
    return cached


class _H5DatasetProxy:
    """A dataset handle that re-resolves through the handle cache on every
    access, so reopening its file writable cannot leave the caller with a
    dead HDF5 id.  Every access holds the cache lock: a concurrent upgrade
    or release cannot close the handle between resolution and use."""

    def __init__(self, path: str, name: str):
        self._path = path
        self._name = name

    def _ds(self):
        # the cached handle may have been released: reopen read-only (a
        # proxy is only handed out for reads)
        return _h5_cached_handle(self._path)[self._name]

    def __getitem__(self, key):
        with _H5_LOCK:
            return self._ds()[key]

    def __setitem__(self, key, value):
        with _H5_LOCK:
            self._ds()[key] = value

    def __getattr__(self, name):
        with _H5_LOCK:
            return getattr(self._ds(), name)

    def __len__(self):
        with _H5_LOCK:
            return len(self._ds())


class _CachedH5File:
    """A façade over a process-cached ``h5py.File``.

    HDF5 refuses to open one file twice with different modes in a process,
    so a task reading its input and writing its output in the same ``.h5``
    would fail with "file is already open".  The cache keeps one real handle
    per path, counted per façade: ``close`` and ``with`` flush, and the last
    close for a path really closes it.  ``release_h5_handles()`` closes
    every handle.  Datasets of a read-only handle come back as proxies that
    re-resolve (a later writable open reopens the file underneath); those of
    a writable handle come back raw, as writable handles are never reopened.
    """

    def __init__(self, f, path: str):
        object.__setattr__(self, "_f", f)
        object.__setattr__(self, "_path", path)

    def __getattr__(self, name):
        return getattr(self._f, name)

    @staticmethod
    def _h5_compression(compression):
        """The store's codec names on h5py's: ``default``, ``blosc`` and
        ``zlib`` become gzip (h5py has no blosc without a plugin), ``raw``
        and None uncompressed."""
        if compression in (None, "raw"):
            return {}
        if compression in ("gzip", "zlib", "default", "blosc") or _is_blosc(compression):
            return {"compression": "gzip"}
        return {"compression": compression}

    def create_dataset(self, key, shape=None, dtype=None, chunks=None,
                       compression="default", data=None, **kw):
        if data is not None and not isinstance(data, (str, bytes)):
            # str and bytes stay raw: h5py stores them as vlen strings
            data = np.asarray(data)
            if shape is None:
                shape = data.shape
            elif tuple(shape) != data.shape:
                data = data.reshape(shape)  # h5py's rule: the shape wins
        if chunks is not None and shape is not None:
            chunks = _clamp_chunks(chunks, shape)
        scalar = (data is not None and np.ndim(data) == 0) or (
            shape is not None and (len(shape) == 0 or any(s == 0 for s in shape))
        )
        if scalar:  # h5py: scalar and empty datasets take no chunks or filters
            args = dict(kw)
        else:
            args = dict(kw, **self._h5_compression(compression))
            if chunks is not None:
                args["chunks"] = chunks
        if dtype is not None:
            args["dtype"] = dtype
        if data is not None:
            return self._f.create_dataset(key, data=data, **args)
        return self._f.create_dataset(key, shape=shape, **args)

    def require_dataset(self, key, shape=None, dtype=None, chunks=None,
                        compression="default", **kw):
        if key in self._f:
            ds = self._f[key]
            if shape is not None and tuple(shape) != tuple(ds.shape):
                raise ValueError(f"shape mismatch for {key}: {shape} vs {ds.shape}")
            if dtype is not None and not np.can_cast(np.dtype(dtype), ds.dtype, "safe"):
                raise TypeError(
                    f"existing dataset {key} has dtype {ds.dtype}, cannot safely hold {dtype}"
                )
            return ds
        return self.create_dataset(key, shape=shape, dtype=dtype, chunks=chunks,
                                   compression=compression, **kw)

    def __getitem__(self, key):
        obj = self._f[key]
        if self._f.mode == "r" and isinstance(obj, h5py.Dataset):
            return _H5DatasetProxy(self._path, key)
        return obj

    def __setitem__(self, key, value):
        self._f[key] = value

    def __contains__(self, key):
        return key in self._f

    def __iter__(self):
        return iter(self._f)

    def __len__(self):
        return len(self._f)

    def get(self, key, default=None):
        if key not in self._f:
            return default
        return self[key]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Flush; the last close for a path closes the cached handle.  A
        second close of one façade, or a close of a façade whose handle a
        read-to-write reopen replaced, does nothing."""
        with _H5_LOCK:
            if getattr(self, "_released", False):
                return
            object.__setattr__(self, "_released", True)
            f = self._f
            if f and f.mode != "r":
                f.flush()
            key = self._path
            if _H5_HANDLES.get(key) is not f:
                return
            n = _H5_REFS.get(key, 1) - 1
            if n > 0:
                _H5_REFS[key] = n
                return
            _H5_REFS.pop(key, None)
            _H5_HANDLES.pop(key, None)
            if f:
                f.close()


def release_h5_handles() -> None:
    """Close every cached h5 handle (writers flushed), before handing a file
    to another process: a held writable handle blocks its open."""
    with _H5_LOCK:
        for f in _H5_HANDLES.values():
            if f:
                f.close()
        _H5_HANDLES.clear()
        _H5_REFS.clear()


def _h5_open(path: str, mode: str):
    key = os.path.abspath(path)
    with _H5_LOCK:
        cached = _H5_HANDLES.get(key)
        if cached is not None and not bool(cached):  # closed underneath
            _H5_HANDLES.pop(key, None)
            _H5_REFS.pop(key, None)
            cached = None
        if mode in ("w", "w-", "x"):
            # truncate or exclusive create: never from a cached handle
            if cached is not None:
                raise OSError(
                    f"cannot open {path!r} with mode {mode!r}: the file is open elsewhere "
                    "in this process (store.release_h5_handles() closes cached handles)"
                )
            f = h5py.File(path, mode)
            _H5_HANDLES[key] = f
            _H5_REFS[key] = _H5_REFS.get(key, 0) + 1
            return _CachedH5File(f, key)
        if cached is not None and mode in ("a", "r+") and cached.mode == "r":
            # read-only to writable: earlier reads were handed out as
            # proxies, so nothing dies; the count restarts (stale façades
            # over the old handle fail the identity check in close)
            cached.close()
            _H5_HANDLES.pop(key, None)
            _H5_REFS.pop(key, None)
            cached = None
            mode = "a"
        if cached is None:
            cached = h5py.File(path, mode)
            _H5_HANDLES[key] = cached
        _H5_REFS[key] = _H5_REFS.get(key, 0) + 1
        return _CachedH5File(cached, key)


def file_reader(path: str, mode: str = "a"):
    """Open a container by extension: ``.zarr``/``.zr``, ``.n5``,
    ``.h5``/``.hdf5``/``.hdf``."""
    if is_hdf5_path(path):
        if h5py is None:
            raise RuntimeError("h5py is not available")
        return _h5_open(path, mode)
    return File(path, mode)
