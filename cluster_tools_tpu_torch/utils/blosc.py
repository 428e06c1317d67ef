"""ctypes binding to the system c-blosc (v1), the zarr ecosystem's default
chunk codec.

The port's own copy of ``cluster_tools_tpu/utils/blosc.py``.  Binding the
system ``libblosc.so.1`` keeps the store bit-compatible with every chunk the
ecosystem writes (all cnames: blosclz, lz4, lz4hc, zlib, zstd; byte- and
bit-shuffle) without vendoring a codec; where the library is absent,
``available()`` is False and the store's house codec falls back to gzip.

Context-variant API only (``*_ctx``): no global init, thread-safe, so the
store's threaded chunk readers can decompress concurrently.  Nothing is
loaded at import time.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

MAX_OVERHEAD = 16  # BLOSC_MAX_OVERHEAD: container header bytes

# blosc shuffle constants (blosc.h)
NOSHUFFLE = 0
SHUFFLE = 1
BITSHUFFLE = 2

_lib = None
_lib_checked = False
_load_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> bool:
    """Declare the prototypes we call; returns False if the core symbols
    are missing (not a c-blosc1)."""
    try:
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blosc_cbuffer_sizes.restype = None
        lib.blosc_cbuffer_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ]
    except AttributeError:
        return False
    try:
        # >= 1.16 only; decompress() falls back to cbuffer_sizes without it
        lib.blosc_cbuffer_validate.restype = ctypes.c_int
        lib.blosc_cbuffer_validate.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
    except AttributeError:
        pass
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    with _load_lock:
        if _lib_checked:
            return _lib
        candidates = ["libblosc.so.1", "libblosc.so", "libblosc.dylib"]
        found = ctypes.util.find_library("blosc")
        if found:
            candidates.insert(0, found)
        lib_found = None
        for name in candidates:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            if _bind(lib):
                lib_found = lib
                break
        # publish the lib BEFORE the checked flag: a concurrent reader that
        # sees _lib_checked must also see the final _lib
        _lib = lib_found
        _lib_checked = True
    return _lib


def available() -> bool:
    """True when a usable system libblosc was found."""
    return _load() is not None


def decompress(payload: bytes, expected_nbytes: Optional[int] = None) -> bytes:
    """Decompress one blosc frame (any cname/shuffle the lib supports).

    ``expected_nbytes`` bounds the output allocation: chunk callers know the
    decoded size a frame may legitimately claim (chunk_shape × itemsize), and
    a corrupt/hostile chunk from an externally-produced store must fail
    loudly instead of triggering a multi-GB allocation from a forged header
    (the clamp applies to the validate path too, since
    ``blosc_cbuffer_validate`` checks consistency, not plausibility)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "blosc-compressed chunk but no system libblosc available"
        )
    nbytes = ctypes.c_size_t(0)
    if hasattr(lib, "blosc_cbuffer_validate"):
        # validate reads the header defensively (truncated/corrupt frames
        # fail here instead of over-reading) and yields the decompressed size
        rc = lib.blosc_cbuffer_validate(
            payload, len(payload), ctypes.byref(nbytes)
        )
        if rc < 0:
            raise ValueError("corrupt blosc chunk (header validation failed)")
    else:
        # pre-1.16 libs: read the sizes from the header; decompress_ctx
        # still bounds-checks against destsize below
        if len(payload) < MAX_OVERHEAD:
            raise ValueError("truncated blosc chunk")
        cbytes = ctypes.c_size_t(0)
        blocksize = ctypes.c_size_t(0)
        lib.blosc_cbuffer_sizes(
            payload, ctypes.byref(nbytes), ctypes.byref(cbytes),
            ctypes.byref(blocksize),
        )
        if cbytes.value != len(payload):
            raise ValueError("corrupt blosc chunk (size header mismatch)")
    if expected_nbytes is not None and nbytes.value > int(expected_nbytes):
        raise ValueError(
            f"corrupt blosc chunk: header claims {nbytes.value} decompressed "
            f"bytes, expected at most {int(expected_nbytes)}"
        )
    out = ctypes.create_string_buffer(max(nbytes.value, 1))
    n = lib.blosc_decompress_ctx(payload, out, nbytes.value, 1)
    if n < 0 or n != nbytes.value:
        raise ValueError(f"blosc decompression failed (rc={n})")
    return out.raw[: nbytes.value]


def compress(
    raw: bytes,
    typesize: int,
    cname: str = "lz4",
    clevel: int = 5,
    shuffle: int = SHUFFLE,
    blocksize: int = 0,
) -> bytes:
    """Compress ``raw`` into one blosc frame (zarr-python default settings:
    lz4, clevel 5, byte shuffle, automatic block size)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("blosc compression requested but libblosc missing")
    typesize = max(int(typesize), 1)
    dest_len = len(raw) + MAX_OVERHEAD
    out = ctypes.create_string_buffer(dest_len)
    n = lib.blosc_compress_ctx(
        int(clevel), int(shuffle), typesize, len(raw), raw, out, dest_len,
        str(cname).encode(), int(blocksize), 1,
    )
    if n <= 0:
        raise ValueError(f"blosc compression failed (rc={n}, cname={cname!r})")
    return out.raw[:n]
