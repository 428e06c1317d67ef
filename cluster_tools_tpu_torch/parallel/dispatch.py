"""Block batches and the fused chain's shared read (port of the read-cache
half of ``cluster_tools_tpu/parallel/dispatch.py``).

A fused chain (``runtime/stream.py``) reads each batch's region of an
input ONCE, at the largest halo any member needs: ``BlockReadCache``
holds that read, and every member's own ``read_batch`` then runs against
crops of it through ``CachedDataset`` — the member's unchanged read and
padding code gives byte-identical payloads, because a crop of a larger
store read equals the smaller read.  ``use_read_cache`` installs a cache
for the calling thread, and ``tasks/base.py::VolumeTask.input_ds`` wraps
its dataset with ``wrap_with_read_cache``, a no-op outside a chain's read
stage.

``BlockBatch`` is a stacked batch of blocks with its geometry, and with
the device-buffer cache (``runtime/hbm.py``) its store identity
(``source``) and its resident device tensors (``device``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.blocking import Blocking, BlockWithHalo


def batch_outer_boxes(blocking: Blocking, block_ids: Sequence[int], halo: Sequence[int]):
    """The batch's halo'd outer boxes, their bounding box ``lo``/``hi`` and
    whether one bounding-box read is profitable (it holds no more voxels
    than the outer boxes together): consecutive C-order ids form a
    (near-)contiguous slab, sparse id runs do not."""
    bhs = [blocking.block_with_halo(bid, tuple(halo)) for bid in block_ids]
    lo = tuple(min(bh.outer.begin[d] for bh in bhs) for d in range(blocking.ndim))
    hi = tuple(max(bh.outer.end[d] for bh in bhs) for d in range(blocking.ndim))
    bbox_voxels = int(np.prod([e - b for b, e in zip(lo, hi)]))
    block_voxels = sum(int(np.prod(bh.outer.shape)) for bh in bhs)
    return bhs, lo, hi, bbox_voxels <= block_voxels


@dataclass
class BlockBatch:
    """A stacked batch of (possibly halo'd) blocks and their geometry.

    ``data`` is ``[B, *padded block]`` on the host, or None when a probe of
    the device-buffer cache hit and the host read was skipped; ``device``
    is then the resident ``runtime.hbm.DeviceBatch``.  ``source`` is the
    batch's ``runtime.hbm.BatchSource`` while the cache is on."""

    data: Optional[np.ndarray]
    valid: Optional[np.ndarray]
    blocks: List[BlockWithHalo]
    block_ids: List[int]
    source: Any = None
    device: Any = None

    @property
    def batch_size(self) -> int:
        return len(self.block_ids)


class BlockReadCache:
    """Host cache of block-region reads for one fused-chain batch.

    ``prefetch`` reads each batch's halo'd region (leading non-spatial axes
    whole) through the real dataset — the only store traffic; ``get``
    serves any plain box inside a cached region as a view, and everything
    else misses (the caller then reads the store)."""

    def __init__(self) -> None:
        # (path, key) -> [(begin, end, array)] over all axes of the dataset
        self._boxes: Dict[Tuple[str, str], List[Tuple[tuple, tuple, np.ndarray]]] = {}

    def prefetch(self, ds, path: str, key: str, blocking: Blocking,
                 block_ids: Sequence[int], halo: Sequence[int]) -> None:
        """One read of the batch's bounding box when that is profitable, so
        each covered chunk decodes once; else one read per outer box."""
        extra = len(ds.shape) - blocking.ndim
        lead = tuple(slice(0, s) for s in ds.shape[:extra])
        boxes = self._boxes.setdefault((path, key), [])
        bhs, lo, hi, bbox_ok = batch_outer_boxes(blocking, block_ids, halo)
        indices = ([lead + tuple(slice(b, e) for b, e in zip(lo, hi))] if bbox_ok
                   else [lead + bh.outer.slicing for bh in bhs])
        for index in indices:
            boxes.append((tuple(sl.start for sl in index), tuple(sl.stop for sl in index),
                          np.asarray(ds[index])))

    def get(self, path: str, key: str, index, shape) -> Optional[np.ndarray]:
        boxes = self._boxes.get((path, key))
        if not boxes:
            return None
        norm = _normalize_index(index, shape)
        if norm is None:
            return None
        begin, end = norm
        for cb, ce, arr in boxes:
            if all(b >= b0 and e <= e0 for b, e, b0, e0 in zip(begin, end, cb, ce)):
                return arr[tuple(slice(b - b0, e - b0) for b, e, b0 in zip(begin, end, cb))]
        return None


def _normalize_index(index, shape) -> Optional[Tuple[tuple, tuple]]:
    """A ``__getitem__`` key as ``(begin, end)`` per axis; None when it is
    not a plain box (integers, steps, negative bounds, fancy indexing)."""
    if not isinstance(index, tuple):
        index = (index,)
    if len(index) > len(shape):
        return None
    index = index + (slice(None),) * (len(shape) - len(index))
    begin, end = [], []
    for sl, s in zip(index, shape):
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            return None
        b = 0 if sl.start is None else int(sl.start)
        e = s if sl.stop is None else int(sl.stop)
        if b < 0 or e < 0:
            return None
        begin.append(b)
        end.append(min(e, s))
    return tuple(begin), tuple(end)


class CachedDataset:
    """A read-only dataset proxy: reads the cache holds come from it, every
    other read and attribute goes to the wrapped dataset."""

    def __init__(self, ds, cache: BlockReadCache, path: str, key: str):
        self._ds = ds
        self._cache = cache
        self._path = path
        self._key = key

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __getitem__(self, index):
        hit = self._cache.get(self._path, self._key, index, self._ds.shape)
        return self._ds[index] if hit is None else hit


_READ_CACHE_TLS = threading.local()


def active_read_cache() -> Optional[BlockReadCache]:
    return getattr(_READ_CACHE_TLS, "cache", None)


@contextlib.contextmanager
def use_read_cache(cache: BlockReadCache):
    """Install ``cache`` for the calling thread: datasets opened inside
    (``VolumeTask.input_ds``) come back wrapped."""
    prev = getattr(_READ_CACHE_TLS, "cache", None)
    _READ_CACHE_TLS.cache = cache
    try:
        yield cache
    finally:
        _READ_CACHE_TLS.cache = prev


def wrap_with_read_cache(ds, path: str, key: str):
    """``ds`` behind the thread's active read cache; ``ds`` itself outside a
    fused chain's read stage."""
    cache = active_read_cache()
    return ds if cache is None else CachedDataset(ds, cache, path, key)


def read_block_batch(ds, blocking: Blocking, block_ids: Sequence[int], dtype=None,
                     n_threads: int = 4, device_source: Optional[tuple] = None,
                     halo: Optional[Sequence[int]] = None,
                     pad_mode: str = "constant") -> BlockBatch:
    """The blocks ``block_ids`` of ``ds`` (their outer boxes with ``halo``)
    as ``dtype``, each padded at its end to the static batch shape — with
    zeros, or by ``np.pad``'s ``pad_mode`` — stacked, with ``valid``
    holding each block's ``[begin, end)`` inside the padded one.  Reads fan
    out over ``n_threads``.

    ``device_source = (path, key, tag, config)`` arms the device-buffer
    cache (``runtime/hbm.py``): the batch's region is signed and, when the
    same upload is resident, the host read is skipped — the batch then
    carries the geometry and the device tensors and ``data`` is None."""
    from concurrent.futures import ThreadPoolExecutor

    halo = tuple(halo) if halo is not None else (0,) * blocking.ndim
    full = tuple(bs + 2 * h for bs, h in zip(blocking.block_shape, halo))
    blocks = [blocking.block_with_halo(bid, halo) for bid in block_ids]
    valid = np.asarray([[[0, e - b] for b, e in zip(bh.outer.begin, bh.outer.end)]
                        for bh in blocks], dtype=np.int32)
    source = None
    if device_source is not None:
        from ..obs import metrics as obs_metrics
        from ..runtime import hbm

        path, key, tag, config = device_source
        source = hbm.dataset_source(ds, path, key, blocking, list(block_ids), halo,
                                    tuple(tag) + (str(dtype),), config)
        dc = hbm.cache() if source is not None else None
        hit = dc.get(source) if dc is not None else None
        if hit is not None:
            obs_metrics.inc("device.uploads_skipped")
            return BlockBatch(data=None, valid=valid, blocks=blocks, block_ids=list(block_ids),
                              source=source, device=hit)

    def _read(bh):
        arr = ds[bh.outer.slicing]
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        pad = [(0, f - s) for f, s in zip(full, arr.shape)]
        return np.pad(arr, pad, mode=pad_mode) if any(p for _, p in pad) else arr

    n = min(n_threads, len(blocks))
    if n > 1:
        with ThreadPoolExecutor(n) as pool:
            datas = list(pool.map(_read, blocks))
    else:
        datas = [_read(bh) for bh in blocks]
    return BlockBatch(data=np.stack(datas), valid=valid, blocks=blocks,
                      block_ids=list(block_ids), source=source)
