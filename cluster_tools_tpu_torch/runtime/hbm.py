"""Device residency: the warm buffer cache of device tensors and the
stacked dispatch helpers (port of ``cluster_tools_tpu/runtime/hbm.py``).

  * ``DeviceBufferCache`` — a process-wide LRU of ``DeviceBatch`` entries
    (tuples of tensors on the task's device) keyed by ``(volume, block
    ids, halo, transform tag, device)`` under a byte budget
    (``CTT_HBM_CACHE_MB``, default 0: off).  Freshness rides the store's
    per-chunk file signatures (``Dataset.region_signature``): a rewrite of
    any chunk the batch covers turns the next probe into a miss, and the
    stale entry is dropped.  Eviction drops the cache's references to the
    tensors (``DeviceBatch.delete``), so PyTorch's caching allocator can
    reuse the memory.
  * ``use_guard`` — a scope in which a device batch is being read (the
    executor's and the fused chain's compute stages): an eviction inside
    any active guard defers its ``delete`` until the last guard exits
    (``device.deferred_deletes``), so another thread's eviction never drops
    a batch an in-flight dispatch still reads.
  * ``fetch_or_upload`` — probe the cache, else build the batch (the
    host-to-device copy) under the process-wide two-slot transfer gate
    (``upload_slot``) and insert it; ``batch_device`` is the call tasks
    use for a ``parallel.dispatch.BlockBatch``.
  * ``stack_block_batches`` / ``split_block_batch`` / ``split_stacked`` —
    ``hbm_stack`` read payloads concatenated along the batch axis into one
    dispatch and split back for the write stage (``runtime/executor.py``).

The cache never answers with host data in place of device tensors: a
batch whose read probe hit carries no host data, and if its entry is gone
by the compute, ``require_data`` raises and the executor re-reads the
blocks one by one.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from .device import resolve_device

__all__ = [
    "DeviceBufferCache", "DeviceBatch", "BatchSource", "cache", "cache_budget_bytes",
    "set_cache_budget", "dataset_source", "fetch_or_upload", "batch_device", "require_data",
    "upload_slot", "use_guard", "stack_block_batches", "split_block_batch", "split_stacked",
    "hbm_stack", "UPLOAD_SLOTS",
]

# -- the eviction guard ----------------------------------------------------------

_GUARD_LOCK = threading.Lock()
_ACTIVE_GUARDS = 0
_DEFERRED_DELETES: list = []


class use_guard:
    """A scope in which evicted device batches must not be freed yet."""

    def __enter__(self):
        global _ACTIVE_GUARDS
        with _GUARD_LOCK:
            _ACTIVE_GUARDS += 1
        return self

    def __exit__(self, *exc):
        global _ACTIVE_GUARDS
        drain: list = []
        with _GUARD_LOCK:
            _ACTIVE_GUARDS -= 1
            if _ACTIVE_GUARDS == 0 and _DEFERRED_DELETES:
                drain = list(_DEFERRED_DELETES)
                _DEFERRED_DELETES.clear()
        for batch in drain:
            batch.delete()
        return False


def _delete_or_defer(batch: "DeviceBatch") -> None:
    with _GUARD_LOCK:
        if _ACTIVE_GUARDS > 0:
            _DEFERRED_DELETES.append(batch)
            obs_metrics.inc("device.deferred_deletes")
            return
    batch.delete()


def cache_budget_bytes() -> int:
    """``CTT_HBM_CACHE_MB`` in bytes (default 0: off; a malformed value
    is 0)."""
    raw = os.environ.get("CTT_HBM_CACHE_MB")
    try:
        mb = float(raw) if raw is not None else 0.0
    except (TypeError, ValueError):
        mb = 0.0
    return max(int(mb * 1024 * 1024), 0)


@dataclass
class DeviceBatch:
    """One batch's upload: the task's tuple of device tensors, the real
    batch size and the host bytes that crossed to the device."""

    arrays: Tuple[Any, ...]
    n: int
    nbytes: int

    def delete(self) -> None:
        """Drop the references to the tensors (the allocator reuses their
        memory once no dispatch holds them)."""
        self.arrays = ()


@dataclass(frozen=True)
class BatchSource:
    """Identity (``key``, hashable) and freshness (``sig``, the per-chunk
    store signatures) of the store region one upload covers."""

    key: Tuple
    sig: Tuple = field(hash=False, compare=False, default=())


class DeviceBufferCache:
    """LRU of ``DeviceBatch`` entries under a byte budget: a probe whose
    signature differs is a miss that drops the stale entry; an insert
    evicts the least recently used entries past the budget."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Tuple[Tuple, DeviceBatch]]" = OrderedDict()
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, source: BatchSource) -> Optional[DeviceBatch]:
        with self._lock:
            entry = self._entries.get(source.key)
            if entry is None:
                return None
            if entry[0] == source.sig:
                self._entries.move_to_end(source.key)
                return entry[1]
            stale = self._pop_locked(source.key)
        obs_metrics.inc("device.cache_evictions")
        _delete_or_defer(stale)
        self._publish()
        return None

    def put(self, source: BatchSource, batch: DeviceBatch) -> None:
        if self.max_bytes <= 0 or batch.nbytes > self.max_bytes:
            return
        evicted = []
        with self._lock:
            old = self._pop_locked(source.key)
            if old is not None and old is not batch:
                evicted.append(old)
            self._entries[source.key] = (source.sig, batch)
            self._bytes += batch.nbytes
            while self._bytes > self.max_bytes and self._entries:
                evicted.append(self._pop_locked(next(iter(self._entries))))
        for out in evicted:
            obs_metrics.inc("device.cache_evictions")
            _delete_or_defer(out)
        self._publish()

    def _pop_locked(self, key) -> Optional[DeviceBatch]:
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        self._bytes -= entry[1].nbytes
        return entry[1]

    def clear(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
        for _, batch in entries:
            _delete_or_defer(batch)
        self._publish()

    def _publish(self) -> None:
        obs_metrics.set_gauge("device.cache_bytes", self._bytes)

    def describe(self) -> dict:
        with self._lock:
            return {"budget_bytes": self.max_bytes, "bytes": self._bytes,
                    "entries": len(self._entries)}


_CACHE_LOCK = threading.Lock()
_CACHE: Optional[DeviceBufferCache] = None


def _process_cache() -> DeviceBufferCache:
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = DeviceBufferCache(cache_budget_bytes())
        return _CACHE


def cache() -> Optional[DeviceBufferCache]:
    """The process's device-buffer cache, or None when its budget is 0 (no
    probes, no entries, no counters)."""
    dc = _process_cache()
    return dc if dc.max_bytes > 0 else None


def set_cache_budget(max_bytes: Optional[int]) -> int:
    """Set the process cache's budget (``None``: ``CTT_HBM_CACHE_MB``
    again) and return the previous one; any change drops the entries."""
    dc = _process_cache()
    prev = dc.max_bytes
    dc.max_bytes = cache_budget_bytes() if max_bytes is None else max(int(max_bytes), 0)
    dc.clear()
    return prev


def dataset_source(ds, path: str, key: str, blocking, block_ids, halo, tag: Tuple,
                   config) -> Optional[BatchSource]:
    """The ``BatchSource`` of one batch read: identity from ``(path, key,
    block ids, halo, tag, device)``, freshness from the signatures of every
    chunk that overlaps the batch's halo'd bounding box.  None when the
    cache is off or the dataset cannot sign a region (hdf5)."""
    if cache() is None or not block_ids:
        return None
    sig_fn = getattr(ds, "region_signature", None)
    if sig_fn is None:
        return None
    from ..parallel.dispatch import batch_outer_boxes

    halo = tuple(int(h) for h in (halo or (0,) * blocking.ndim))
    _, lo, hi, _ = batch_outer_boxes(blocking, block_ids, halo)
    lead = tuple(slice(0, s) for s in ds.shape[:len(ds.shape) - blocking.ndim])
    sig = sig_fn(lead + tuple(slice(b, e) for b, e in zip(lo, hi)))
    if sig is None:
        return None
    return BatchSource(
        key=(path, key, tuple(int(b) for b in block_ids), halo, tuple(tag),
             str(resolve_device(config))),
        sig=sig,
    )


# at most two host-to-device copies in flight in the process: batch k
# computes while k+1 copies and k+2 waits at the gate
UPLOAD_SLOTS = 2
_UPLOAD_GATE = threading.BoundedSemaphore(UPLOAD_SLOTS)
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT = 0


class upload_slot:
    """One in-flight host-to-device copy (``device.inflight_uploads``)."""

    def __enter__(self):
        global _INFLIGHT
        _UPLOAD_GATE.acquire()
        with _INFLIGHT_LOCK:
            _INFLIGHT += 1
            obs_metrics.set_gauge("device.inflight_uploads", _INFLIGHT)
        return self

    def __exit__(self, *exc):
        global _INFLIGHT
        with _INFLIGHT_LOCK:
            _INFLIGHT -= 1
            obs_metrics.set_gauge("device.inflight_uploads", _INFLIGHT)
        _UPLOAD_GATE.release()
        return False


def fetch_or_upload(source: Optional[BatchSource],
                    build: Callable[[], DeviceBatch]) -> DeviceBatch:
    """The cache's entry under ``source`` (``device.uploads_skipped``), else
    ``build()`` under an upload slot (``device.upload_bytes``), inserted
    when ``source`` is cacheable."""
    dc = cache() if source is not None else None
    if dc is not None:
        hit = dc.get(source)
        if hit is not None:
            obs_metrics.inc("device.uploads_skipped")
            return hit
    with upload_slot():
        batch = build()
    obs_metrics.inc("device.upload_bytes", int(batch.nbytes))
    if dc is not None:
        dc.put(source, batch)
    return batch


def require_data(batch) -> np.ndarray:
    """The batch's host data; raises for a probe-hit batch whose entry was
    evicted before its compute (the executor then re-reads its blocks)."""
    if batch.data is None:
        raise RuntimeError("device-cache entry evicted between the read probe and the "
                           "compute; the blocks are read again one by one")
    return batch.data


def batch_device(batch, config, build: Optional[Callable[[], DeviceBatch]] = None) -> DeviceBatch:
    """The device tensors of a ``BlockBatch``: those its read probe found
    (``batch.device``), else the cache's under ``batch.source``, else
    ``build()`` — by default the copy of ``batch.data`` to the task's
    device.  The result is kept on the batch."""
    if batch.device is not None:
        return batch.device
    if build is None:
        def build() -> DeviceBatch:
            data = require_data(batch)
            x = torch.from_numpy(data).to(resolve_device(config))
            return DeviceBatch(arrays=(x,), n=int(data.shape[0]), nbytes=int(data.nbytes))
    batch.device = fetch_or_upload(batch.source, build)
    return batch.device


# -- stacked dispatch ------------------------------------------------------------


def stack_block_batches(batches, config=None):
    """``BlockBatch``es concatenated along the batch axis, geometry
    included.  When every batch's read probe hit, the stack concatenates
    their device tensors on the device; a stack that mixes probe hits and
    host reads has neither, and its compute raises (``require_data``), so
    the executor re-reads its blocks one by one."""
    from ..parallel.dispatch import BlockBatch

    if len(batches) == 1:
        return batches[0]
    datas = [b.data for b in batches]
    valids = [b.valid for b in batches]
    out = BlockBatch(
        data=np.concatenate(datas, axis=0) if all(d is not None for d in datas) else None,
        valid=np.concatenate(valids, axis=0) if all(v is not None for v in valids) else None,
        blocks=[bh for b in batches for bh in b.blocks],
        block_ids=[bid for b in batches for bid in b.block_ids],
    )
    sources = [b.source for b in batches]
    if all(s is not None for s in sources):
        # the stacked upload is its own cache line
        out.source = BatchSource(key=("stack",) + tuple(s.key for s in sources),
                                 sig=tuple(s.sig for s in sources))
    devices = [b.device for b in batches]
    if out.data is None and all(d is not None for d in devices):
        out.device = DeviceBatch(
            arrays=tuple(torch.cat([d.arrays[slot][: d.n] for d in devices])
                         for slot in range(len(devices[0].arrays))),
            n=sum(d.n for d in devices), nbytes=sum(d.nbytes for d in devices))
    return out


def split_block_batch(batch, counts) -> list:
    """A stacked ``BlockBatch`` split back into batches of ``counts``
    blocks; their device and source are dropped (the write stage needs the
    geometry only)."""
    from ..parallel.dispatch import BlockBatch

    out, off = [], 0
    for c in counts:
        out.append(BlockBatch(
            data=None if batch.data is None else batch.data[off: off + c],
            valid=None if batch.valid is None else batch.valid[off: off + c],
            blocks=batch.blocks[off: off + c], block_ids=batch.block_ids[off: off + c]))
        off += c
    return out


def split_stacked(results, counts) -> list:
    """Per-block results (an array or a list along the batch axis) split
    into pieces of ``counts``."""
    out, off = [], 0
    for c in counts:
        out.append(results[off: off + c])
        off += c
    return out


def hbm_stack(config) -> int:
    """Read payloads per dispatch: the ``hbm_stack`` config key, else
    ``CTT_HBM_STACK``, else 1; a malformed value is 1."""
    raw = config.get("hbm_stack")
    if raw is None:
        raw = os.environ.get("CTT_HBM_STACK")
    try:
        n = int(raw) if raw is not None else 1
    except (TypeError, ValueError):
        n = 1
    return max(n, 1)
