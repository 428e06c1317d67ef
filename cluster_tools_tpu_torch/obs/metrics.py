"""Counters and gauges: cheap process-local aggregates for hot paths (port
of ``cluster_tools_tpu/obs/metrics.py``, the registry without its flush
into a trace directory).

Wired in:

  * ``utils/store.py`` — ``store.bytes_read`` / ``store.bytes_written`` /
    ``store.chunks_read`` / ``store.chunks_written``: chunk payload sizes
    at the codec boundary, what crossed the filesystem.  A hit of the
    decoded-chunk LRU reads nothing and counts nothing, so store-traffic
    comparisons run at chunk-cache budget 0;
  * ``runtime/stream.py`` — ``stream.chains`` / ``stream.slabs`` /
    ``stream.elided_bytes`` (intermediate bytes that never reached the
    store) / ``stream.fallbacks`` and the ``stream.carry_bytes`` peak gauge;
    ``task.blocks_retried`` for batches a chain re-ran;
  * ``runtime/executor.py`` and ``runtime/stream.py`` —
    ``device.dispatches`` (compute calls), ``device.fused_blocks`` (blocks
    that rode a stacked dispatch), ``executor.stage_*_s`` (per-stage
    seconds) and ``executor.stage_batches``;
  * ``runtime/hbm.py`` — ``device.upload_bytes``, ``device.uploads_skipped``,
    ``device.cache_evictions``, ``device.deferred_deletes`` and the
    ``device.cache_bytes`` / ``device.inflight_uploads`` gauges.

The JAX package counts only while its tracing is on (``CTT_TRACE_DIR``);
the port has no tracing yet (spans, heartbeats and the trace directory are
ROADMAP Queue A 13), so its counters always count.  Read them with
``snapshot()`` before and after a run and take ``delta``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

__all__ = ["inc", "set_gauge", "snapshot", "delta", "reset"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, Any] = {}


def inc(name: str, value: float = 1.0) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0.0) + value


def set_gauge(name: str, value: Any) -> None:
    with _LOCK:
        _GAUGES[name] = value


def snapshot() -> Dict[str, Any]:
    """``{"counters": {...}, "gauges": {...}}``, copies."""
    with _LOCK:
        return {"counters": dict(_COUNTERS), "gauges": dict(_GAUGES)}


def delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, float]:
    """Counter increments between two snapshots (the ``counters`` of each)."""
    b, a = before.get("counters", before), after.get("counters", after)
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}


def reset() -> None:
    """Drop all accumulated values."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
