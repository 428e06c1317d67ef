"""Execution backends — the ``target=`` seam.

Port of ``cluster_tools_tpu/runtime/executor.py``:

  * ``local`` — host loop (a thread pool at ``max_jobs`` > 1) over
    ``process_block``; each block computes on the configured device;
  * ``cuda``  — batched dispatch, the counterpart of the JAX package's
    ``tpu`` target.  Blocks are grouped into batches of
    ``device_batch_size`` per card (default 8 on the card, 1 on the CPU)
    times the card count from ``torch.cuda``.  Tasks implementing the split
    protocol run a three-stage pipeline: a read pool prefetches batch i+1,
    the calling thread runs every ``compute_batch`` in order, a write pool
    drains batch i-1 — each stage holds at most ``pipeline_depth`` batches.
    A batch that fails degrades to per-block ``process_block`` calls.

The profiler hook and the device-buffer cache of the JAX package wait
(ROADMAP Queue A 9).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence, Tuple

from .device import device_count, resolve_device

RunResult = Tuple[List[int], List[int], Dict[int, str]]  # done, failed, errors


def resolve_batch_size(config: Dict[str, Any]) -> int:
    """Blocks per dispatch: ``device_batch_size`` (default 8 on the card,
    1 on the CPU) times the card count."""
    per_card = config.get("device_batch_size")
    if per_card is None:
        per_card = 8 if resolve_device(config).type == "cuda" else 1
    return max(int(per_card), 1) * max(device_count(config), 1)


class BaseExecutor:
    name = "base"

    def __init__(self, config: Dict[str, Any]):
        self.config = config

    def run_blocks(self, task, blocking, block_ids: Sequence[int], config) -> RunResult:
        raise NotImplementedError  # pragma: no cover - abstract


class LocalExecutor(BaseExecutor):
    """Host loop / thread pool over ``process_block``."""

    name = "local"

    def run_blocks(self, task, blocking, block_ids, config) -> RunResult:
        n_workers = max(int(config.get("max_jobs", 1)), 1)

        def _one(bid: int):
            try:
                t0 = time.perf_counter()
                task.process_block(bid, blocking, config)
                return bid, None, time.perf_counter() - t0
            except Exception:
                return bid, traceback.format_exc(), 0.0

        if n_workers == 1:
            results = [_one(b) for b in block_ids]
        else:
            with ThreadPoolExecutor(n_workers) as pool:
                results = list(pool.map(_one, block_ids))
        durations = [dt for _, err, dt in results if err is None]
        if durations:
            task.record_timing("blocks_total", len(durations), sum(durations))
        done = [bid for bid, err, _ in results if err is None]
        failed = [bid for bid, err, _ in results if err is not None]
        errors = {bid: err for bid, err, _ in results if err is not None}
        return done, failed, errors


class CudaExecutor(BaseExecutor):
    """Batched dispatch with the read → compute → write pipeline."""

    name = "cuda"

    def run_blocks(self, task, blocking, block_ids, config) -> RunResult:
        size = resolve_batch_size(config)
        ids = list(block_ids)
        chunks = [ids[i: i + size] for i in range(0, len(ids), size)]
        depth = max(int(config.get("pipeline_depth", 2)), 1)
        done: List[int] = []
        failed: List[int] = []
        errors: Dict[int, str] = {}
        stage_s = {"read": 0.0, "compute": 0.0, "write": 0.0}
        read_fn, compute_fn, write_fn = task.read_batch, task.compute_batch, task.write_batch

        lock = threading.Lock()

        def _timed(stage, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            with lock:
                stage_s[stage] += time.perf_counter() - t0
            return out

        def _fallback(chunk):
            for bid in chunk:
                try:
                    task.process_block(bid, blocking, config)
                    done.append(bid)
                except Exception:
                    failed.append(bid)
                    errors[bid] = traceback.format_exc()

        reads: deque = deque()
        writes: deque = deque()

        def _drain_write():
            chunk, fut = writes.popleft()
            try:
                fut.result()
                done.extend(chunk)
            except Exception:
                _fallback(chunk)

        with ThreadPoolExecutor(depth, thread_name_prefix="ctt-read") as read_pool, \
                ThreadPoolExecutor(1, thread_name_prefix="ctt-write") as write_pool:

            def _consume():
                chunk, fut = reads.popleft()
                try:
                    payload = fut.result()
                    t0 = time.perf_counter()
                    result = compute_fn(payload, blocking, config)
                    dt = time.perf_counter() - t0
                    with lock:
                        stage_s["compute"] += dt
                    task.record_timing(f"batch_{chunk[0]}_{chunk[-1]}", len(chunk), dt)
                except Exception:
                    _fallback(chunk)
                    return
                writes.append((chunk, write_pool.submit(
                    _timed, "write", write_fn, result, blocking, config
                )))
                while len(writes) > depth:
                    _drain_write()

            for chunk in chunks:
                reads.append((chunk, read_pool.submit(
                    _timed, "read", read_fn, chunk, blocking, config
                )))
                while len(reads) >= depth:
                    _consume()
            while reads:
                _consume()
            while writes:
                _drain_write()
        n_blocks = len(ids)
        for stage, seconds in stage_s.items():
            task.record_timing(f"stage_{stage}_total", n_blocks, seconds)
        return done, failed, errors


_EXECUTORS = {"local": LocalExecutor, "cuda": CudaExecutor}


def get_executor(target: str, config: Dict[str, Any]) -> BaseExecutor:
    try:
        return _EXECUTORS[target](config)
    except KeyError:
        raise ValueError(
            f"unknown target {target!r}; available: {sorted(_EXECUTORS)}"
        ) from None


def register_executor(name: str, cls) -> None:
    """Seam for additional backends."""
    _EXECUTORS[name] = cls
