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
    of ``pipeline_depth`` threads drains the batches before it — each stage
    holds at most ``pipeline_depth`` batches, so up to that many batches
    write at once (the store serialises two writes into one chunk).  A task
    whose blocks read what other blocks of the same run write
    (``pipeline_safe = False``: the two-pass watershed's pass 2) runs one
    batch at a time instead, read → compute → write, and on ``local`` one
    block at a time; a task with an hdf5 path has ``pipeline_depth`` 1
    (``runtime/task.py::hdf5_single_thread``), so one writer.  A batch that
    fails degrades to per-block ``process_block`` calls.  Tasks without the
    split protocol run as on ``local``.

Two device-side levers sit on the same pipeline (``runtime/hbm.py``):

  * stacked dispatch — with ``hbm_stack: k`` (or ``CTT_HBM_STACK``) a task
    with ``stack_payloads`` / ``unstack_results`` has up to ``k``
    consecutive read payloads concatenated into one compute call
    (``stacked_dispatch``) and the result split back per batch for the
    write pool, so the host IO is unchanged and the dispatches drop k-fold;
  * the transfer stage — a task with ``upload_batch`` has each payload
    copied to the device on a transfer thread, at most
    ``hbm.UPLOAD_SLOTS`` ahead, while the previous dispatch computes.

Both stay off for a task that is not ``pipeline_safe``.  The JAX package's
profiler hook is ROADMAP Queue A 12(d).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence, Tuple

from ..obs import metrics as obs_metrics
from .device import device_count, resolve_device

RunResult = Tuple[List[int], List[int], Dict[int, str]]  # done, failed, errors


def resolve_batch_size(config: Dict[str, Any]) -> int:
    """Blocks per dispatch: ``device_batch_size`` (default 8 on the card,
    1 on the CPU) times the card count."""
    per_card = config.get("device_batch_size")
    if per_card is None:
        per_card = 8 if resolve_device(config).type == "cuda" else 1
    return max(int(per_card), 1) * max(device_count(config), 1)


def stacked_dispatch(task, compute_fn, payload, blocking, config, all_ids: List[int],
                     fused: bool):
    """One compute call over a (possibly stacked) payload, inside the
    device-buffer cache's guard, so that an eviction by another thread
    never drops tensors the dispatch reads.  Counts ``device.dispatches``
    and, for a stack of several batches, ``device.fused_blocks``."""
    from . import hbm

    with hbm.use_guard():
        result = compute_fn(payload, blocking, config)
    obs_metrics.inc("device.dispatches")
    if fused:
        obs_metrics.inc("device.fused_blocks", len(all_ids))
    return result


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
        if not getattr(task, "pipeline_safe", True):
            n_workers = 1  # blocks read what other blocks write: one at a time

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
        if not all(hasattr(task, f) for f in ("read_batch", "compute_batch", "write_batch")):
            # host-only block tasks (faces, write) loop over process_block
            return LocalExecutor(self.config).run_blocks(task, blocking, block_ids, config)
        from . import hbm

        size = resolve_batch_size(config)
        ids = list(block_ids)
        chunks = [ids[i: i + size] for i in range(0, len(ids), size)]
        serial = not getattr(task, "pipeline_safe", True)
        depth = 1 if serial else max(int(config.get("pipeline_depth", 2)), 1)
        done: List[int] = []
        failed: List[int] = []
        errors: Dict[int, str] = {}
        stage_s = {"read": 0.0, "compute": 0.0, "write": 0.0, "upload": 0.0}
        read_fn, compute_fn, write_fn = task.read_batch, task.compute_batch, task.write_batch
        stack_fn = getattr(task, "stack_payloads", None)
        unstack_fn = getattr(task, "unstack_results", None)
        stack_n = hbm.hbm_stack(config) if stack_fn and unstack_fn and not serial else 1
        upload_fn = None if serial else getattr(task, "upload_batch", None)

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

        reads: deque = deque()    # (chunk, Future[payload])
        uploads: deque = deque()  # (group, counts, Future[payload])
        writes: deque = deque()   # (chunk, Future[None])

        def _drain_write():
            chunk, fut = writes.popleft()
            try:
                fut.result()
                done.extend(chunk)
            except Exception:
                _fallback(chunk)

        with ThreadPoolExecutor(depth, thread_name_prefix="ctt-read") as read_pool, \
                ThreadPoolExecutor(depth, thread_name_prefix="ctt-write") as write_pool, \
                ThreadPoolExecutor(1, thread_name_prefix="ctt-upload") as upload_pool:

            def _compute_group(group, counts, payload):
                all_ids = [b for c in group for b in c]
                try:
                    t0 = time.perf_counter()
                    result = stacked_dispatch(task, compute_fn, payload, blocking, config,
                                              all_ids, fused=len(group) > 1)
                    dt = time.perf_counter() - t0
                    with lock:
                        stage_s["compute"] += dt
                    task.record_timing(f"batch_{all_ids[0]}_{all_ids[-1]}", len(all_ids), dt)
                    results = (unstack_fn(result, counts, blocking, config) if len(group) > 1
                               else [result])
                except Exception:
                    for chunk in group:
                        _fallback(chunk)
                    return
                for chunk, res in zip(group, results):
                    writes.append((chunk, write_pool.submit(
                        _timed, "write", write_fn, res, blocking, config)))
                while len(writes) > depth:
                    _drain_write()

            def _drain_upload():
                group, counts, fut = uploads.popleft()
                try:
                    payload = fut.result()
                except Exception:
                    for chunk in group:
                        _fallback(chunk)
                    return
                _compute_group(group, counts, payload)

            def _consume():
                """One dispatch group: up to ``stack_n`` read payloads,
                stacked, through the transfer stage when the task has one.
                The deques are FIFO, so the device sees the serial loop's
                dispatch order."""
                group, payloads = [], []
                while reads and len(group) < stack_n:
                    chunk, fut = reads.popleft()
                    try:
                        payloads.append(fut.result())
                        group.append(chunk)
                    except Exception:
                        _fallback(chunk)
                if not group:
                    return
                counts = [len(c) for c in group]
                try:
                    payload = stack_fn(payloads, blocking, config) if len(group) > 1 else payloads[0]
                except Exception:
                    for chunk in group:
                        _fallback(chunk)
                    return
                if upload_fn is None:
                    _compute_group(group, counts, payload)
                    return
                uploads.append((group, counts, upload_pool.submit(
                    _timed, "upload", upload_fn, payload, blocking, config)))
                while len(uploads) >= hbm.UPLOAD_SLOTS:
                    _drain_upload()

            for chunk in chunks:
                while serial and writes:
                    # the batch's neighbour labels must not depend on timing:
                    # it reads only after the previous batch is written
                    _drain_write()
                reads.append((chunk, read_pool.submit(
                    _timed, "read", read_fn, chunk, blocking, config
                )))
                while len(reads) >= max(depth, stack_n):
                    _consume()
            while reads:
                _consume()
            while uploads:
                _drain_upload()
            while writes:
                _drain_write()
        n_blocks = len(ids)
        for stage, seconds in stage_s.items():
            task.record_timing(f"stage_{stage}_total", n_blocks, seconds)
            obs_metrics.inc(f"executor.stage_{stage}_s", seconds)
        obs_metrics.inc("executor.stage_batches", len(chunks))
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
