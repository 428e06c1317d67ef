"""Stream fusion: a chain of split-protocol block tasks as one pass over the
volume (port of ``cluster_tools_tpu/runtime/stream.py``).

Task at a time, threshold → components → watershed write every
intermediate volume to the store and read it back.  A ``FusedChain``
declared by a workflow (``WorkflowBase.fused_chains``) runs its members as
one streaming pass instead:

  * each batch of blocks is read from the store once, at the largest halo
    of the members; smaller reads are crops of that host buffer
    (``parallel/dispatch.py::BlockReadCache``);
  * the batch flows through every member's ``fused_compute_batch`` in the
    declared order; a member that consumes an in-chain product builds its
    payload from the producer's handoff (``fused_read_batch``), a tensor on
    the task's device, so an elided intermediate never reaches the store;
  * only the outputs of members that are not elided are written, plus small
    carried state (max ids, face pairs: the ``fusion_carry_*`` hooks) that
    stands in for the re-reads of the tasks the chain ``covers``.

A chain that cannot run fused (``stream_fusion`` off, a multi-process
topology, an ROI or block list, a member that is not fusable, progress of
an earlier run) is declined: ``try_run_chain`` prints why, counts
``stream.fallbacks`` and the build runs the tasks one at a time, which
computes the same bytes.  A chain that fails mid-stream falls back the same
way; block writes are idempotent.

The runner is the cuda executor's pipeline widened to the member sequence:
a read pool, the compute stage on the calling thread in batch order (so
the carry sees batches in order), and a write pool.  A failed batch is
retried whole, up to ``max_num_retries`` times, before its carry applies.
Member computes run inside the device-buffer cache's guard
(``runtime/hbm.py::use_guard``).  The JAX package's spans, heartbeats and
fault-injection sites here are ROADMAP Queue A 13.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..parallel.dispatch import BlockReadCache, use_read_cache
from ..utils import store
from ..utils.blocking import Blocking
from . import config as cfg
from .device import resolve_device
from .executor import resolve_batch_size


@dataclass
class FusedChain:
    """A declared chain of split-protocol block tasks.

    ``members`` run in the declared order, producers before consumers.
    ``elide`` names members whose volume output is never written (their
    ``prepare`` and ``write_batch`` are skipped; in-chain consumers take the
    handoff).  ``covers`` lists tasks whose outputs the chain writes from
    carried state at finalize; they are stamped complete without running.
    """

    name: str
    members: List[Any]
    elide: frozenset = frozenset()
    covers: List[Any] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.elide = frozenset(self.elide)
        ids = [m.identifier for m in self.members]
        if len(set(ids)) != len(ids):
            raise ValueError(f"fused chain {self.name!r}: duplicate member identifiers {ids}")
        unknown = self.elide - set(ids)
        if unknown:
            raise ValueError(f"fused chain {self.name!r}: elide names non-members {sorted(unknown)}")


class ChainFallback(RuntimeError):
    """The planner declines a chain; the build runs its tasks one at a time."""


def fusion_enabled(gconf: Dict[str, Any]) -> bool:
    """``stream_fusion`` in the global config (default on), unless the
    ``CTT_STREAM_FUSION`` environment says ``0``/``false``/``off``/``no``."""
    env = os.environ.get("CTT_STREAM_FUSION", "").strip().lower()
    if env in ("0", "false", "off", "no"):
        return False
    return bool(gconf.get("stream_fusion", True))


@dataclass
class _ChainPlan:
    chain: FusedChain
    gconf: Dict[str, Any]
    mconfs: Dict[str, Dict[str, Any]]
    blocking: Blocking
    block_ids: List[int]
    chunks: List[List[int]]
    # external (path, key) -> the largest halo of the members reading it
    prefetch: Dict[Tuple[str, str], Tuple[int, ...]]
    # in-chain (path, key) -> the identifier of the member producing it
    produced: Dict[Tuple[str, str], str]
    depth: int
    retries: int


def _member_output_pair(member) -> Optional[Tuple[str, str]]:
    path = getattr(member, "output_path", None)
    key = getattr(member, "output_key", None)
    return None if path is None or key is None else (path, key)


def _has_split_protocol(member) -> bool:
    return all(callable(getattr(member, name, None))
               for name in ("read_batch", "compute_batch", "write_batch"))


def _max_halo(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    n = max(len(a), len(b))
    return tuple(max(x, y) for x, y in zip(a + (0,) * (n - len(a)), b + (0,) * (n - len(b))))


def plan_chain(chain: FusedChain) -> _ChainPlan:
    """Check that the chain can run fused and build its plan; raises
    ``ChainFallback`` with the reason otherwise.  A device that is asked
    for and missing raises from ``resolve_device``, as every entry point
    does."""
    from .task import BlockTask, hdf5_single_thread

    members = list(chain.members)
    if not members:
        raise ChainFallback("empty chain")
    head = members[0]
    gconf = head.global_config()
    resolve_device(gconf)
    if not fusion_enabled(gconf):
        raise ChainFallback("stream_fusion disabled")
    _, num = cfg.process_topology(gconf)
    if num > 1:
        raise ChainFallback("multi-process topology (the carry is per process and a "
                            "round-robin block split would separate neighbour faces)")
    if gconf.get("roi_begin") is not None or gconf.get("block_list_path"):
        raise ChainFallback("ROI or block-list restriction (the carried faces need the "
                            "whole block grid)")

    produced: Dict[Tuple[str, str], str] = {}
    prefetch: Dict[Tuple[str, str], Tuple[int, ...]] = {}
    mconfs: Dict[str, Dict[str, Any]] = {}
    for m in members:
        if not isinstance(m, BlockTask):
            raise ChainFallback(f"{m!r} is not a block task")
        if not getattr(m, "fusable", False) or not _has_split_protocol(m):
            raise ChainFallback(f"{m.identifier} is not a fusable split-protocol task")
        if not getattr(m, "pipeline_safe", True):
            raise ChainFallback(f"{m.identifier} declares pipeline_safe=False (reads regions "
                                "that blocks of the same run write)")
        mconf = hdf5_single_thread(m, {**gconf, **m.get_task_config()})
        mconfs[m.identifier] = mconf
        halo = tuple(int(x) for x in (m.fusion_halo(mconf) or ()))
        for pair in m.fusion_inputs(mconf) or []:
            if pair in produced:
                if type(m).fused_read_batch is BlockTask.fused_read_batch:
                    raise ChainFallback(f"{m.identifier} consumes in-chain product {pair} "
                                        "but does not implement fused_read_batch")
                continue
            prefetch[pair] = halo if pair not in prefetch else (
                _max_halo(prefetch[pair], halo) or prefetch[pair])
        out_pair = _member_output_pair(m)
        if out_pair is not None:
            produced[out_pair] = m.identifier

    # a resumed run mixes per-task state with streamed state: decline, and
    # the per-task resume finishes it
    for t in members + list(chain.covers):
        status = t.output().read()
        if status.get("complete") or status.get("done"):
            raise ChainFallback(f"{t.identifier} has prior progress (resumed run)")

    # the head's blocking; members reading only external data must agree
    # (a consumer of an in-chain product inherits it: its input may not
    # exist yet)
    shape = tuple(head.get_shape())
    blocking = Blocking(shape, head.get_block_shape(gconf))
    for m in members[1:]:
        inputs = m.fusion_inputs(mconfs[m.identifier]) or []
        consumes = any(p in produced and produced[p] != m.identifier for p in inputs)
        if not consumes and tuple(m.get_shape()) != shape:
            raise ChainFallback(f"{m.identifier} shape {tuple(m.get_shape())} != head shape {shape}")
    block_ids = head.get_block_list(blocking, gconf)
    if list(block_ids) != list(range(blocking.n_blocks)):
        raise ChainFallback("block list is not the full grid")

    ndim = blocking.ndim
    prefetch = {pair: tuple((list(h) + [0] * ndim)[:ndim])
                for pair, h in prefetch.items() if pair not in produced}
    size = resolve_batch_size(gconf)
    chunks = [list(block_ids[i: i + size]) for i in range(0, len(block_ids), size)]
    return _ChainPlan(
        chain=chain, gconf=gconf, mconfs=mconfs, blocking=blocking,
        block_ids=list(block_ids), chunks=chunks, prefetch=prefetch, produced=produced,
        depth=max(int(gconf.get("pipeline_depth", 2)), 1),
        retries=max(int(gconf.get("max_num_retries", 0)), 0),
    )


def try_run_chain(chain: FusedChain) -> bool:
    """Run ``chain`` fused.  True when it ran to its end (members and
    covered tasks stamped complete); False when it was declined or failed,
    and the caller runs the tasks one at a time — safe, since nothing is
    stamped on failure and block writes are idempotent."""
    try:
        plan = plan_chain(chain)
    except ChainFallback as e:
        obs_metrics.inc("stream.fallbacks")
        print(f"[ctt-stream] chain {chain.name!r}: falling back to task-at-a-time ({e})")
        return False
    try:
        _ChainRunner(plan).run()
        return True
    except Exception:
        obs_metrics.inc("stream.fallbacks")
        print(f"[ctt-stream] chain {chain.name!r} failed mid-stream; falling back to "
              f"task-at-a-time (block writes are idempotent):\n{traceback.format_exc()}")
        return False


def _carry_nbytes(member, carry) -> int:
    return 0 if carry is None else int(member.fusion_carry_nbytes(carry))


class _ChainRunner:
    """One streaming pass: read pool → compute in batch order → write pool.

    The compute stage and the carry run on the calling thread in batch
    order, so the device sees the serial loop's dispatch order and the
    carry the serial loop's state; the pools only move IO off the critical
    path.  ``prepare`` + ``run_chunk`` * n + ``finalize`` is ``run``
    without the pipelining, for a caller that runs a chunk at a time;
    ``export_carry`` / ``import_carry`` move the carry between such runs."""

    def __init__(self, plan: _ChainPlan):
        self.plan = plan
        self.members = list(plan.chain.members)
        self.elide = plan.chain.elide
        self.carry: Dict[str, Any] = {}
        self.carry_peak = 0
        self.stage_s = {"read": 0.0, "compute": 0.0, "write": 0.0}
        self._acc_lock = threading.Lock()

    def _acc(self, stage: str, dt: float) -> None:
        with self._acc_lock:
            self.stage_s[stage] += dt

    # -- stages ----------------------------------------------------------------

    def _consumes_inchain(self, member) -> bool:
        pairs = member.fusion_inputs(self.plan.mconfs[member.identifier]) or []
        return any(p in self.plan.produced and self.plan.produced[p] != member.identifier
                   for p in pairs)

    def _read(self, chunk: List[int]):
        """Prefetch every external input's region of the batch at the
        chain's halo, then run each store-reading member's own
        ``read_batch`` against it."""
        plan = self.plan
        t0 = time.perf_counter()
        cache = BlockReadCache()
        for (path, key), halo in plan.prefetch.items():
            cache.prefetch(store.file_reader(path, "r")[key], path, key, plan.blocking,
                           chunk, halo)
        payloads = {}
        with use_read_cache(cache):
            for m in self.members:
                if not self._consumes_inchain(m):
                    payloads[m.identifier] = m.read_batch(chunk, plan.blocking,
                                                          plan.mconfs[m.identifier])
        self._acc("read", time.perf_counter() - t0)
        return payloads

    def _compute(self, chunk: List[int], payloads) -> Dict[str, Any]:
        """Every member's compute for the batch, in order; the handoffs
        chain the members on the device."""
        from . import hbm

        plan = self.plan
        handoffs: Dict[Tuple[str, str], Any] = {}
        results: Dict[str, Any] = {}
        t0 = time.perf_counter()
        with hbm.use_guard():
            for m in self.members:
                mid = m.identifier
                mconf = plan.mconfs[mid]
                payload = (payloads[mid] if mid in payloads
                           else m.fused_read_batch(handoffs, chunk, plan.blocking, mconf))
                t1 = time.perf_counter()
                result, handoff = m.fused_compute_batch(payload, plan.blocking, mconf,
                                                        elided=mid in self.elide)
                obs_metrics.inc("device.dispatches")
                m.record_timing(f"batch_{chunk[0]}_{chunk[-1]}", len(chunk),
                                time.perf_counter() - t1)
                results[mid] = result
                out_pair = _member_output_pair(m)
                if out_pair is not None:
                    handoffs[out_pair] = handoff
                if mid in self.elide:
                    obs_metrics.inc("stream.elided_bytes",
                                    int(m.fused_elided_nbytes(handoff, plan.blocking, mconf)))
        self._acc("compute", time.perf_counter() - t0)
        return results

    def _apply_carry(self, chunk: List[int], results) -> None:
        plan = self.plan
        for m in self.members:
            mid = m.identifier
            self.carry[mid] = m.fusion_carry_update(self.carry.get(mid), results[mid], chunk,
                                                    plan.blocking, plan.mconfs[mid])
            self.carry_peak = max(self.carry_peak, _carry_nbytes(m, self.carry.get(mid)))

    def _write(self, chunk: List[int], results) -> None:
        plan = self.plan
        t0 = time.perf_counter()
        for m in self.members:
            if m.identifier not in self.elide:
                m.write_batch(results[m.identifier], plan.blocking, plan.mconfs[m.identifier])
        self._acc("write", time.perf_counter() - t0)

    # -- a batch, with retries -------------------------------------------------

    def _run_batch_synchronous(self, chunk, apply_carry: bool) -> None:
        """Read → compute (→ carry) → write, serially: the retry path.
        ``apply_carry=False`` when an earlier attempt already carried the
        batch (recompute is deterministic, writes are idempotent)."""
        results = self._compute(chunk, self._read(chunk))
        if apply_carry:
            self._apply_carry(chunk, results)
        self._write(chunk, results)

    def _attempt(self, fn, chunk, what: str) -> None:
        """``fn`` with up to ``retries`` more attempts, each re-reading and
        recomputing the whole batch."""
        retries = self.plan.retries
        for attempt in range(retries + 1):
            try:
                fn()
                return
            except Exception:
                if attempt >= retries:
                    raise
                obs_metrics.inc("task.blocks_retried", len(chunk))
                print(f"[ctt-stream] {what} for blocks {chunk[0]}..{chunk[-1]} failed "
                      f"(attempt {attempt + 1}/{retries + 1}); retrying:\n"
                      f"{traceback.format_exc()}")

    def prepare(self) -> None:
        """Create the outputs of the members that are not elided and start
        each carry."""
        plan = self.plan
        for m in self.members:
            if m.identifier not in self.elide:
                m.prepare(plan.blocking, plan.mconfs[m.identifier])
            self.carry[m.identifier] = m.fusion_carry_init(plan.blocking,
                                                           plan.mconfs[m.identifier])

    def run_chunk(self, chunk: List[int]) -> None:
        """One batch, serially, with the full retry budget."""
        self._attempt(lambda: self._run_batch_synchronous(chunk, True), chunk, "batch")
        obs_metrics.inc("stream.slabs")

    def export_carry(self) -> Dict[str, Any]:
        """The carry and its peak size: what a chunk-at-a-time caller keeps
        between chunks."""
        return {"carry": dict(self.carry), "carry_peak": int(self.carry_peak)}

    def import_carry(self, state: Dict[str, Any]) -> None:
        self.carry = dict(state["carry"])
        self.carry_peak = max(self.carry_peak, int(state.get("carry_peak", 0)))

    def finalize(self, wall: float) -> None:
        """Members' finalizers, carry finalizers and completion stamps."""
        self._finish(wall)

    # -- the pass --------------------------------------------------------------

    def run(self) -> None:
        plan = self.plan
        obs_metrics.inc("stream.chains")
        self.prepare()
        t_wall0 = time.perf_counter()
        reads: deque = deque()   # (chunk, Future[payloads])
        writes: deque = deque()  # (chunk, Future[None])
        depth = plan.depth
        with ThreadPoolExecutor(depth, thread_name_prefix="ctt-stream-read") as read_pool, \
                ThreadPoolExecutor(depth, thread_name_prefix="ctt-stream-write") as write_pool:

            def _drain_write():
                chunk, fut = writes.popleft()
                try:
                    fut.result()
                except Exception:
                    # the write ran apart from its compute: re-run the batch
                    # serially (its carry is applied already)
                    self._attempt(lambda: self._run_batch_synchronous(chunk, False), chunk,
                                  "write recovery")
                obs_metrics.inc("stream.slabs")

            def _drain_read():
                chunk, fut = reads.popleft()
                try:
                    results = self._compute(chunk, fut.result())
                except Exception:
                    # failed before its carry: retry the whole batch serially
                    if plan.retries <= 0:
                        raise
                    obs_metrics.inc("task.blocks_retried", len(chunk))
                    print(f"[ctt-stream] batch {chunk[0]}..{chunk[-1]} failed in flight; "
                          f"retrying serially:\n{traceback.format_exc()}")
                    self._attempt(lambda: self._run_batch_synchronous(chunk, True), chunk,
                                  "batch retry")
                    obs_metrics.inc("stream.slabs")
                    return
                self._apply_carry(chunk, results)
                writes.append((chunk, write_pool.submit(self._write, chunk, results)))
                while len(writes) > depth:
                    _drain_write()

            for chunk in plan.chunks:
                reads.append((chunk, read_pool.submit(self._read, chunk)))
                while len(reads) >= depth:
                    _drain_read()
            while reads:
                _drain_read()
            while writes:
                _drain_write()
        self._finish(time.perf_counter() - t_wall0)

    def _finish(self, wall: float) -> None:
        plan = self.plan
        n_blocks = len(plan.block_ids)
        for m in self.members:
            m.finalize(plan.blocking, plan.mconfs[m.identifier], plan.block_ids)
        for m in self.members:
            m.fusion_finalize(self.carry.get(m.identifier), plan.blocking,
                              plan.mconfs[m.identifier])
        obs_metrics.set_gauge("stream.carry_bytes", int(self.carry_peak))
        # the stage sums land on the head's status (the chain shares one
        # pipeline); per-member compute walls were recorded per batch
        head = self.members[0]
        for stage, seconds in self.stage_s.items():
            head.record_timing(f"stage_{stage}_total", n_blocks, seconds)
            obs_metrics.inc(f"executor.stage_{stage}_s", seconds)
        obs_metrics.inc("executor.stage_batches", len(plan.chunks))
        done = set(plan.block_ids)
        for m in self.members:
            m._write_status(m.output(), plan.block_ids, done, [], [wall], True)
            m.log(f"done {m.identifier} (fused chain {plan.chain.name!r}) in {wall:.2f}s")
        for t in plan.chain.covers:
            t.output().write({"task": t.identifier, "complete": True,
                              "fused_chain": plan.chain.name, "runtime_s": 0.0, "timings": []})
