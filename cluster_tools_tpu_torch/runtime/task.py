"""Task protocol: resumable block tasks with positive per-block completion
records, and single-shot ``SimpleTask`` reductions.

Port of ``cluster_tools_tpu/runtime/task.py`` for one process: success is a
JSON status file per task (``done`` block list, per-attempt runtimes), a
re-run skips the blocks already done, and failed blocks are retried up to
``max_num_retries`` times unless at least ``retry_failure_fraction`` (50% by
default) of the blocks failed — then something fundamental broke and the
task raises ``FailedBlocksError`` without retrying.  Split-protocol block
tasks may take part in a fused chain (``runtime/stream.py``) through the
``fusable`` / ``fusion_*`` contract of ``BlockTask``.  Multi-host topology
is not ported (ROADMAP Queue A 12(d)).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from . import config as cfg
from ..utils.blocking import Blocking, blocks_in_volume
from ..utils.store import atomic_write_bytes, is_hdf5_path


def touches_hdf5(task) -> bool:
    """True when any path the task was given (``*_path``, ``input_paths``)
    is an hdf5 file."""
    for value in vars(task).values():
        paths = value if isinstance(value, (list, tuple)) else [value]
        if any(isinstance(v, str) and is_hdf5_path(v) for v in paths):
            return True
    return False


def hdf5_single_thread(task, config: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package reads an h5py dataset with one thread (h5py takes one
    lock for every call, so threads only add overhead): a task that touches
    an hdf5 file reads its batches one at a time (``pipeline_depth`` 1) and
    each batch's blocks one after another (``read_threads`` 1)."""
    if not touches_hdf5(task):
        return config
    return {**config, "read_threads": 1, "pipeline_depth": 1}


class FailedBlocksError(RuntimeError):
    """Blocks remain failed after the retries."""


class Target:
    """Completion marker of a task: a JSON status file in the tmp folder."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        try:
            return bool(self.read().get("complete", False))
        except (json.JSONDecodeError, OSError):
            return False

    def read(self) -> Dict[str, Any]:
        if not os.path.exists(self.path):
            return {}
        with open(self.path) as f:
            return json.load(f)

    def write(self, status: Dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        atomic_write_bytes(self.path, json.dumps(status, indent=2).encode())


class Task:
    """A node in the workflow DAG."""

    task_name: str = "task"

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        dependencies: Sequence["Task"] = (),
    ):
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.dependencies = list(dependencies)
        self._timings: List[Dict[str, Any]] = []

    def record_timing(self, label: str, n_blocks: int, seconds: float) -> None:
        self._timings.append(
            {"label": label, "blocks": int(n_blocks), "seconds": float(seconds)}
        )

    @property
    def identifier(self) -> str:
        return self.task_name

    def requires(self) -> Sequence["Task"]:
        return self.dependencies

    def output(self) -> Target:
        return Target(
            os.path.join(self.tmp_folder, "status", f"{self.identifier}.status.json")
        )

    def complete(self) -> bool:
        return self.output().exists()

    def run(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        return {}

    def get_task_config(self) -> Dict[str, Any]:
        return cfg.task_config(self.config_dir, self.task_name, self.default_task_config())

    def global_config(self) -> Dict[str, Any]:
        conf = cfg.global_config(self.config_dir)
        if self.max_jobs is not None:
            conf["max_jobs"] = self.max_jobs
        return conf

    @property
    def log_path(self) -> str:
        return os.path.join(self.tmp_folder, "logs", f"{self.identifier}.log")

    def log(self, msg: str) -> None:
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        with open(self.log_path, "a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}: {msg}\n")

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.identifier})"


class SimpleTask(Task):
    """A single-shot (non-blockwise) task: subclasses implement
    ``run_impl``; success is a status file with the runtime and timings."""

    def run(self) -> None:
        t0 = time.perf_counter()
        self.log(f"start {self.identifier}")
        self.run_impl()
        status = {
            "task": self.identifier,
            "complete": True,
            "runtime_s": time.perf_counter() - t0,
            "timings": list(self._timings),
        }
        self.output().write(status)
        self.log(f"done {self.identifier} in {status['runtime_s']:.2f}s")

    def run_impl(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class BlockTask(Task):
    """A block-parallel task over a volume decomposition.

    Subclasses implement ``get_shape()`` and ``process_block(block_id,
    blocking, config)``; optionally the split batch protocol ``read_batch``
    → ``compute_batch`` → ``write_batch`` that the ``cuda`` executor
    pipelines, and ``prepare`` / ``finalize`` host hooks.

    A split-protocol task may also run as a member of a fused chain
    (``runtime/stream.py``): ``fusable = True`` and the ``fusion_*``
    contract below, whose defaults read the task's inputs block-wise with
    no halo and carry nothing."""

    allow_retry: bool = True

    # -- stream fusion contract ------------------------------------------------

    fusable: bool = False

    def fusion_halo(self, config) -> Optional[Sequence[int]]:
        """The halo of this task's per-block reads (None: none).  The chain
        reads each block once at the largest halo of its members and serves
        smaller reads as crops."""
        return None

    def fusion_inputs(self, config) -> List[tuple]:
        """``(path, key)`` datasets read per block: the chain's shared-read
        set, and how the planner finds producer → consumer edges."""
        return []

    def fused_read_batch(self, handoffs, block_ids, blocking, config):
        """This member's compute payload from the upstream handoffs
        (``handoffs[(path, key)]`` is the producer's).  A member that
        consumes an in-chain product must override it: the product may be
        elided and never exist in the store."""
        raise NotImplementedError(
            f"{self.identifier} consumes an in-chain product but does not "
            "implement fused_read_batch"
        )

    def fused_compute_batch(self, payload, blocking, config, elided=False):
        """``(result for write_batch, handoff)``; by default the task's own
        ``compute_batch``, its result also the handoff.  An override may
        keep the handoff on the device and skip the host copy when
        ``elided``."""
        result = self.compute_batch(payload, blocking, config)
        return result, result

    def fused_elided_nbytes(self, handoff, blocking, config) -> int:
        """Store bytes an elided output would have written
        (``stream.elided_bytes``)."""
        return 0

    # carried merge state: updated on the compute thread in batch order,
    # after the whole batch computed (a retried batch never half-applies),
    # finalized once after the pass

    def fusion_carry_init(self, blocking, config):
        return None

    def fusion_carry_update(self, carry, result, block_ids, blocking, config):
        return carry

    def fusion_carry_nbytes(self, carry) -> int:
        return 0

    def fusion_finalize(self, carry, blocking, config) -> None:
        """Write the deferred small state that makes the chain's
        ``covers`` outputs."""
        return None

    def get_shape(self) -> Sequence[int]:  # pragma: no cover - abstract
        raise NotImplementedError

    def process_block(self, block_id: int, blocking: Blocking, config: Dict[str, Any]):
        raise NotImplementedError  # pragma: no cover - abstract

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        pass

    def finalize(self, blocking: Blocking, config: Dict[str, Any], block_ids: List[int]) -> None:
        pass

    def get_block_shape(self, gconf: Dict[str, Any]) -> List[int]:
        """The task's block shape: the global one, or a multiple of it (the
        scale pyramid of the graph and multicut tasks)."""
        return list(gconf["block_shape"])

    def get_block_list(self, blocking: Blocking, gconf: Dict[str, Any]) -> List[int]:
        return blocks_in_volume(
            blocking.shape, blocking.block_shape, gconf.get("roi_begin"),
            gconf.get("roi_end"), gconf.get("block_list_path"),
        )

    def run(self) -> None:
        from .device import resolve_device
        from .executor import get_executor

        t_start = time.perf_counter()
        gconf = self.global_config()
        config = hdf5_single_thread(self, {**gconf, **self.get_task_config()})
        resolve_device(config)  # no card where one is asked for: raise here
        blocking = Blocking(tuple(self.get_shape()), self.get_block_shape(gconf))
        block_ids = self.get_block_list(blocking, gconf)
        target = self.output()
        status = target.read()
        done = set(status.get("done", []))
        todo = [b for b in block_ids if b not in done]
        self.log(f"start {self.identifier}: {len(todo)}/{len(block_ids)} blocks to process")
        self.prepare(blocking, config)
        executor = get_executor(config["target"], config)
        runtimes: List[float] = list(status.get("block_runtimes", []))
        max_retries = int(config.get("max_num_retries", 0))
        failure_fraction = float(config.get("retry_failure_fraction", 0.5))
        attempt = 0
        while todo:
            t0 = time.perf_counter()
            newly_done, failed, errors = executor.run_blocks(self, blocking, todo, config)
            runtimes.append(time.perf_counter() - t0)
            done.update(newly_done)
            self._write_status(target, block_ids, done, failed, runtimes, False)
            for bid, err in errors.items():
                self.log(f"block {bid} failed: {err}")
            if not failed:
                break
            if attempt >= max_retries:
                raise FailedBlocksError(
                    f"{self.identifier}: {len(failed)} blocks failed after "
                    f"{attempt + 1} attempts; see {self.log_path}"
                )
            if not self.allow_retry:
                raise FailedBlocksError(
                    f"{self.identifier}: {len(failed)} blocks failed and task "
                    "does not allow retry"
                )
            if len(failed) / max(len(block_ids), 1) >= failure_fraction:
                raise FailedBlocksError(
                    f"{self.identifier}: {len(failed)}/{len(block_ids)} blocks failed "
                    f"(≥{failure_fraction:.0%}) — refusing retry"
                )
            attempt += 1
            self.log(f"retry {attempt}/{max_retries}: {len(failed)} failed blocks")
            todo = failed
        self.finalize(blocking, config, block_ids)
        self._write_status(target, block_ids, done, [], runtimes, True)
        self.log(f"done {self.identifier} in {time.perf_counter() - t_start:.2f}s")

    def _write_status(self, target, block_ids, done, failed, runtimes, complete):
        target.write({
            "task": self.identifier,
            "n_blocks": len(block_ids),
            "done": sorted(int(b) for b in done),
            "failed": sorted(int(b) for b in failed),
            "block_runtimes": [float(r) for r in runtimes],
            "timings": list(self._timings),
            "blocks_done": bool(complete),
            "complete": bool(complete),
        })
