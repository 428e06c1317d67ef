"""Shared plumbing for volume-to-volume block tasks and single-shot
reductions (port of ``cluster_tools_tpu/tasks/base.py``: ``VolumeTask``,
``VolumeSimpleTask`` and the ragged-chunk helpers)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

from ..runtime import config as cfg
from ..runtime.task import BlockTask, SimpleTask
from ..utils import store
from ..utils.blocking import Blocking

SCRATCH_STORE_NAME = "data.zarr"
# the JAX package's DEFAULT_TASK_CONFIG defaults of the two thread knobs
DEFAULT_THREADS_PER_JOB = 1
DEFAULT_READ_THREADS = 4


def fusion_wrap(ds, path: str, key: str):
    """``ds`` behind the fused chain's per-batch read cache when one is
    active on this thread (``parallel/dispatch.py``), else ``ds``."""
    from ..parallel.dispatch import wrap_with_read_cache

    return wrap_with_read_cache(ds, path, key)


def scratch_store_path(tmp_folder: str) -> str:
    """The shared per-tmp-folder scratch store."""
    return os.path.join(tmp_folder, SCRATCH_STORE_NAME)


class VolumeTask(BlockTask):
    """A block task reading ``input_path/input_key`` and writing
    ``output_path/output_key``; the blocking follows the input's last
    ``space_ndim`` axes."""

    output_dtype = None  # subclasses set it to create the output dataset
    space_ndim = 3

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        dependencies: Sequence = (),
        input_path: str = None,
        input_key: str = None,
        output_path: Optional[str] = None,
        output_key: Optional[str] = None,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key

    def input_ds(self, mode: str = "r"):
        """The input dataset; inside a fused chain's read stage it reads
        through the batch's shared read (``parallel/dispatch.py``)."""
        return fusion_wrap(store.file_reader(self.input_path, mode)[self.input_key],
                           self.input_path, self.input_key)

    def output_ds(self, mode: str = "a"):
        return store.file_reader(self.output_path, mode)[self.output_key]

    def get_shape(self) -> Sequence[int]:
        shape = self.input_ds().shape
        return shape[-self.space_ndim:] if len(shape) > self.space_ndim else shape

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        """Create the output dataset: block-shaped chunks, gzip (the
        reference's default codec, readable by vanilla n5 readers)."""
        if self.output_path is None or self.output_dtype is None:
            return
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype=self.output_dtype,
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )

    def fusion_inputs(self, config):
        """The datasets read per block, the fused chain's shared-read set:
        the input and the optional mask."""
        pairs = [(self.input_path, self.input_key)]
        mask_path = getattr(self, "mask_path", None)
        if mask_path:
            pairs.append((mask_path, getattr(self, "mask_key", None)))
        return pairs

    @property
    def tmp_store_path(self) -> str:
        return scratch_store_path(self.tmp_folder)

    def tmp_store(self):
        return store.file_reader(self.tmp_store_path, "a")

    def tmp_ragged(self, key: str, grid_size: int, dtype):
        return self.tmp_store().create_ragged_dataset(key, (grid_size,), dtype)


def read_ragged_chunks(ds, n_blocks: int, n_threads: int = 1) -> list:
    """All per-block ragged chunks, read over a thread pool when
    ``n_threads > 1``; a list indexed by block id, ``None`` where a chunk is
    absent."""
    from concurrent.futures import ThreadPoolExecutor

    if n_threads <= 1:
        return [ds.read_chunk((bid,)) for bid in range(n_blocks)]
    with ThreadPoolExecutor(n_threads) as pool:
        return list(pool.map(lambda bid: ds.read_chunk((bid,)), range(n_blocks)))


def _chunk_aligned(ds, bh) -> bool:
    """The block's inner box covers whole chunks of ``ds`` (in its trailing,
    spatial axes), so writes of distinct blocks never share a chunk."""
    n = len(bh.inner.begin)
    for b, e, c, s in zip(bh.inner.begin, bh.inner.end, ds.chunks[-n:], ds.shape[-n:]):
        if b % c or (e % c and e != s):
            return False
    return True


def write_inner_blocks(ds, blocks, results, dtype, n_threads: int = 1) -> None:
    """Write each block's inner box of ``results`` (one array per block, at
    the block shape) as ``dtype``, over threads where every block covers
    whole chunks of ``ds``."""
    from concurrent.futures import ThreadPoolExecutor

    def _write(i):
        ds[blocks[i].inner.slicing] = results[i][blocks[i].inner_local.slicing].astype(dtype)

    n = min(n_threads, len(blocks))
    if n > 1 and all(_chunk_aligned(ds, bh) for bh in blocks):
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(_write, range(len(blocks))))
    else:
        for i in range(len(blocks)):
            _write(i)


def merge_threads(task) -> int:
    """The ``threads_per_job`` knob of a merge task's config."""
    return max(int(task.get_task_config().get("threads_per_job", DEFAULT_THREADS_PER_JOB)), 1)


def read_threads(config) -> int:
    """The ``read_threads`` knob (chunk-read fan-out of a block batch)."""
    return max(int(config.get("read_threads", DEFAULT_READ_THREADS)), 1)


def resolve_n_blocks(config_dir, path: str, key: str, scale: int = 0) -> int:
    """Block count of a dataset under the global block shape times
    ``2**scale``, at run time (the dataset may not exist when the DAG is
    built); leading channel axes are dropped, as ``VolumeTask.get_shape``
    does."""
    shape = store.file_reader(path, "r")[key].shape[-3:]
    block_shape = [bs * 2**scale for bs in cfg.global_config(config_dir)["block_shape"]]
    return Blocking(shape, block_shape).n_blocks


class VolumeSimpleTask(SimpleTask):
    """Single-shot reduction task with access to the shared scratch store;
    keyword parameters become attributes."""

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        dependencies: Sequence = (),
        **params,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        for k, v in params.items():
            setattr(self, k, v)

    @property
    def tmp_store_path(self) -> str:
        return scratch_store_path(self.tmp_folder)

    def tmp_store(self):
        return store.file_reader(self.tmp_store_path, "a")
