"""Relabelling tasks: make block-offset labels consecutive (port of
``cluster_tools_tpu/tasks/relabel.py``): per-block uniques → merged sparse
id set → (old → consecutive new) assignment table → applied by the write
task.  Host numpy, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

UNIQUES_KEY = "relabel/uniques"
LABELING_NAME = "relabel_assignments.npy"


class FindUniquesTask(VolumeTask):
    """Per-block unique labels → ragged scratch (reference find_uniques.py:26)."""

    task_name = "find_uniques"
    output_dtype = None

    def process_block(self, block_id: int, blocking: Blocking, config):
        ds = self.input_ds()
        bb = blocking.block(block_id).slicing
        uniques = np.unique(ds[bb])
        store = self.tmp_ragged(UNIQUES_KEY, blocking.n_blocks, np.uint64)
        store.write_chunk((block_id,), uniques.astype(np.uint64))


class MergeUniquesTask(VolumeSimpleTask):
    """Merge the per-block uniques into a sorted unique-id dataset at
    ``output_path/output_key`` (reference relabel/merge_uniques.py:24,84-120).

    Unlike ``FindLabelingTask`` (which turns the merged set into a
    consecutive assignment table for relabeling), this materializes the raw
    sparse id set — the reference's standalone ``UniqueWorkflow`` output.
    Ragged chunk reads fan out over ``threads_per_job``.
    """

    task_name = "merge_uniques"

    def run_impl(self) -> None:
        from ..utils import store

        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        uniques_ds = self.tmp_store()[UNIQUES_KEY]
        chunks = read_ragged_chunks(uniques_ds, n_blocks, merge_threads(self))
        collected = [c for c in chunks if c is not None and c.size]
        uniques = (
            np.unique(np.concatenate(collected))
            if collected
            else np.array([], dtype=np.uint64)
        )
        f = store.file_reader(self.output_path, "a")
        f.create_dataset(
            self.output_key,
            data=uniques.astype(np.uint64),
            chunks=(max(min(int(1e6), uniques.size), 1),),
            compression="gzip",
        )
        self.log(f"{uniques.size} unique ids -> {self.output_path}/{self.output_key}")


class FindLabelingTask(VolumeSimpleTask):
    """Merge uniques → dense consecutive assignment table
    (reference find_labeling.py:100-125)."""

    task_name = "find_labeling"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         **kwargs)

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        uniques_ds = self.tmp_store()[UNIQUES_KEY]
        chunks = read_ragged_chunks(uniques_ds, n_blocks, merge_threads(self))
        collected = [c for c in chunks if c is not None and c.size]
        uniques = (
            np.unique(np.concatenate(collected))
            if collected
            else np.array([], dtype=np.uint64)
        )
        nonzero = uniques[uniques > 0]
        new_ids = np.arange(1, nonzero.size + 1, dtype=np.uint64)
        table = np.stack([nonzero, new_ids], axis=1) if nonzero.size else np.zeros(
            (0, 2), dtype=np.uint64
        )
        np.save(os.path.join(self.tmp_folder, LABELING_NAME), table)
        self.log(f"relabeling {nonzero.size} ids to consecutive")
