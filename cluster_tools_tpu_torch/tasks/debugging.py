"""Sanity-check tasks (port of ``cluster_tools_tpu/tasks/debugging.py``,
host numpy as there; reference debugging/ package), wired into
ProblemWorkflow behind the ``sanity_checks`` flag in the reference
(workflows.py:61-72).

* ``CheckSubGraphsTask`` — per block, the serialized subgraph node list must
  equal a fresh recompute from the watershed volume
  (reference check_sub_graphs.py:21,80-105).
* ``CheckComponentsTask`` — find labels spanning more blocks than physically
  plausible (fragmentation / id-collision smell,
  reference check_components.py:24,95-145).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..utils.blocking import Blocking
from .base import VolumeTask
from .graph import SUB_NODES_KEY, read_block_with_upper_halo

VIOLATING_IDS_NAME = "check_components_violating_ids.npy"
FAILED_SUBGRAPH_BLOCKS_NAME = "check_sub_graphs_failed_blocks.npy"


class CheckSubGraphsTask(VolumeTask):
    """input = the watershed volume the graph was extracted from."""

    task_name = "check_sub_graphs"
    output_dtype = None

    def run(self) -> None:
        # a check must recompute every block on re-run: a cached failing
        # verdict (per-block done list persisted before finalize raised)
        # would survive a data fix and keep failing forever
        target = self.output()
        status = target.read()
        if status and not status.get("complete", False):
            status["done"] = []
            target.write(status)
        super().run()

    def process_block(self, block_id: int, blocking: Blocking, config):
        seg = read_block_with_upper_halo(
            self.input_ds(), blocking, block_id
        ).astype(np.uint64)
        want = np.unique(seg)
        want = want[want > 0]
        stored = self.tmp_store()[SUB_NODES_KEY].read_chunk((block_id,))
        stored = (
            np.zeros(0, dtype=np.uint64) if stored is None else stored
        )
        ok = stored.size == want.size and np.array_equal(stored, want)
        marks = self.tmp_ragged(
            "debugging/subgraph_ok", blocking.n_blocks, np.int64
        )
        marks.write_chunk((block_id,), np.asarray([int(ok)], dtype=np.int64))

    def finalize(self, blocking, config, block_ids: List[int]) -> None:
        marks = self.tmp_store()["debugging/subgraph_ok"]
        failed = [
            bid
            for bid in block_ids
            if (m := marks.read_chunk((bid,))) is not None and m[0] == 0
        ]
        np.save(
            os.path.join(self.tmp_folder, FAILED_SUBGRAPH_BLOCKS_NAME),
            np.asarray(failed, dtype=np.int64),
        )
        if failed:
            raise RuntimeError(
                f"sub-graph serialization mismatch in blocks {failed[:10]}"
                f"{'...' if len(failed) > 10 else ''}"
            )
        self.log(f"all {len(block_ids)} block sub-graphs verified")


class CheckComponentsTask(VolumeTask):
    """Labels spanning more than ``max_blocks_per_label`` blocks are
    fragmentation suspects (the reference flags labels in more chunks than a
    block contains, check_components.py:95-145).  Block-parallel: per-block
    uniques go to a ragged scratch dataset, the count reduction runs in
    ``finalize``."""

    task_name = "check_components"
    output_dtype = None

    def __init__(self, *args, max_blocks_per_label: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_blocks_per_label = max_blocks_per_label

    def process_block(self, block_id: int, blocking: Blocking, config):
        labels = np.unique(
            np.asarray(self.input_ds()[blocking.block(block_id).slicing])
        )
        out = self.tmp_ragged(
            "debugging/block_uniques", blocking.n_blocks, np.uint64
        )
        out.write_chunk((block_id,), labels[labels > 0].astype(np.uint64))

    def finalize(self, blocking, config, block_ids: List[int]) -> None:
        ds = self.tmp_store()["debugging/block_uniques"]
        chunks = []
        for bid in block_ids:
            labels = ds.read_chunk((bid,))
            if labels is not None and labels.size:
                chunks.append(labels)
        if chunks:
            all_labels = np.concatenate(chunks)
            ids, counts = np.unique(all_labels, return_counts=True)
            mask = counts > self.max_blocks_per_label
            violating = np.stack(
                [ids[mask].astype(np.int64), counts[mask].astype(np.int64)],
                axis=1,
            )
        else:
            violating = np.zeros((0, 2), dtype=np.int64)
        np.save(os.path.join(self.tmp_folder, VIOLATING_IDS_NAME), violating)
        self.log(
            f"{violating.shape[0]} labels span more than "
            f"{self.max_blocks_per_label} blocks"
        )
