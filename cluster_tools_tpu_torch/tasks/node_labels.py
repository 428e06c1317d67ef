"""Node ↔ label overlap votes (port of ``cluster_tools_tpu/tasks/node_labels.py``,
host numpy as there).

Reference node_labels/{block_node_labels,merge_node_labels}.py via
nifty.distributed overlaps (SURVEY.md §2.4): per-block sparse contingency
between a segmentation ("nodes") and a label volume, merged globally; the
merged table yields the max-overlap label per node (used to transfer ground
truth / semantic labels onto segments).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.evaluation import merge_contingency_tables
from ..ops.segment import contingency_table
from ..utils import store as store_mod
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

OVERLAPS_KEY = "node_labels/overlaps"
NODE_LABELS_NAME = "node_labels.npy"
OVERLAPS_MERGED_NAME = "node_overlaps.npz"


class BlockNodeLabelsTask(VolumeTask):
    """Per-block overlap serialization (reference block_node_labels.py:27).

    ``input_path/key`` = segmentation (nodes); ``labels_path/key`` = the label
    volume to vote over.
    """

    task_name = "block_node_labels"
    output_dtype = None

    def __init__(self, *args, labels_path: str = None, labels_key: str = None,
                 ignore_label=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.ignore_label = ignore_label

    def process_block(self, block_id: int, blocking: Blocking, config):
        bb = blocking.block(block_id).slicing
        seg = self.input_ds()[bb]
        labels = store_mod.file_reader(self.labels_path, "r")[self.labels_key][bb]
        ia, ib, counts = contingency_table(seg, labels)
        if self.ignore_label is not None:
            keep = ib != self.ignore_label
            ia, ib, counts = ia[keep], ib[keep], counts[keep]
        out = self.tmp_ragged(OVERLAPS_KEY, blocking.n_blocks, np.int64)
        packed = np.stack(
            [ia.astype(np.int64), ib.astype(np.int64), counts.astype(np.int64)],
            axis=1,
        )
        out.write_chunk((block_id,), packed.reshape(-1))


class MergeNodeLabelsTask(VolumeSimpleTask):
    """Merge overlaps by summation, emit max-overlap assignment
    (reference merge_node_labels.py:24)."""

    task_name = "merge_node_labels"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 max_overlap: bool = True, **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         max_overlap=max_overlap, **kwargs)

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        ds = self.tmp_store()[OVERLAPS_KEY]
        tables = []
        for chunk in read_ragged_chunks(ds, n_blocks, merge_threads(self)):
            if chunk is None or chunk.size == 0:
                continue
            t = chunk.reshape(-1, 3)
            tables.append((t[:, 0], t[:, 1], t[:, 2]))
        if not tables:
            # downstream (measures) loads the merged table unconditionally —
            # write empty arrays rather than leaving the file missing
            empty = np.zeros(0, dtype=np.int64)
            np.savez(
                os.path.join(self.tmp_folder, OVERLAPS_MERGED_NAME),
                ids_a=empty, ids_b=empty, counts=empty,
            )
            np.save(os.path.join(self.tmp_folder, NODE_LABELS_NAME),
                    np.zeros((0, 2), dtype=np.uint64))
            return
        ia, ib, counts = merge_contingency_tables(tables)
        np.savez(
            os.path.join(self.tmp_folder, OVERLAPS_MERGED_NAME),
            ids_a=ia, ids_b=ib, counts=counts,
        )
        if self.max_overlap:
            order = np.lexsort((counts, ia))
            ia_s, ib_s, c_s = ia[order], ib[order], counts[order]
            last = np.concatenate([ia_s[1:] != ia_s[:-1], [True]])
            table = np.stack(
                [ia_s[last].astype(np.uint64), ib_s[last].astype(np.uint64)],
                axis=1,
            )
            np.save(os.path.join(self.tmp_folder, NODE_LABELS_NAME), table)
        self.log(f"merged node overlaps: {ia.size} pairs")
