"""Paintera container conversion (port of ``cluster_tools_tpu/tasks/paintera.py``,
host numpy as there; reference paintera/ package).

* ``UniqueBlockLabelsTask`` — per block, the sorted unique label ids as a
  varlen chunk (reference unique_block_labels.py:26; paintera's
  ``unique-labels`` aux dataset).
* ``LabelBlockMappingTask`` — the inverse lookup: for each label id, the list
  of block ids containing it, serialized over id-range chunks
  (reference label_block_mapping.py:19 via ``ndist.serializeBlockMapping``;
  record layout per id: [id, n_blocks, block ids...]).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask


class UniqueBlockLabelsTask(VolumeTask):
    """Sorted unique ids per block; reads either a plain label volume or a
    label-multiset dataset (any pyramid level), like the reference's
    LabelMultisetWrapper path (unique_block_labels.py:26)."""

    task_name = "unique_block_labels"

    def __init__(self, *args, prefix: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.prefix = prefix

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}" if self.prefix else self.task_name

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        f = store.file_reader(self.output_path, "a")
        f.require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype="uint64",
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        in_ds = self.input_ds()
        if in_ds.attrs.get("isLabelMultiset", False):
            from ..ops.label_multiset import deserialize_multiset

            grid_pos = tuple(
                b // c for b, c in zip(block.begin, in_ds.chunks)
            )
            payload = in_ds.read_chunk_varlen(grid_pos)
            if payload is None:
                uniques = np.zeros(1, dtype=np.uint64)  # background only
            else:
                c_shape = tuple(
                    min((g + 1) * c, s) - g * c
                    for g, c, s in zip(grid_pos, in_ds.chunks, in_ds.shape)
                )
                uniques = np.unique(
                    deserialize_multiset(payload, c_shape).ids
                )
        else:
            uniques = np.unique(np.asarray(in_ds[block.slicing]))
        out_ds = self.output_ds()
        grid_pos = tuple(b // c for b, c in zip(block.begin, out_ds.chunks))
        out_ds.write_chunk_varlen(grid_pos, uniques.astype(np.uint64))


class LabelBlockMappingTask(VolumeSimpleTask):
    """Invert the per-block uniques into per-label block lists."""

    task_name = "label_block_mapping"
    # constructed with input_path/input_key (the uniques dataset),
    # output_path/output_key, and optional number_of_labels/prefix — all
    # stored by VolumeSimpleTask's **params

    number_of_labels = None
    prefix = ""

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}" if self.prefix else self.task_name

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"id_chunk_size": 2000})
        return conf

    def run_impl(self) -> None:
        conf = self.get_task_config()
        uniques_ds = store.file_reader(self.input_path, "r")[self.input_key]
        grid = uniques_ds.chunk_grid
        n_blocks = int(np.prod(grid))

        by_label: Dict[int, List[int]] = {}
        for block_id in range(n_blocks):
            gp = np.unravel_index(block_id, grid)
            uniques = uniques_ds.read_chunk_varlen(tuple(gp))
            if uniques is None:
                continue
            for label in uniques:
                by_label.setdefault(int(label), []).append(block_id)

        n_labels = self.number_of_labels or (
            (max(by_label) + 1) if by_label else 1
        )
        chunk_size = int(conf.get("id_chunk_size", 2000))
        f = store.file_reader(self.output_path, "a")
        out = f.require_dataset(
            self.output_key,
            shape=(n_labels,),
            dtype="uint64",
            chunks=(chunk_size,),
            compression="gzip",
        )
        for chunk_start in range(0, n_labels, chunk_size):
            record = []
            found = False
            for label in range(chunk_start, min(chunk_start + chunk_size, n_labels)):
                blocks = by_label.get(label)
                if blocks:
                    found = True
                    record.extend([label, len(blocks), *blocks])
            if found:
                out.write_chunk_varlen(
                    (chunk_start // chunk_size,),
                    np.asarray(record, dtype=np.uint64),
                )
        self.log(
            f"serialized block mapping for {len(by_label)} labels over "
            f"{n_blocks} blocks"
        )


def read_label_block_mapping(path: str, key: str) -> Dict[int, List[int]]:
    """{label id: [block ids]} from the serialized mapping."""
    ds = store.file_reader(path, "r")[key]
    out: Dict[int, List[int]] = {}
    for cid in range(ds.chunk_grid[0]):
        record = ds.read_chunk_varlen((cid,))
        if record is None:
            continue
        pos = 0
        while pos < record.size:
            label = int(record[pos])
            n = int(record[pos + 1])
            out[label] = [int(b) for b in record[pos + 2 : pos + 2 + n]]
            pos += 2 + n
    return out
