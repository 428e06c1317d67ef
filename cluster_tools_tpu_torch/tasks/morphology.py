"""Per-segment morphology: sizes, centres of mass, bounding boxes (port of
``cluster_tools_tpu/tasks/morphology.py``, host numpy copied from it so that
the float64 sums round the same way).  Output table columns follow the
reference layout (block_morphology.py:128-134):

  [id, size, com_z, com_y, com_x, bb_begin_z, .., bb_end_z, .., bb_end_x]
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np

from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

MORPHOLOGY_KEY = "morphology/blocks"
MORPHOLOGY_NAME = "morphology.npy"
N_COLS = 11  # id, size, com*3, bb_begin*3, bb_end*3


def block_morphology(seg: np.ndarray, offset) -> np.ndarray:
    """Per-id partial morphology of one block (global coordinates)."""
    ids, inv = np.unique(seg, return_inverse=True)
    inv = inv.reshape(seg.shape)
    n = ids.size
    counts = np.bincount(inv.reshape(-1), minlength=n).astype(np.float64)
    out = np.zeros((n, N_COLS))
    out[:, 0] = ids
    out[:, 1] = counts
    coords = np.indices(seg.shape).reshape(3, -1)
    flat = inv.reshape(-1)
    for d in range(3):
        sums = np.bincount(flat, weights=coords[d], minlength=n)
        out[:, 2 + d] = sums / counts + offset[d]
        mins = np.full(n, np.inf)
        maxs = np.full(n, -np.inf)
        np.minimum.at(mins, flat, coords[d])
        np.maximum.at(maxs, flat, coords[d])
        out[:, 5 + d] = mins + offset[d]
        out[:, 8 + d] = maxs + offset[d] + 1
    return out


def merge_morphology(partials) -> np.ndarray:
    """Combine per-block partial tables: sizes sum, COM weighted, bbox min/max."""
    all_rows = np.concatenate(partials, axis=0)
    ids = np.unique(all_rows[:, 0])
    out = np.zeros((ids.size, N_COLS))
    out[:, 0] = ids
    idx = np.searchsorted(ids, all_rows[:, 0])
    np.add.at(out[:, 1], idx, all_rows[:, 1])
    for d in range(3):
        com_w = np.zeros(ids.size)
        np.add.at(com_w, idx, all_rows[:, 2 + d] * all_rows[:, 1])
        out[:, 2 + d] = com_w / out[:, 1]
        mins = np.full(ids.size, np.inf)
        maxs = np.full(ids.size, -np.inf)
        np.minimum.at(mins, idx, all_rows[:, 5 + d])
        np.maximum.at(maxs, idx, all_rows[:, 8 + d])
        out[:, 5 + d] = mins
        out[:, 8 + d] = maxs
    return out


def load_morphology(tmp_folder: str) -> np.ndarray:
    return np.load(os.path.join(tmp_folder, MORPHOLOGY_NAME))


class IdBlockTask(VolumeTask):
    """A block task over segment-id ranges instead of voxels."""

    id_chunk = 64
    _morpho_cache = None

    def get_shape(self) -> Sequence[int]:
        morpho = load_morphology(self.tmp_folder)
        max_id = int(morpho[:, 0].max()) if len(morpho) else 0
        return (max_id + 1, 1, 1)

    def get_block_shape(self, gconf) -> List[int]:
        return [self.id_chunk, 1, 1]

    def morphology_by_id(self) -> Dict[int, np.ndarray]:
        """Morphology rows keyed by id, loaded once per task instance (not
        once per block — that would be O(n_ids^2) over the id blocking)."""
        if self._morpho_cache is None:
            morpho = load_morphology(self.tmp_folder)
            self._morpho_cache = {int(r[0]): r for r in morpho}
        return self._morpho_cache


class RegionCentersTask(IdBlockTask):
    """Representative interior point per segment: the EDT-argmax of the
    object mask inside its morphology bounding box
    (reference morphology/region_centers.py:29,106-133).

    The id space is blocked (reference id_chunks=2000); each object is cropped
    by its bbox and its most interior voxel written to a (n_labels, 3) float32
    table.  The EDT runs on the host (scipy, C), as in the JAX package: the
    per-object crops are small and ragged.
    """

    task_name = "region_centers"
    id_chunk = 2000

    def __init__(self, *args, ignore_label=None, resolution=(1, 1, 1),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ignore_label = ignore_label
        self.resolution = list(resolution)

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        from ..utils import store

        n_labels = blocking.shape[0]
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=(n_labels, 3),
            dtype="float32",
            chunks=(min(self.id_chunk, n_labels), 3),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        from scipy.ndimage import distance_transform_edt

        block = blocking.block(block_id)
        label_begin, label_end = block.begin[0], block.end[0]
        by_id = self.morphology_by_id()
        seg_ds = self.input_ds()
        centers = np.zeros((label_end - label_begin, 3), dtype=np.float32)
        for label_id in range(label_begin, label_end):
            row = by_id.get(label_id)
            if row is None or label_id == self.ignore_label:
                continue
            bb = tuple(
                slice(int(b), int(e))
                for b, e in zip(row[5:8], row[8:11])
            )
            obj = seg_ds[bb] == label_id
            if not obj.any():
                continue
            dist = distance_transform_edt(obj, sampling=self.resolution)
            center = np.unravel_index(np.argmax(dist), obj.shape)
            centers[label_id - label_begin] = [
                c + b.start for c, b in zip(center, bb)
            ]
        self.output_ds()[label_begin:label_end] = centers


class BlockMorphologyTask(VolumeTask):
    task_name = "block_morphology"
    output_dtype = None

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        seg = self.input_ds()[block.slicing]
        table = block_morphology(seg, block.begin)
        out = self.tmp_ragged(MORPHOLOGY_KEY, blocking.n_blocks, np.float64)
        out.write_chunk((block_id,), table.reshape(-1))


class MergeMorphologyTask(VolumeSimpleTask):
    task_name = "merge_morphology"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        ds = self.tmp_store()[MORPHOLOGY_KEY]
        chunks = read_ragged_chunks(ds, n_blocks, merge_threads(self))
        partials = [
            c.reshape(-1, N_COLS) for c in chunks if c is not None and c.size
        ]
        table = (
            merge_morphology(partials)
            if partials
            else np.zeros((0, N_COLS))
        )
        np.save(os.path.join(self.tmp_folder, MORPHOLOGY_NAME), table)
        self.log(f"morphology for {table.shape[0]} segments")
