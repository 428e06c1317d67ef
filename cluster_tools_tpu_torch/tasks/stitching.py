"""Stitching of block-wise segmentations by face overlaps (port of the
mutual-max part of ``cluster_tools_tpu/tasks/stitching.py``).

Each block saves its labelling of its halo'd outer region
(``save_block_overlap``).  For the face between blocks A and B, A's and B's
labellings of the shared overlap are contingency-matched: a pair merges iff
each segment is the other's maximal overlap partner, both lie on the
boundary plane, and the mean normalised overlap exceeds
``overlap_threshold``.  ``StitchAssignmentsTask`` joins the votes by
union-find into an (id, merged id) table that ``WriteTask`` applies with
``table_default="identity"``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

import numpy as np

from ..ops.segment import contingency_table
from ..ops.unionfind import merge_assignments_np
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

STITCH_PAIRS_KEY = "stitching/face_pairs"
STITCH_ASSIGNMENTS_NAME = "stitch_assignments.npy"


def overlap_dir(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, "stitch_overlaps")


def save_block_overlap(tmp_folder: str, block_id: int, outer_begin, outer_end,
                       seg: np.ndarray) -> None:
    """Save a block's labelling of its outer (halo'd) region for stitching;
    written to a file of this process and thread, then moved into place."""
    d = overlap_dir(tmp_folder)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"block_{block_id}.npz")
    tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}.npz"
    np.savez_compressed(tmp, begin=np.asarray(outer_begin), end=np.asarray(outer_end), seg=seg)
    os.replace(tmp, path)


def load_block_overlap(tmp_folder: str, block_id: int):
    """(outer begin, outer end, labels) of a block, or None if absent."""
    path = os.path.join(overlap_dir(tmp_folder), f"block_{block_id}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        return f["begin"], f["end"], f["seg"]


def _mutual_max_pairs(seg_a, seg_b, boundary_a, boundary_b, threshold):
    """Mutual-max votes between two labelings of the same region."""
    both = (seg_a > 0) & (seg_b > 0)
    if not both.any():
        return []
    ua, ub, counts = contingency_table(seg_a[both].astype(np.int64), seg_b[both].astype(np.int64))
    c = counts.astype(np.float64)
    uniq_a, inv_a = np.unique(ua, return_inverse=True)
    uniq_b, inv_b = np.unique(ub, return_inverse=True)
    size_a = dict(zip(uniq_a.tolist(), np.bincount(inv_a, weights=c)))
    size_b = dict(zip(uniq_b.tolist(), np.bincount(inv_b, weights=c)))
    # best partner per side by count (the last of equal counts in the
    # table's order wins)
    order = np.argsort(c, kind="stable")
    best_ab, best_ba = {}, {}
    for x, y, n in zip(ua[order], ub[order], c[order]):
        best_ab[int(x)] = (int(y), n)
        best_ba[int(y)] = (int(x), n)
    on_a = set(int(s) for s in np.unique(boundary_a) if s != 0)
    on_b = set(int(s) for s in np.unique(boundary_b) if s != 0)
    votes = []
    for x, (y, n_xy) in best_ab.items():
        if x not in on_a or y not in on_b:
            continue
        back, n_yx = best_ba.get(y, (None, 0.0))
        if back != x:
            continue
        measure = 0.5 * (n_xy / size_a[x] + n_yx / size_b[y])
        if measure > threshold:
            votes.append((x, y))
    return votes


class StitchFacesTask(VolumeTask):
    """Per-face mutual-max-overlap merge votes: each block against its upper
    neighbour on every axis, written as a ragged chunk of id pairs."""

    task_name = "stitch_faces"
    output_dtype = None

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"overlap_threshold": 0.5})
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        threshold = float(config.get("overlap_threshold", 0.5))
        mine = load_block_overlap(self.tmp_folder, block_id)
        pairs = []
        if mine is not None:
            my_begin, my_end, my_seg = mine
            for axis in range(blocking.ndim):
                ngb_id = blocking.neighbor_id(block_id, axis, lower=False)
                if ngb_id is None:
                    continue
                theirs = load_block_overlap(self.tmp_folder, ngb_id)
                if theirs is None:
                    continue
                nb_begin, nb_end, nb_seg = theirs
                # the intersection of the two outer regions
                lo = np.maximum(my_begin, nb_begin)
                hi = np.minimum(my_end, nb_end)
                if (lo >= hi).any():
                    continue
                sl_a = tuple(slice(lo_ - b, hi_ - b) for lo_, hi_, b in zip(lo, hi, my_begin))
                sl_b = tuple(slice(lo_ - b, hi_ - b) for lo_, hi_, b in zip(lo, hi, nb_begin))
                ov_a = my_seg[sl_a]
                ov_b = nb_seg[sl_b]
                # the boundary plane between the two inner regions, in
                # overlap coordinates
                plane = blocking.block(block_id).end[axis] - int(lo[axis])
                plane_sl = [slice(None)] * blocking.ndim
                plane_sl[axis] = slice(max(plane - 1, 0), plane + 1)
                plane_sl = tuple(plane_sl)
                pairs.extend(_mutual_max_pairs(ov_a, ov_b, ov_a[plane_sl], ov_b[plane_sl], threshold))
        out = self.tmp_ragged(STITCH_PAIRS_KEY, blocking.n_blocks, np.int64)
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1) if pairs else np.array([], dtype=np.int64)
        out.write_chunk((block_id,), arr)


class StitchAssignmentsTask(VolumeSimpleTask):
    """Union-find over the stitch votes → an (id, smallest id of its merged
    group) table of the voted ids."""

    task_name = "stitch_assignments"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        ds = self.tmp_store()[STITCH_PAIRS_KEY]
        chunks = read_ragged_chunks(ds, n_blocks, merge_threads(self))
        pairs = [c.reshape(-1, 2) for c in chunks if c is not None and c.size]
        all_pairs = np.concatenate(pairs, axis=0) if pairs else np.zeros((0, 2), np.int64)
        # ids are sparse (block offsets): compact them for the union-find.
        # Ids in no vote pass through the write (table_default="identity")
        ids = np.unique(all_pairs.reshape(-1)) if all_pairs.size else np.array([], np.int64)
        path = os.path.join(self.tmp_folder, STITCH_ASSIGNMENTS_NAME)
        if ids.size == 0:
            np.save(path, np.zeros((0, 2), dtype=np.uint64))
            return
        dense = np.searchsorted(ids, all_pairs)
        assignment, _ = merge_assignments_np(ids.size + 1, dense + 1)
        group_min = np.full(int(assignment.max()) + 1, np.iinfo(np.int64).max)
        np.minimum.at(group_min, assignment[1:], ids)
        table = np.stack(
            [ids.astype(np.uint64), group_min[assignment[1:]].astype(np.uint64)], axis=1,
        )
        np.save(path, table)
        self.log(f"stitching merged {ids.size} voted ids")
