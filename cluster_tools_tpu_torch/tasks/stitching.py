"""Stitching of block-wise segmentations (port of
``cluster_tools_tpu/tasks/stitching.py``), by face overlaps or over the
region graph.

Each block saves its labelling of its halo'd outer region
(``save_block_overlap``).  For the face between blocks A and B, A's and B's
labellings of the shared overlap are contingency-matched: a pair merges iff
each segment is the other's maximal overlap partner, both lie on the
boundary plane, and the mean normalised overlap exceeds
``overlap_threshold``.  ``StitchAssignmentsTask`` joins the votes by
union-find into an (id, merged id) table that ``WriteTask`` applies with
``table_default="identity"``.

Over the graph, ``SimpleStitchEdgesTask`` marks the edges whose endpoints
touch across a block face; ``SimpleStitchAssignmentsTask`` merges all of
them (above an edge-size threshold) and ``StitchingMulticutTask`` solves a
multicut with one beta for them and another for the inner edges.
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


BOUNDARY_EDGES_KEY = "stitching/boundary_edges"
SIMPLE_STITCH_NAME = "simple_stitch_assignments.npy"
STITCH_MC_NAME = "stitching_multicut_assignments.npy"


class SimpleStitchEdgesTask(VolumeTask):
    """Mark graph edges whose endpoints touch across a block boundary
    (reference simple_stitch_edges.py:23 via ndist.findBlockBoundaryEdges).

    ``input_path/key`` is the (block-offset) label volume the graph was
    extracted from; per block, every touching label pair on a lower face is
    looked up in the global edge list and its dense edge id recorded."""

    task_name = "simple_stitch_edges"
    output_dtype = None
    _graph_cache = None

    def _graph(self):
        if self._graph_cache is None:  # once per task, not once per block
            from .graph import load_graph

            self._graph_cache = load_graph(self.tmp_store())
        return self._graph_cache

    def process_block(self, block_id: int, blocking: Blocking, config):
        nodes, edges = self._graph()
        labels_ds = self.input_ds()
        pairs = []
        for axis, ngb_id, face in blocking.iterate_faces(block_id, halo=1):
            slab = np.asarray(labels_ds[face.slicing])
            lo, hi = np.split(slab, 2, axis=axis)
            both = (lo > 0) & (hi > 0) & (lo != hi)
            if not both.any():
                continue
            a = lo[both]
            b = hi[both]
            pairs.append(np.unique(np.stack([a, b], axis=1), axis=0))
        out = self.tmp_ragged(BOUNDARY_EDGES_KEY, blocking.n_blocks, np.int64)
        if not pairs:
            out.write_chunk((block_id,), np.zeros(0, dtype=np.int64))
            return
        uv = np.unique(np.concatenate(pairs, axis=0), axis=0)
        # labels → dense node ids → edge ids (edges are sorted lex)
        du = np.searchsorted(nodes, uv[:, 0])
        dv = np.searchsorted(nodes, uv[:, 1])
        ok = (du < nodes.size) & (dv < nodes.size)
        ok &= nodes[np.clip(du, 0, nodes.size - 1)] == uv[:, 0]
        ok &= nodes[np.clip(dv, 0, nodes.size - 1)] == uv[:, 1]
        duv = np.stack([du[ok], dv[ok]], axis=1)
        duv.sort(axis=1)
        # lookup in the sorted edge table
        edge_keys = edges[:, 0] * (edges.max() + 1) + edges[:, 1]
        q = duv[:, 0] * (edges.max() + 1) + duv[:, 1]
        pos = np.searchsorted(edge_keys, q)
        found = pos < edge_keys.size
        found &= edge_keys[np.clip(pos, 0, edge_keys.size - 1)] == q
        out.write_chunk((block_id,), pos[found].astype(np.int64))


class SimpleStitchAssignmentsTask(VolumeSimpleTask):
    """Merge every block-boundary edge above the edge-size threshold
    (reference simple_stitch_assignments.py:24)."""

    task_name = "simple_stitch_assignments"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 edge_size_threshold: int = 0, **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         edge_size_threshold=edge_size_threshold, **kwargs)

    def run_impl(self) -> None:
        from ..ops.unionfind import UnionFindNp
        from .features import FEATURES_KEY
        from .graph import load_graph

        nodes, edges = load_graph(self.tmp_store())
        n_blocks = resolve_n_blocks(
            self.config_dir, self.input_path, self.input_key
        )
        ds = self.tmp_store()[BOUNDARY_EDGES_KEY]
        merge = np.zeros(edges.shape[0], dtype=bool)
        for chunk in read_ragged_chunks(ds, n_blocks, merge_threads(self)):
            if chunk is not None and chunk.size:
                merge[chunk] = True
        if self.edge_size_threshold > 0:
            if FEATURES_KEY not in self.tmp_store():
                raise ValueError(
                    "edge_size_threshold needs edge features — run "
                    "EdgeFeaturesWorkflow (or MulticutStitchingWorkflow) first"
                )
            sizes = self.tmp_store()[FEATURES_KEY][:, -1]
            if sizes.size != edges.shape[0]:
                raise ValueError(
                    f"stale edge features: {sizes.size} rows for "
                    f"{edges.shape[0]} edges"
                )
            merge &= sizes > self.edge_size_threshold
        uf = UnionFindNp(nodes.size)
        if merge.any():
            uf.merge(edges[merge, 0], edges[merge, 1])
        roots = uf.compress()
        _, comp = np.unique(roots, return_inverse=True)
        table = np.stack(
            [nodes, (comp + 1).astype(np.uint64)], axis=1
        ).astype(np.uint64)
        if nodes.size and nodes[0] == 0:
            table[0, 1] = 0
        np.save(os.path.join(self.tmp_folder, SIMPLE_STITCH_NAME), table)
        self.log(
            f"simple stitching merged {int(merge.sum())} boundary edges"
        )


class StitchingMulticutTask(VolumeSimpleTask):
    """Multicut with two betas: boundary (stitch) edges get ``beta1``, inner
    edges ``beta2`` (reference stitching_multicut.py:18,135-139)."""

    task_name = "stitching_multicut"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         **kwargs)

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"beta1": 0.5, "beta2": 0.75})
        return conf

    def run_impl(self) -> None:
        from ..ops.multicut import solve_multicut, transform_probabilities_to_costs
        from .features import FEATURES_KEY
        from .graph import load_graph
        from .multicut import write_assignment_table

        conf = self.get_task_config()
        nodes, edges = load_graph(self.tmp_store())
        feats = self.tmp_store()[FEATURES_KEY][:]
        n_blocks = resolve_n_blocks(
            self.config_dir, self.input_path, self.input_key
        )
        ds = self.tmp_store()[BOUNDARY_EDGES_KEY]
        stitch = np.zeros(edges.shape[0], dtype=bool)
        for chunk in read_ragged_chunks(ds, n_blocks, merge_threads(self)):
            if chunk is not None and chunk.size:
                stitch[chunk] = True

        probs, sizes = feats[:, 0], feats[:, -1]
        costs = np.zeros(edges.shape[0], dtype=np.float64)
        if stitch.any():
            costs[stitch] = transform_probabilities_to_costs(
                probs[stitch], beta=float(conf.get("beta1", 0.5)),
                edge_sizes=sizes[stitch],
            )
        if (~stitch).any():
            costs[~stitch] = transform_probabilities_to_costs(
                probs[~stitch], beta=float(conf.get("beta2", 0.75)),
                edge_sizes=sizes[~stitch],
            )
        result = solve_multicut(nodes.size, edges, costs)
        write_assignment_table(self, result, STITCH_MC_NAME)
        self.log(
            f"stitching multicut: {nodes.size} nodes → "
            f"{int(result.max()) + 1} segments "
            f"({int(stitch.sum())} stitch edges)"
        )
