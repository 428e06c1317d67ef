"""Postprocessing: size filters, id filters, orphan handling, graph
components (port of ``cluster_tools_tpu/tasks/postprocess.py``).

  * size_filter           — discard segments below/above size bounds
    (size_filter_blocks.py:23 + background_size_filter/filling_size_filter)
  * id_filter             — remove an explicit id list (id_filter.py:22)
  * graph_watershed_assignments — reassign discarded segments to their
    strongest-connected kept neighbour by edge-weighted graph watershed
    (graph_watershed_assignments.py:172)
  * graph_connected_components  — CC over the node graph
    (graph_connected_components.py:25)
  * orphan_assignments    — merge orphans (segments without kept neighbours)
    into their largest neighbour (orphan_assignments.py:26)

All emit (old_id → new_id) assignment tables consumed by the write task.
The tables are host numpy copied from the JAX package; the filling size
filter's re-flood runs on the task's device (the 3d flood, warm-started by
kernel 3 when ``CTT_FLOOD_TILE`` is set).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.unionfind import UnionFindNp
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask
from .morphology import MORPHOLOGY_NAME

SIZE_FILTER_NAME = "size_filter_assignments.npy"
SIZE_FILTER_DISCARD_NAME = "size_filter_discard.npy"
ID_FILTER_NAME = "id_filter_assignments.npy"
GRAPH_CC_NAME = "graph_cc_assignments.npy"
GRAPH_WS_NAME = "graph_watershed_assignments.npy"


class SizeFilterTask(VolumeSimpleTask):
    """Assignment table zeroing segments outside [min_size, max_size]
    (consumes the morphology table)."""

    task_name = "size_filter"

    def __init__(self, *args, min_size: int = 0, max_size: Optional[int] = None,
                 relabel: bool = True, **kwargs):
        super().__init__(*args, min_size=min_size, max_size=max_size,
                         relabel=relabel, **kwargs)

    def run_impl(self) -> None:
        table = np.load(os.path.join(self.tmp_folder, MORPHOLOGY_NAME))
        ids = table[:, 0].astype(np.uint64)
        sizes = table[:, 1]
        keep = sizes >= self.min_size
        if self.max_size is not None:
            keep &= sizes <= self.max_size
        keep &= ids != 0
        kept_ids = ids[keep]
        new_ids = (
            np.arange(1, kept_ids.size + 1, dtype=np.uint64)
            if self.relabel
            else kept_ids
        )
        assignment = np.stack([kept_ids, new_ids], axis=1)
        np.save(os.path.join(self.tmp_folder, SIZE_FILTER_NAME), assignment)
        # the complementary discard list drives the apply steps
        # (background_size_filter / filling_size_filter / graph watershed)
        discard = ids[~keep & (ids != 0)]
        np.save(
            os.path.join(self.tmp_folder, SIZE_FILTER_DISCARD_NAME), discard
        )
        self.log(
            f"size filter: kept {kept_ids.size}/{ids.size} segments "
            f"(min_size={self.min_size})"
        )


class IdFilterTask(VolumeSimpleTask):
    """Remove an explicit list of ids (reference id_filter.py:22)."""

    task_name = "id_filter"

    def __init__(self, *args, filter_ids=(), all_ids_path: str = None, **kwargs):
        super().__init__(*args, filter_ids=tuple(filter_ids),
                         all_ids_path=all_ids_path, **kwargs)

    def run_impl(self) -> None:
        table = np.load(os.path.join(self.tmp_folder, MORPHOLOGY_NAME))
        ids = table[:, 0].astype(np.uint64)
        drop = np.isin(ids, np.asarray(self.filter_ids, dtype=np.uint64))
        kept = ids[~drop & (ids != 0)]
        assignment = np.stack([kept, kept], axis=1)
        np.save(os.path.join(self.tmp_folder, ID_FILTER_NAME), assignment)


def graph_watershed_assignments(
    edges: np.ndarray,
    weights: np.ndarray,
    seeds: np.ndarray,
    n_nodes: int,
) -> np.ndarray:
    """Edge-weighted graph watershed: unlabeled nodes adopt the label of the
    neighbor reachable over the strongest path (max-min edge weight) —
    nifty.graph.edgeWeightedWatershedsSegmentation equivalent.

    ``seeds`` [n_nodes] with 0 = unlabeled.  Host Prim-style flood.
    """
    import heapq

    labels = seeds.copy()
    adj: list = [[] for _ in range(n_nodes)]
    for (u, v), w in zip(edges, weights):
        adj[int(u)].append((int(v), float(w)))
        adj[int(v)].append((int(u), float(w)))
    heap = []
    for u in np.nonzero(seeds > 0)[0]:
        for v, w in adj[u]:
            if labels[v] == 0:
                heapq.heappush(heap, (-w, int(u), v))
    while heap:
        negw, u, v = heapq.heappop(heap)
        if labels[v] != 0:
            continue
        labels[v] = labels[u]
        for x, w in adj[v]:
            if labels[x] == 0:
                heapq.heappush(heap, (-w, v, x))
    return labels


class GraphWatershedAssignmentsTask(VolumeSimpleTask):
    """Reassign filtered-out segments to kept neighbors via graph watershed
    (reference graph_watershed_assignments.py:25).  Needs the problem graph
    (graph/edges) and edge costs/weights in the scratch store."""

    task_name = "graph_watershed_assignments"

    def __init__(self, *args, filter_path: str = None, **kwargs):
        super().__init__(*args, filter_path=filter_path, **kwargs)

    def run_impl(self) -> None:
        from .costs import COSTS_NAME
        from .graph import load_graph

        nodes, edges = load_graph(self.tmp_store())
        weights = np.load(os.path.join(self.tmp_folder, COSTS_NAME))
        filtered = np.load(self.filter_path)  # ids to discard
        drop = np.isin(nodes, filtered.astype(nodes.dtype))
        seeds = np.arange(1, nodes.size + 1, dtype=np.int64)
        seeds[drop] = 0
        # signed costs: larger = more attractive; the flood must follow merge
        # evidence, NOT |cost| (a strongly repulsive edge is a definite boundary)
        assigned = graph_watershed_assignments(
            edges, weights, seeds, nodes.size
        )
        # assigned holds (index+1) of the adopting node
        target = nodes[np.maximum(assigned - 1, 0)]
        target = np.where(assigned > 0, target, 0)
        assignment = np.stack([nodes, target.astype(np.uint64)], axis=1)
        np.save(os.path.join(self.tmp_folder, GRAPH_WS_NAME), assignment)
        self.log(f"graph-watershed reassigned {int(drop.sum())} segments")


class GraphConnectedComponentsTask(VolumeSimpleTask):
    """Connected components over the node graph, optionally restricted to edges
    above a merge threshold (reference graph_connected_components.py:25)."""

    task_name = "graph_connected_components"

    def __init__(self, *args, threshold: Optional[float] = None, **kwargs):
        super().__init__(*args, threshold=threshold, **kwargs)

    def run_impl(self) -> None:
        from .costs import COSTS_NAME
        from .graph import load_graph

        nodes, edges = load_graph(self.tmp_store())
        use = np.ones(edges.shape[0], dtype=bool)
        if self.threshold is not None:
            weights = np.load(os.path.join(self.tmp_folder, COSTS_NAME))
            use = weights > self.threshold
        uf = UnionFindNp(nodes.size)
        if use.any():
            uf.merge(edges[use, 0], edges[use, 1])
        roots = uf.compress()
        _, comp = np.unique(roots, return_inverse=True)
        assignment = np.stack(
            [nodes, (comp + 1).astype(np.uint64)], axis=1
        )
        np.save(os.path.join(self.tmp_folder, GRAPH_CC_NAME), assignment)
        n_comp = int(comp.max()) + 1 if comp.size else 0
        self.log(f"graph CC: {nodes.size} nodes → {n_comp} components")


ORPHANS_NAME = "orphan_assignments.npy"


class OrphanAssignmentsTask(VolumeSimpleTask):
    """Merge orphan segments (graph degree one after applying an assignment)
    into their single neighbor (reference orphan_assignments.py:26-146)."""

    task_name = "orphan_assignments"

    def __init__(self, *args, assignment_path: str = None,
                 relabel: bool = False, **kwargs):
        super().__init__(*args, assignment_path=assignment_path,
                         relabel=relabel, **kwargs)

    def run_impl(self) -> None:
        from ..ops.multicut import contract_edges
        from .graph import load_graph

        nodes, edges = load_graph(self.tmp_store())
        # assignments: dense per-node-index cluster vector or (node, cluster)
        # table; nodes absent from a sparse table keep their own label
        # (mapping them to 0 would wipe every unlisted segment to background).
        # No path = identity: orphans judged on the raw fragment graph.
        table = (
            nodes.astype(np.uint64)
            if self.assignment_path is None
            else np.load(self.assignment_path)
        )
        if table.ndim == 2:
            assignments = nodes.astype(np.uint64).copy()
            idx = np.searchsorted(nodes, table[:, 0].astype(nodes.dtype))
            ok = idx < nodes.size
            ok &= nodes[np.clip(idx, 0, nodes.size - 1)] == table[:, 0].astype(
                nodes.dtype
            )
            assignments[idx[ok]] = table[ok, 1].astype(np.uint64)
        else:
            assignments = table.astype(np.uint64)

        cl_u = assignments[edges[:, 0]].astype(np.int64)
        cl_v = assignments[edges[:, 1]].astype(np.int64)
        new_uv, _ = contract_edges(cl_u, cl_v, np.ones(edges.shape[0]))
        ids, degrees = np.unique(new_uv, return_counts=True)
        orphans = ids[degrees == 1]
        orphans = orphans[orphans != 0]
        adopt = assignments.copy()
        if orphans.size:
            # each orphan has exactly one incident contracted edge — adopt
            # the other endpoint (reference orphan_assignments.py:129-141)
            flat = new_uv.reshape(-1)
            other = new_uv[:, ::-1].reshape(-1)
            order = np.argsort(flat, kind="stable")
            pos = np.searchsorted(flat[order], orphans)
            neighbor = other[order][pos]
            remap = {int(o): int(nb) for o, nb in zip(orphans, neighbor)}
            adopt = np.asarray(
                [remap.get(int(a), int(a)) for a in assignments],
                dtype=np.uint64,
            )
        if self.relabel:
            uniq, inv = np.unique(adopt, return_inverse=True)
            # keep 0 fixed, compact the rest to 1..k
            remap_v = np.zeros(uniq.size, dtype=np.uint64)
            nonzero = uniq != 0
            remap_v[nonzero] = np.arange(1, int(nonzero.sum()) + 1)
            adopt = remap_v[inv]
        assignment = np.stack([nodes, adopt], axis=1)
        np.save(os.path.join(self.tmp_folder, ORPHANS_NAME), assignment)
        self.log(f"merged {orphans.size} orphans")


class FilterBlocksTask(VolumeTask):
    """Zero out an id list block-wise (reference filter_blocks.py:25;
    background_size_filter.py:20 is the same apply step driven by the size
    filter's discard list)."""

    task_name = "filter_blocks"
    output_dtype = "uint64"

    def __init__(self, *args, filter_path: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_path = filter_path
        self._discard = None

    def discard_ids(self) -> np.ndarray:
        if self._discard is None:  # loaded once per task, not once per block
            self._discard = np.load(self.filter_path).astype(np.uint64)
        return self._discard

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        labels = np.asarray(self.input_ds()[block.slicing]).astype(np.uint64)
        if not labels.any():
            return
        labels = np.where(np.isin(labels, self.discard_ids()), 0, labels)
        self.output_ds()[block.slicing] = labels


class BackgroundSizeFilterTask(FilterBlocksTask):
    """Alias task matching the reference's name for the map-to-background
    apply step (background_size_filter.py:20)."""

    task_name = "background_size_filter"


class FillingSizeFilterTask(VolumeTask):
    """Discarded ids are re-flooded from the surviving segments over a height
    map instead of mapped to background (reference filling_size_filter.py:21);
    the seeded flood is the device watershed kernel."""

    task_name = "filling_size_filter"
    output_dtype = "uint64"

    def __init__(self, *args, hmap_path: str = None, hmap_key: str = None,
                 res_path: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.hmap_path = hmap_path
        self.hmap_key = hmap_key
        self.res_path = res_path
        self._discard = None

    def discard_ids(self) -> np.ndarray:
        if self._discard is None:
            self._discard = np.load(self.res_path).astype(np.uint64)
        return self._discard

    def process_block(self, block_id: int, blocking: Blocking, config):
        from ..ops.watershed import seeded_watershed
        from ..runtime.device import resolve_device
        from ..utils import store as store_mod

        dev = resolve_device(config)
        block = blocking.block(block_id)
        bb = block.slicing
        labels = np.asarray(self.input_ds()[bb]).astype(np.uint64)
        if not labels.any():
            return
        discard_mask = np.isin(labels, self.discard_ids())
        out_ds = self.output_ds()
        if not discard_mask.any():
            out_ds[bb] = labels
            return
        hmap_ds = store_mod.file_reader(self.hmap_path, "r")[self.hmap_key]
        hmap_bb = ((slice(0, 1),) + bb) if len(hmap_ds.shape) == 4 else bb
        hmap = np.asarray(hmap_ds[hmap_bb])
        if hmap.ndim == 4:
            hmap = hmap[0]
        labels[discard_mask] = 0
        # compact to int32 seeds for the device flood, map back after
        uniq = np.unique(labels)
        seeds = np.searchsorted(uniq, labels).astype(np.int32)
        flooded = seeded_watershed(
            torch.from_numpy(np.ascontiguousarray(hmap, dtype=np.float32)).to(dev),
            torch.from_numpy(seeds).to(dev),
        )
        out_ds[bb] = uniq[flooded.cpu().numpy()]
