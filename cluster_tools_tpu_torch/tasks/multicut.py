"""Hierarchical multicut solve (ICCV'17 domain decomposition); port of
``cluster_tools_tpu/tasks/multicut.py``, host numpy as there.

Reference multicut/{solve_subproblems,reduce_problem,solve_global}.py
(SURVEY.md §3.5): per scale, blocks extract and solve their node-induced
subproblems; cut edges are collected; non-cut edges are union-find-merged and
the graph contracted with accumulated costs; block shape doubles per scale;
the final reduced graph is solved globally and composed back to scale 0.
``SubSolutionsTask`` writes each block's standalone solve and
``ReducedAssignmentsTask`` the reduced (not globally solved) labeling, for
inspection.

Scratch layout:
  multicut/s{s}/cut_edges   ragged per (scale-s) block: cut edge ids
  multicut/s{s}.npz         reduced problem: edges, costs, node_labeling
                            (scale-0 dense node → scale-s cluster)
  multicut_assignments.npy  final (label, segment) table for the write task
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from ..ops.multicut import contract_edges, solve_multicut
from ..ops.unionfind import UnionFindNp
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks
from .costs import COSTS_NAME
from .graph import read_block_with_upper_halo, load_graph

ASSIGNMENTS_NAME = "multicut_assignments.npy"


def _scale_problem_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(tmp_folder, f"multicut_s{scale}.npz")


def load_scale_problem(task, scale: int):
    """Graph at a scale: (edges, costs, node_labeling).

    Invariant: ``edges`` at scale s are in *scale-s cluster* coordinates and
    ``node_labeling`` maps scale-0 dense node ids → scale-s cluster ids (at
    scale 0 the clusters ARE the dense node ids, so the labeling is identity).
    Consumers must therefore index per-edge data with the edge endpoints
    directly — mapping them through ``node_labeling`` again would double-apply
    the contraction.
    """
    if scale == 0:
        _, edges = load_graph(task.tmp_store())
        costs = np.load(os.path.join(task.tmp_folder, COSTS_NAME))
        n_nodes = int(task.tmp_store()["graph/edges"].attrs["n_nodes"])
        return edges, costs, np.arange(n_nodes, dtype=np.int64)
    with np.load(_scale_problem_path(task.tmp_folder, scale)) as f:
        return f["edges"], f["costs"], f["node_labeling"]


def block_dense_nodes(nodes: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Dense graph ids of the (non-zero) labels present in a block, guarding
    labels missing from the graph (e.g. isolated segments)."""
    block_labels = np.unique(seg)
    block_labels = block_labels[block_labels > 0]
    if block_labels.size == 0:
        return np.zeros(0, dtype=np.int64)
    dense = np.searchsorted(nodes, block_labels)
    in_range = dense < nodes.size
    dense, block_labels = dense[in_range], block_labels[in_range]
    found = nodes[dense] == block_labels
    return dense[found].astype(np.int64)


def extract_cluster_subgraph(edges, node_labeling, dense):
    """Edges of the node-induced subproblem over current-scale clusters.

    ``dense`` are scale-0 dense node ids present in the block; the member set
    is their cluster image.  Returns (sub_edge_ids, uniq_cluster_ids,
    local_uv, member) with ``local_uv`` relabeled to 0..len(uniq)-1 and
    ``member`` the cluster membership mask, or ``(empty, None, None, member)``
    when no edge is internal.
    """
    current = np.unique(node_labeling[dense])
    member = np.zeros(int(node_labeling.max()) + 2, dtype=bool)
    member[current] = True
    cur_u, cur_v = edges[:, 0], edges[:, 1]
    in_sub = member[cur_u] & member[cur_v] & (cur_u != cur_v)
    sub_edge_ids = np.nonzero(in_sub)[0]
    if sub_edge_ids.size == 0:
        return sub_edge_ids, None, None, member
    uniq, inv = np.unique(
        np.stack([cur_u[in_sub], cur_v[in_sub]]), return_inverse=True
    )
    local_uv = inv.reshape(2, -1).T
    return sub_edge_ids, uniq, local_uv, member


def write_assignment_table(task, final: np.ndarray, out_name: str) -> None:
    """(watershed label → 1-based segment) table for the write task; label 0
    (if present in the graph) keeps segment 0."""
    nodes, _ = load_graph(task.tmp_store())
    table = np.stack(
        [nodes, (final + 1).astype(np.uint64)], axis=1
    ).astype(np.uint64)
    if nodes.size and nodes[0] == 0:
        table[0, 1] = 0
    np.save(os.path.join(task.tmp_folder, out_name), table)


class SolveSubproblemsTask(VolumeTask):
    """Per-block subgraph extraction + solve (reference solve_subproblems.py:31).

    ``input_path/key`` is the watershed label volume — a block's node set is the
    set of (current-scale clusters of) labels present in its bounding box.
    """

    task_name = "solve_subproblems"
    output_dtype = None

    def __init__(self, *args, scale: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = scale

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def get_block_shape(self, gconf):
        # block shape doubles per scale (reference reduce_problem.py:246-258)
        return [bs * (2**self.scale) for bs in gconf["block_shape"]]

    def process_block(self, block_id: int, blocking: Blocking, config):
        store = self.tmp_store()
        nodes, _ = load_graph(store)
        edges, costs, node_labeling = load_scale_problem(self, self.scale)

        # +1 upper halo: the node set must cover both endpoints of every
        # cross-face edge the graph extraction saw (graph.py reads the same
        # halo), or those edges land in no subproblem, are never cut, and
        # ReduceProblem would union-merge them regardless of cost
        seg = read_block_with_upper_halo(
            self.input_ds(), blocking, block_id
        )
        out = self.tmp_ragged(
            f"multicut/s{self.scale}/cut_edges", blocking.n_blocks, np.int64
        )
        dense = block_dense_nodes(nodes, seg)
        if dense.size == 0 or edges.shape[0] == 0:
            out.write_chunk((block_id,), np.array([], dtype=np.int64))
            return
        sub_edge_ids, uniq, local_uv, _ = extract_cluster_subgraph(
            edges, node_labeling, dense
        )
        if sub_edge_ids.size == 0:
            out.write_chunk((block_id,), np.array([], dtype=np.int64))
            return
        result = solve_multicut(uniq.size, local_uv, costs[sub_edge_ids])
        cut = result[local_uv[:, 0]] != result[local_uv[:, 1]]
        out.write_chunk((block_id,), sub_edge_ids[cut].astype(np.int64))


class ReduceProblemTask(VolumeSimpleTask):
    """Merge non-cut edges, contract the graph, emit the next-scale problem
    (reference reduce_problem.py:30)."""

    task_name = "reduce_problem"

    def __init__(self, *args, scale: int = 0, input_path: str = None,
                 input_key: str = None, **kwargs):
        super().__init__(*args, scale=scale, input_path=input_path,
                         input_key=input_key, **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(
            self.config_dir, self.input_path, self.input_key, scale=self.scale
        )
        edges, costs, node_labeling = load_scale_problem(self, self.scale)
        store = self.tmp_store()
        cut_ds = store[f"multicut/s{self.scale}/cut_edges"]
        cut = np.zeros(edges.shape[0], dtype=bool)
        for chunk in read_ragged_chunks(cut_ds, n_blocks, merge_threads(self)):
            if chunk is not None and chunk.size:
                cut[chunk] = True

        n_current = int(node_labeling.max()) + 1
        uf = UnionFindNp(n_current)
        # edges are already in current-scale cluster coordinates
        cur_u, cur_v = edges[:, 0], edges[:, 1]
        keep = ~cut & (cur_u != cur_v)
        uf.merge(cur_u[keep], cur_v[keep])
        roots = uf.compress()
        _, new_ids = np.unique(roots, return_inverse=True)
        merged_labeling = new_ids[node_labeling].astype(np.int64)

        new_edges, new_costs = contract_edges(
            new_ids[cur_u], new_ids[cur_v], costs
        )

        np.savez(
            _scale_problem_path(self.tmp_folder, self.scale + 1),
            edges=new_edges,
            costs=new_costs,
            node_labeling=merged_labeling,
        )
        self.log(
            f"scale {self.scale}: {edges.shape[0]} edges / "
            f"{n_current} nodes → {new_edges.shape[0]} edges / "
            f"{int(new_ids.max()) + 1} nodes"
        )


class SolveGlobalTask(VolumeSimpleTask):
    """Solve the final reduced problem and emit the (label → segment) table
    (reference solve_global.py:25)."""

    task_name = "solve_global"

    def __init__(self, *args, scale: int = 0, **kwargs):
        super().__init__(*args, scale=scale, **kwargs)

    def run_impl(self) -> None:
        edges, costs, node_labeling = load_scale_problem(self, self.scale)
        n_current = int(node_labeling.max()) + 1
        result = solve_multicut(n_current, edges, costs)
        final = result[node_labeling]  # scale-0 dense node → segment
        write_assignment_table(self, final, ASSIGNMENTS_NAME)
        self.log(
            f"global solve: {n_current} nodes → {int(result.max()) + 1} segments"
        )


def reduced_assignments_name(scale: int) -> str:
    return f"reduced_assignments_s{scale}.npy"


class ReducedAssignmentsTask(VolumeSimpleTask):
    """Emit the scale-``n`` *reduced* labeling (merged through the
    hierarchical reduces, but not globally solved) as a (label → segment)
    table, the role of ``s{n}/node_labeling`` in the reference's
    ReducedSolutionWorkflow (multicut_workflow.py:103-125)."""

    task_name = "reduced_assignments"

    def __init__(self, *args, scale: int = 0, **kwargs):
        super().__init__(*args, scale=scale, **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def run_impl(self) -> None:
        if self.scale == 0:
            # identity labeling straight from the graph: scale 0 needs
            # neither edges nor costs (which may not have been computed)
            n_nodes = int(self.tmp_store()["graph/edges"].attrs["n_nodes"])
            node_labeling = np.arange(n_nodes, dtype=np.int64)
        else:
            _, _, node_labeling = load_scale_problem(self, self.scale)
        write_assignment_table(
            self, node_labeling.astype(np.int64),
            reduced_assignments_name(self.scale),
        )
        self.log(
            f"scale-{self.scale} reduced labeling: "
            f"{int(node_labeling.max()) + 1} clusters"
        )


class SubSolutionsTask(VolumeTask):
    """Write each block's standalone sub-solution as a label volume for
    inspection (reference sub_solutions.py:28): the block's subproblem is
    solved in isolation and the watershed labels (``input_path/key``) are
    mapped through the local result, offset into the block's id namespace."""

    task_name = "sub_solutions"
    output_dtype = "uint64"

    def __init__(self, *args, scale: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = scale

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def get_block_shape(self, gconf):
        return [bs * (2**self.scale) for bs in gconf["block_shape"]]

    def process_block(self, block_id: int, blocking: Blocking, config):
        nodes, _ = load_graph(self.tmp_store())
        edges, costs, node_labeling = load_scale_problem(self, self.scale)
        bb = blocking.block(block_id).slicing
        ws = np.asarray(self.input_ds()[bb]).astype(np.uint64)
        out_ds = self.output_ds()
        dense = block_dense_nodes(nodes, ws)
        if dense.size == 0:
            out_ds[bb] = np.zeros(ws.shape, dtype=np.uint64)
            return
        sub_edge_ids, uniq, local_uv, _ = extract_cluster_subgraph(
            edges, node_labeling, dense
        )

        # per-voxel cluster via searchsorted over the block's (sorted) labels
        # — no dense nodes.max()-sized arrays; labels missing from the graph
        # go to 0 deliberately (a graph/volume mismatch should be visible)
        block_labels = nodes[dense]  # ascending
        pos = np.searchsorted(block_labels, ws)
        safe = np.clip(pos, 0, block_labels.size - 1)
        known = (ws > 0) & (block_labels[safe] == ws)
        cluster = np.where(known, node_labeling[dense][safe], -1)

        # every cluster present in the block gets a segment id: solved
        # clusters take their multicut component, edge-less clusters get
        # fresh ids after them — coverage never depends on edge locality
        clusters_here = np.unique(node_labeling[dense])
        if sub_edge_ids.size:
            result = solve_multicut(uniq.size, local_uv, costs[sub_edge_ids])
            n_res = int(result.max()) + 1
        else:
            uniq = np.zeros(0, dtype=np.int64)
            result = np.zeros(0, dtype=np.int64)
            n_res = 0
        seg_of_cluster = {}
        extra = n_res
        for cl in clusters_here:
            p = np.searchsorted(uniq, cl)
            if p < uniq.size and uniq[p] == cl:
                seg_of_cluster[int(cl)] = int(result[p])
            else:
                seg_of_cluster[int(cl)] = extra
                extra += 1

        # segment ids are bounded by the cluster count <= node_labeling.max()+1,
        # so this offset spacing keeps block namespaces disjoint
        offset = np.uint64(block_id) * np.uint64(int(node_labeling.max()) + 2)
        lut = np.asarray(
            [seg_of_cluster[int(c)] for c in clusters_here], dtype=np.uint64
        )
        cl_pos = np.searchsorted(clusters_here, np.maximum(cluster, 0))
        seg = np.where(
            cluster >= 0,
            lut[np.clip(cl_pos, 0, lut.size - 1)] + np.uint64(1) + offset,
            0,
        )
        out_ds[bb] = seg.astype(np.uint64)
