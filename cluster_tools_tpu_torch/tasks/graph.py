"""Distributed region-adjacency-graph extraction (port of
``cluster_tools_tpu/tasks/graph.py``, host numpy as there).

Reference graph/{initial_sub_graphs,merge_sub_graphs,map_edge_ids}.py via
nifty.distributed (SURVEY.md §2.3): per-block subgraphs → merged global graph →
block-local → global edge-id maps.

Storage layout in the scratch store (``tmp_folder/data.zarr``):
  graph/sub_edges        ragged per block: flattened (u,v) label pairs (uint64)
  graph/sub_nodes        ragged per block: unique non-zero labels (uint64)
  graph/nodes            [n] sorted unique node labels (uint64)
  graph/edges            [m,2] dense node-index pairs, lexicographically sorted
  graph/block_edge_ids   ragged per block: global edge id per block edge

Nodes are collected per block (not derived from edges) so isolated fragments —
labels with no adjacent fragment — stay in the graph and keep their identity
through solve/write (the reference's graph carries all nodes the same way).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..ops.rag import block_edges
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

SUB_EDGES_KEY = "graph/sub_edges"
SUB_NODES_KEY = "graph/sub_nodes"
NODES_KEY = "graph/nodes"
EDGES_KEY = "graph/edges"
BLOCK_EDGE_IDS_KEY = "graph/block_edge_ids"


def read_block_with_upper_halo(ds, blocking: Blocking, block_id: int):
    """Block plus one voxel towards the upper neighbors, so cross-block label
    faces are captured (clipped at the volume border)."""
    block = blocking.block(block_id)
    end = tuple(min(e + 1, s) for e, s in zip(block.end, blocking.shape))
    return ds[tuple(slice(b, e) for b, e in zip(block.begin, end))]


def load_graph(tmp_store):
    """Returns (nodes [n] uint64, edges [m,2] int64 dense indices)."""
    nodes = tmp_store[NODES_KEY][:]
    edges = tmp_store[EDGES_KEY][:]
    return nodes, edges


class InitialSubGraphsTask(VolumeTask):
    """Per-block RAG edges (reference initial_sub_graphs.py:25)."""

    task_name = "initial_sub_graphs"
    output_dtype = None

    def process_block(self, block_id: int, blocking: Blocking, config):
        seg = read_block_with_upper_halo(self.input_ds(), blocking, block_id)
        seg = seg.astype(np.uint64)
        edges = block_edges(seg)
        sub = self.tmp_ragged(SUB_EDGES_KEY, blocking.n_blocks, np.uint64)
        sub.write_chunk((block_id,), edges.reshape(-1))
        labels = np.unique(seg)
        labels = labels[labels > 0]
        sub_nodes = self.tmp_ragged(SUB_NODES_KEY, blocking.n_blocks, np.uint64)
        sub_nodes.write_chunk((block_id,), labels)


def scale_keys(scale: int):
    """Ragged sub-graph dataset keys at pyramid ``scale`` (scale 0 = the
    per-block outputs of ``InitialSubGraphsTask``)."""
    if scale == 0:
        return SUB_EDGES_KEY, SUB_NODES_KEY
    return f"{SUB_EDGES_KEY}_s{scale}", f"{SUB_NODES_KEY}_s{scale}"


class MergeScaleSubGraphsTask(VolumeTask):
    """One level of the sub-graph scale pyramid
    (reference merge_sub_graphs.py:24, graph_workflow.py:36-54): each block at
    scale ``s`` (block shape × 2^s) merges and dedups the sub-graphs of its
    2³ child blocks at scale s-1, so the final global merge reads few large
    chunks instead of every scale-0 chunk — not a single-node memory/IO choke
    at production block counts."""

    task_name = "merge_scale_sub_graphs"
    output_dtype = None

    def __init__(self, *args, scale: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = int(scale)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def get_block_shape(self, gconf):
        return [bs * (2 ** self.scale) for bs in gconf["block_shape"]]

    def process_block(self, block_id: int, blocking: Blocking, config):
        store = self.tmp_store()
        in_edges_key, in_nodes_key = scale_keys(self.scale - 1)
        out_edges_key, out_nodes_key = scale_keys(self.scale)
        child_bs = [bs // 2 for bs in blocking.block_shape]
        child_blocking = Blocking(blocking.shape, child_bs)
        block = blocking.block(block_id)
        child_ids = child_blocking.blocks_overlapping_roi(
            block.begin, block.end
        )
        in_edges = store[in_edges_key]
        in_nodes = store[in_nodes_key]
        edge_chunks, node_chunks = [], []
        for cid in child_ids:
            c = in_edges.read_chunk((cid,))
            if c is not None and c.size:
                edge_chunks.append(c.reshape(-1, 2))
            n = in_nodes.read_chunk((cid,))
            if n is not None and n.size:
                node_chunks.append(n)
        edges = (
            np.unique(np.concatenate(edge_chunks, axis=0), axis=0)
            if edge_chunks
            else np.zeros((0, 2), dtype=np.uint64)
        )
        nodes = (
            np.unique(np.concatenate(node_chunks))
            if node_chunks
            else np.zeros(0, dtype=np.uint64)
        )
        out_edges = self.tmp_ragged(out_edges_key, blocking.n_blocks, np.uint64)
        out_edges.write_chunk((block_id,), edges.reshape(-1))
        out_nodes = self.tmp_ragged(out_nodes_key, blocking.n_blocks, np.uint64)
        out_nodes.write_chunk((block_id,), nodes)


class MergeSubGraphsTask(VolumeSimpleTask):
    """Merge block subgraphs into the global graph
    (reference merge_sub_graphs.py:24,147 with ``scale='complete'``): one
    sort-based merge — np.unique over the chunks of the top pyramid scale."""

    task_name = "merge_sub_graphs"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 scale: int = 0, **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         scale=scale, **kwargs)

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(
            self.config_dir, self.input_path, self.input_key, scale=self.scale
        )
        store = self.tmp_store()
        edges_key, nodes_key = scale_keys(self.scale)
        sub = store[edges_key]
        sub_nodes = store[nodes_key]
        n_thr = merge_threads(self)
        collected = [
            c.reshape(-1, 2)
            for c in read_ragged_chunks(sub, n_blocks, n_thr)
            if c is not None and c.size
        ]
        node_chunks = [
            c
            for c in read_ragged_chunks(sub_nodes, n_blocks, n_thr)
            if c is not None and c.size
        ]
        if collected:
            label_edges = np.unique(np.concatenate(collected, axis=0), axis=0)
        else:
            label_edges = np.zeros((0, 2), dtype=np.uint64)
        nodes = (
            np.unique(np.concatenate(node_chunks))
            if node_chunks
            else np.zeros(0, dtype=np.uint64)
        )
        dense = np.searchsorted(nodes, label_edges).astype(np.int64)
        # lexicographic edge order (u, then v) — defines global edge ids
        order = np.lexsort((dense[:, 1], dense[:, 0]))
        dense = dense[order]
        store.create_dataset(
            NODES_KEY, data=nodes, chunks=(max(nodes.size, 1),), exist_ok=True
        )
        store.create_dataset(
            EDGES_KEY,
            data=dense,
            chunks=(max(dense.shape[0], 1), 2),
            exist_ok=True,
        )
        g = store[EDGES_KEY]
        g.attrs["n_nodes"] = int(nodes.size)
        g.attrs["n_edges"] = int(dense.shape[0])
        self.log(f"graph: {nodes.size} nodes, {dense.shape[0]} edges")


class MapEdgeIdsTask(VolumeTask):
    """Per-block map of block edges → global edge ids
    (reference map_edge_ids.py:23)."""

    task_name = "map_edge_ids"
    output_dtype = None

    def process_block(self, block_id: int, blocking: Blocking, config):
        store = self.tmp_store()
        nodes, edges = load_graph(store)
        sub = store[SUB_EDGES_KEY].read_chunk((block_id,))
        out = self.tmp_ragged(BLOCK_EDGE_IDS_KEY, blocking.n_blocks, np.int64)
        if sub is None or sub.size == 0:
            out.write_chunk((block_id,), np.array([], dtype=np.int64))
            return
        pairs = np.searchsorted(nodes, sub.reshape(-1, 2)).astype(np.int64)
        # edge id = position in the lexicographically sorted global edge list
        keys = edges[:, 0] * (nodes.size + 1) + edges[:, 1]
        want = pairs[:, 0] * (nodes.size + 1) + pairs[:, 1]
        ids = np.searchsorted(keys, want)
        if not (keys[np.clip(ids, 0, keys.size - 1)] == want).all():
            raise RuntimeError(
                f"block {block_id}: edges missing from the global graph"
            )
        out.write_chunk((block_id,), ids.astype(np.int64))
