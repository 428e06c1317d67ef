"""Sparse lifted-edge construction from biological priors.

Port of ``cluster_tools_tpu/tasks/lifted_features.py`` (host numpy there and
here; reference lifted_features/*.py, SURVEY.md §2.3): BFS lifted
neighborhood to a graph depth restricted to semantically labeled nodes
(``ndist.computeLiftedNeighborhoodFromNodeLabels``,
sparse_lifted_neighborhood.py:132-137), attractive/repulsive lifted costs from
same/different node labels (costs_from_node_labels.py:25), clearing lifted
edges touching given labels (clear_lifted_edges_from_labels.py:23), and merging
several lifted problems (merge_lifted_problems.py:23).

File layout in ``tmp_folder`` (one lifted problem per ``prefix``; the JAX
package's, so either package reads the other's):
  lifted_problem_{prefix}.npz   uv [L,2] dense node indices, costs [L]
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..ops.lifted import (
    lifted_costs_from_node_labels,
    lifted_neighborhood,
    merge_lifted_problems,
)
from .base import VolumeSimpleTask
from .graph import load_graph
from .node_labels import NODE_LABELS_NAME


def lifted_problem_path(tmp_folder: str, prefix: str) -> str:
    return os.path.join(tmp_folder, f"lifted_problem_{prefix}.npz")


def load_lifted_problem(tmp_folder: str, prefix: str):
    """Returns (lifted_uv [L,2] dense indices, costs [L])."""
    with np.load(lifted_problem_path(tmp_folder, prefix)) as f:
        return f["uv"], f["costs"]


def save_lifted_problem(tmp_folder: str, prefix: str, uv, costs) -> None:
    np.savez(
        lifted_problem_path(tmp_folder, prefix),
        uv=np.asarray(uv, dtype=np.int64).reshape(-1, 2),
        costs=np.asarray(costs, dtype=np.float64),
    )


def dense_node_labels(task, nodes: np.ndarray, labels_path: str = None) -> np.ndarray:
    """Per-graph-node semantic labels.  Reads the merged node-label table
    (tasks/node_labels.py) by default, or an explicit .npy (dense [n] array or
    [k,2] (node, label) table)."""
    path = labels_path or os.path.join(task.tmp_folder, NODE_LABELS_NAME)
    table = np.load(path)
    if table.ndim == 1:
        # the dense array is indexed by node *label value*, which has gaps —
        # it must cover max(nodes), not just count nodes.size entries
        max_node = int(nodes.max()) if nodes.size else -1
        if table.size <= max_node:
            raise ValueError(
                f"dense node-label array has {table.size} entries but the "
                f"largest graph node id is {max_node}"
            )
        return table[nodes.astype(np.int64)]
    out = np.zeros(nodes.size, dtype=np.int64)
    idx = np.searchsorted(nodes, table[:, 0].astype(nodes.dtype))
    valid = (idx < nodes.size)
    valid &= nodes[np.clip(idx, 0, nodes.size - 1)] == table[:, 0].astype(nodes.dtype)
    out[idx[valid]] = table[valid, 1].astype(np.int64)
    return out


class SparseLiftedNeighborhoodTask(VolumeSimpleTask):
    """Lifted edges between labeled nodes within a graph depth
    (reference sparse_lifted_neighborhood.py:24)."""

    task_name = "sparse_lifted_neighborhood"

    def __init__(self, *args, prefix: str = "lifted",
                 node_labels_path: str = None, **kwargs):
        super().__init__(*args, prefix=prefix,
                         node_labels_path=node_labels_path, **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}"

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"nh_graph_depth": 2, "ignore_label": 0})
        return conf

    def run_impl(self) -> None:
        conf = self.get_task_config()
        nodes, edges = load_graph(self.tmp_store())
        node_labels = dense_node_labels(self, nodes, self.node_labels_path)
        ignore = conf.get("ignore_label", 0)
        participating = (
            np.ones(nodes.size, dtype=bool)
            if ignore is None
            else node_labels != ignore
        )
        uv = lifted_neighborhood(
            nodes.size, edges, participating,
            depth=int(conf.get("nh_graph_depth", 2)),
        )
        save_lifted_problem(self.tmp_folder, self.prefix, uv, np.zeros(uv.shape[0]))
        self.log(
            f"lifted neighborhood '{self.prefix}': {uv.shape[0]} lifted edges "
            f"over {int(participating.sum())} labeled nodes "
            f"(depth {conf.get('nh_graph_depth', 2)})"
        )


class LiftedCostsFromNodeLabelsTask(VolumeSimpleTask):
    """± lifted costs from node-label agreement
    (reference costs_from_node_labels.py:25)."""

    task_name = "costs_from_node_labels"

    def __init__(self, *args, prefix: str = "lifted",
                 node_labels_path: str = None, **kwargs):
        super().__init__(*args, prefix=prefix,
                         node_labels_path=node_labels_path, **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}"

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {"same_cost": 2.0, "different_cost": -2.0, "ignore_label": 0}
        )
        return conf

    def run_impl(self) -> None:
        conf = self.get_task_config()
        nodes, _ = load_graph(self.tmp_store())
        node_labels = dense_node_labels(self, nodes, self.node_labels_path)
        uv, _ = load_lifted_problem(self.tmp_folder, self.prefix)
        uv, costs = lifted_costs_from_node_labels(
            uv, node_labels,
            same_cost=float(conf.get("same_cost", 2.0)),
            different_cost=float(conf.get("different_cost", -2.0)),
            ignore_label=conf.get("ignore_label", 0),
        )
        save_lifted_problem(self.tmp_folder, self.prefix, uv, costs)
        self.log(
            f"lifted costs '{self.prefix}': {uv.shape[0]} edges, "
            f"{int((costs > 0).sum())} attractive / {int((costs < 0).sum())} repulsive"
        )


class ClearLiftedEdgesFromLabelsTask(VolumeSimpleTask):
    """Drop lifted edges whose endpoints carry one of the given labels
    (reference clear_lifted_edges_from_labels.py:23)."""

    task_name = "clear_lifted_edges_from_labels"

    def __init__(self, *args, prefix: str = "lifted",
                 node_labels_path: str = None, clear_labels=(), **kwargs):
        super().__init__(*args, prefix=prefix,
                         node_labels_path=node_labels_path,
                         clear_labels=tuple(clear_labels), **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}"

    def run_impl(self) -> None:
        nodes, _ = load_graph(self.tmp_store())
        node_labels = dense_node_labels(self, nodes, self.node_labels_path)
        uv, costs = load_lifted_problem(self.tmp_folder, self.prefix)
        clear = np.asarray(self.clear_labels, dtype=node_labels.dtype)
        bad = np.isin(node_labels[uv[:, 0]], clear) | np.isin(
            node_labels[uv[:, 1]], clear
        )
        save_lifted_problem(self.tmp_folder, self.prefix, uv[~bad], costs[~bad])
        self.log(f"cleared {int(bad.sum())}/{uv.shape[0]} lifted edges")


class MergeLiftedProblemsTask(VolumeSimpleTask):
    """Sum-merge several lifted problems (reference merge_lifted_problems.py:23)."""

    task_name = "merge_lifted_problems"

    def __init__(self, *args, prefixes=(), out_prefix: str = "lifted", **kwargs):
        super().__init__(*args, prefixes=tuple(prefixes), out_prefix=out_prefix,
                         **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.out_prefix}"

    def run_impl(self) -> None:
        problems = [
            load_lifted_problem(self.tmp_folder, p) for p in self.prefixes
        ]
        uv, costs = merge_lifted_problems(problems)
        save_lifted_problem(self.tmp_folder, self.out_prefix, uv, costs)
        self.log(
            f"merged {len(problems)} lifted problems → {uv.shape[0]} edges"
        )
