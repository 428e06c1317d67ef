"""Hierarchical lifted multicut solve.

Port of ``cluster_tools_tpu/tasks/lifted_multicut.py`` (host numpy there and
here; reference lifted_multicut/{solve_lifted_subproblems,
reduce_lifted_problem,solve_lifted_global}.py, SURVEY.md §2.3): the same
domain-decomposition scheme as the multicut family, with the lifted edges and
costs carried through every contraction.  Per-block subproblems include the
lifted edges internal to the block's node set (solve_lifted_subproblems.py:
205-213); the reduction contracts local edges, remaps lifted pairs and
sum-merges duplicates; the global step solves the final reduced lifted
problem.

Scratch layout (extends tasks/multicut.py; the JAX package's):
  lifted_multicut/s{s}/cut_edges      ragged per block: cut LOCAL edge ids
  lifted_multicut_s{s}.npz            reduced problem: edges, costs,
                                      lifted_uv, lifted_costs, node_labeling
  lifted_multicut_assignments.npy     final (label, segment) table
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.lifted import solve_lifted_multicut
from ..ops.multicut import contract_edges
from ..ops.unionfind import UnionFindNp
from ..utils.blocking import Blocking
from .base import (
    VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks,
)
from .graph import load_graph
from .lifted_features import load_lifted_problem
from .multicut import (
    block_dense_nodes,
    extract_cluster_subgraph,
    load_scale_problem,
    write_assignment_table,
)

LIFTED_ASSIGNMENTS_NAME = "lifted_multicut_assignments.npy"


def _lifted_scale_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(tmp_folder, f"lifted_multicut_s{scale}.npz")


def load_lifted_scale_problem(task, scale: int, prefix: str = "lifted"):
    """(edges, costs, lifted_uv, lifted_costs, node_labeling) at a scale."""
    if scale == 0:
        edges, costs, node_labeling = load_scale_problem(task, 0)
        lifted_uv, lifted_costs = load_lifted_problem(task.tmp_folder, prefix)
        return edges, costs, lifted_uv, lifted_costs, node_labeling
    with np.load(_lifted_scale_path(task.tmp_folder, scale)) as f:
        return (
            f["edges"], f["costs"], f["lifted_uv"], f["lifted_costs"],
            f["node_labeling"],
        )


class SolveLiftedSubproblemsTask(VolumeTask):
    """Per-block lifted subproblem solve
    (reference solve_lifted_subproblems.py:32)."""

    task_name = "solve_lifted_subproblems"
    output_dtype = None

    def __init__(self, *args, scale: int = 0, prefix: str = "lifted", **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = scale
        self.prefix = prefix

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def get_block_shape(self, gconf):
        return [bs * (2**self.scale) for bs in gconf["block_shape"]]

    def process_block(self, block_id: int, blocking: Blocking, config):
        store = self.tmp_store()
        nodes, _ = load_graph(store)
        edges, costs, lifted_uv, lifted_costs, node_labeling = (
            load_lifted_scale_problem(self, self.scale, self.prefix)
        )

        seg = self.input_ds()[blocking.block(block_id).slicing]
        out = self.tmp_ragged(
            f"lifted_multicut/s{self.scale}/cut_edges", blocking.n_blocks,
            np.int64,
        )

        dense = block_dense_nodes(nodes, seg)
        if dense.size == 0 or edges.shape[0] == 0:
            out.write_chunk((block_id,), np.zeros(0, dtype=np.int64))
            return
        sub_edge_ids, uniq, local_uv, member = extract_cluster_subgraph(
            edges, node_labeling, dense
        )
        # edges that leave the block's node set are cut here and decided at
        # the next scale or in the global solve, where the lifted costs
        # between their clusters have been summed: left uncut they would
        # land in no subproblem, and ReduceLiftedProblemTask would merge
        # them whatever their local and lifted costs (the JAX task does:
        # ROADMAP Queue C)
        outer = np.nonzero(member[edges[:, 0]] != member[edges[:, 1]])[0]

        def emit(cut_ids):
            out.write_chunk((block_id,), np.union1d(cut_ids, outer).astype(np.int64))

        if sub_edge_ids.size == 0:
            emit(outer)
            return

        # lifted edges inner to the block's node set, in local coordinates
        # (lifted_uv is in current-scale cluster coordinates, like edges)
        if lifted_uv.shape[0]:
            lu, lv = lifted_uv[:, 0], lifted_uv[:, 1]
            in_lift = member[lu] & member[lv] & (lu != lv)
            llu = np.searchsorted(uniq, lu[in_lift])
            llv = np.searchsorted(uniq, lv[in_lift])
            # keep only pairs whose endpoints appear in the local subgraph
            ok = (
                (llu < uniq.size) & (llv < uniq.size)
            )
            ok &= uniq[np.clip(llu, 0, uniq.size - 1)] == lu[in_lift]
            ok &= uniq[np.clip(llv, 0, uniq.size - 1)] == lv[in_lift]
            local_lifted = np.stack([llu[ok], llv[ok]], axis=1)
            local_lifted_costs = lifted_costs[in_lift][ok]
        else:
            local_lifted = np.zeros((0, 2), dtype=np.int64)
            local_lifted_costs = np.zeros(0)

        result = solve_lifted_multicut(
            uniq.size, local_uv, costs[sub_edge_ids],
            local_lifted, local_lifted_costs,
        )
        cut = result[local_uv[:, 0]] != result[local_uv[:, 1]]
        emit(sub_edge_ids[cut])


class ReduceLiftedProblemTask(VolumeSimpleTask):
    """Contract non-cut local edges, carry lifted edges to the next scale
    (reference reduce_lifted_problem.py:30)."""

    task_name = "reduce_lifted_problem"

    def __init__(self, *args, scale: int = 0, prefix: str = "lifted",
                 input_path: str = None, input_key: str = None, **kwargs):
        super().__init__(*args, scale=scale, prefix=prefix,
                         input_path=input_path, input_key=input_key, **kwargs)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_s{self.scale}"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(
            self.config_dir, self.input_path, self.input_key, scale=self.scale
        )
        edges, costs, lifted_uv, lifted_costs, node_labeling = (
            load_lifted_scale_problem(self, self.scale, self.prefix)
        )
        store = self.tmp_store()
        cut_ds = store[f"lifted_multicut/s{self.scale}/cut_edges"]
        cut = np.zeros(edges.shape[0], dtype=bool)
        for chunk in read_ragged_chunks(cut_ds, n_blocks, merge_threads(self)):
            if chunk is not None and chunk.size:
                cut[chunk] = True

        n_current = int(node_labeling.max()) + 1
        uf = UnionFindNp(n_current)
        # edges/lifted_uv are already in current-scale cluster coordinates
        cur_u, cur_v = edges[:, 0], edges[:, 1]
        keep = ~cut & (cur_u != cur_v)
        uf.merge(cur_u[keep], cur_v[keep])
        roots = uf.compress()
        _, new_ids = np.unique(roots, return_inverse=True)
        merged_labeling = new_ids[node_labeling].astype(np.int64)

        new_edges, new_costs = contract_edges(
            new_ids[cur_u], new_ids[cur_v], costs
        )
        if lifted_uv.shape[0]:
            cl_u = new_ids[lifted_uv[:, 0]]
            cl_v = new_ids[lifted_uv[:, 1]]
            new_lifted, new_lifted_costs = contract_edges(cl_u, cl_v, lifted_costs)
        else:
            new_lifted = np.zeros((0, 2), dtype=np.int64)
            new_lifted_costs = np.zeros(0)

        np.savez(
            _lifted_scale_path(self.tmp_folder, self.scale + 1),
            edges=new_edges,
            costs=new_costs,
            lifted_uv=new_lifted,
            lifted_costs=new_lifted_costs,
            node_labeling=merged_labeling,
        )
        self.log(
            f"scale {self.scale}: {edges.shape[0]} local / "
            f"{lifted_uv.shape[0]} lifted edges, {n_current} nodes → "
            f"{new_edges.shape[0]} / {new_lifted.shape[0]} edges, "
            f"{int(new_ids.max()) + 1} nodes"
        )


class SolveLiftedGlobalTask(VolumeSimpleTask):
    """Solve the final reduced lifted problem
    (reference solve_lifted_global.py:25)."""

    task_name = "solve_lifted_global"

    def __init__(self, *args, scale: int = 0, prefix: str = "lifted", **kwargs):
        super().__init__(*args, scale=scale, prefix=prefix, **kwargs)

    def run_impl(self) -> None:
        edges, costs, lifted_uv, lifted_costs, node_labeling = (
            load_lifted_scale_problem(self, self.scale, self.prefix)
        )
        n_current = int(node_labeling.max()) + 1
        result = solve_lifted_multicut(
            n_current, edges, costs, lifted_uv, lifted_costs
        )
        final = result[node_labeling]
        write_assignment_table(self, final, LIFTED_ASSIGNMENTS_NAME)
        self.log(
            f"lifted global solve: {n_current} nodes → "
            f"{int(result.max()) + 1} segments"
        )
