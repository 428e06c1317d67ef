"""The "Problem" pipeline and multicut segmentation workflows (port of
``cluster_tools_tpu/workflows/multicut.py``).

Reference workflows.py:28-235 and multicut/multicut_workflow.py:11-61:

  GraphWorkflow:        initial_sub_graphs → [merge_scale_sub_graphs(s)]
                        → merge_sub_graphs → map_edge_ids
  EdgeFeaturesWorkflow: block_edge_features → merge_edge_features
  ProblemWorkflow:      graph → [check_sub_graphs] → features → probs_to_costs
  MulticutWorkflow:     [solve_subproblems(s) → reduce_problem(s)] × n_scales
                        → solve_global
  MulticutSegmentationWorkflow: watershed → problem → multicut → write
  SubSolutionsWorkflow / ReducedSolutionWorkflow: the hierarchical solve to
                        a scale, then each block's sub-solution or the
                        reduced labeling written as a volume

The watershed is the port's ``WatershedTask`` (kernels 1 and 2 on the card
in the default 2d mode); graph, features, costs and the solvers are host
numpy and C++, with the device RAG accumulator behind
``block_edge_features``' ``device_accumulation`` and the filter bank on
the card behind its ``filters``.  Not ported yet, and raising:
``sharded_problem`` / ``sharded_ws`` (ROADMAP Queue A 11).
"""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.costs import ProbsToCostsTask
from ..tasks.debugging import CheckSubGraphsTask
from ..tasks.features import BlockEdgeFeaturesTask, MergeEdgeFeaturesTask
from ..tasks.graph import (
    InitialSubGraphsTask,
    MapEdgeIdsTask,
    MergeScaleSubGraphsTask,
    MergeSubGraphsTask,
)
from ..tasks.multicut import (
    ASSIGNMENTS_NAME,
    ReducedAssignmentsTask,
    ReduceProblemTask,
    SolveGlobalTask,
    SolveSubproblemsTask,
    SubSolutionsTask,
    reduced_assignments_name,
)
from ..tasks.watershed import WatershedTask
from ..tasks.write import WriteTask


class GraphWorkflow(WorkflowBase):
    """Distributed RAG extraction (reference graph_workflow.py:9).

    ``n_scales > 1`` merges the per-block sub-graphs through a scale pyramid
    (each level dedups 2³ children, reference graph_workflow.py:36-66) before
    the final global merge, bounding the chunk count the single-node merge
    reads at production block counts."""

    task_name = "graph_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, n_scales: int = 1,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        if int(n_scales) < 1:
            raise ValueError(f"n_scales must be >= 1, got {n_scales}")
        self.n_scales = int(n_scales)

    def requires(self):
        dep = InitialSubGraphsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
        )
        for scale in range(1, self.n_scales):
            dep = MergeScaleSubGraphsTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[dep],
                input_path=self.input_path, input_key=self.input_key,
                scale=scale,
            )
        merge = MergeSubGraphsTask(
            self.tmp_folder, self.config_dir, dependencies=[dep],
            input_path=self.input_path, input_key=self.input_key,
            scale=self.n_scales - 1,
        )
        map_ids = MapEdgeIdsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[merge],
            input_path=self.input_path, input_key=self.input_key,
        )
        return [map_ids]


class EdgeFeaturesWorkflow(WorkflowBase):
    """reference features_workflow.py:12."""

    task_name = "edge_features_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, labels_path=None,
                 labels_key=None, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key

    def requires(self):
        block = BlockEdgeFeaturesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
        )
        merge = MergeEdgeFeaturesTask(
            self.tmp_folder, self.config_dir, dependencies=[block],
            labels_path=self.labels_path, labels_key=self.labels_key,
        )
        return [merge]


def _check_sharded_ws_flags(sharded_ws: bool, sharded_problem: bool) -> None:
    """The flag contract of both workflow entry points, then the refusal of
    the sharded paths, which the port does not have yet."""
    if sharded_ws and not sharded_problem:
        raise ValueError(
            "sharded_ws=True requires sharded_problem=True (the fused "
            "task produces the collective problem layout)"
        )
    if sharded_problem:
        raise NotImplementedError(
            "sharded_problem / sharded_ws are not ported yet (ROADMAP Queue A 11)"
        )


class ProblemWorkflow(WorkflowBase):
    """Graph extraction → (optional sanity checks) → edge features →
    (optional) costs: the standalone "problem" pipeline
    (reference workflows.py:28-107).

    ``sanity_checks`` inserts the per-block subgraph validation between graph
    extraction and feature accumulation (reference workflows.py:61-72);
    ``compute_costs=False`` stops after the features (for learning
    pipelines that predict their own probabilities).
    """

    task_name = "problem_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None,       # boundary/affinity map
                 ws_path=None, ws_key=None,             # fragment labels
                 n_scales: int = 1,
                 sanity_checks: bool = False,
                 compute_costs: bool = True,
                 probs_path=None,                       # RF edge probabilities
                 node_label_dict=None,
                 sharded_problem: bool = False,
                 sharded_ws: bool = False,
                 dependencies=()):
        _check_sharded_ws_flags(sharded_ws, sharded_problem)
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.n_scales = n_scales
        self.sanity_checks = sanity_checks
        self.compute_costs = compute_costs
        self.probs_path = probs_path
        self.node_label_dict = dict(node_label_dict or {})

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.ws_path, input_key=self.ws_key,
            n_scales=self.n_scales, dependencies=list(self.dependencies),
        )
        dep = [graph]
        if self.sanity_checks:
            check = CheckSubGraphsTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=dep,
                input_path=self.ws_path, input_key=self.ws_key,
            )
            dep = [check]
        feats = EdgeFeaturesWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.ws_path, labels_key=self.ws_key,
            dependencies=dep,
        )
        dep = [feats]
        if self.compute_costs:
            costs = ProbsToCostsTask(
                self.tmp_folder, self.config_dir, dependencies=dep,
                probs_path=self.probs_path,
                node_label_dict=self.node_label_dict,
            )
            dep = [costs]
        return dep

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["block_edge_features"] = BlockEdgeFeaturesTask.default_task_config()
        conf["probs_to_costs"] = ProbsToCostsTask.default_task_config()
        return conf


def _hierarchical_solve_tasks(
    wf, n_scales: int, dep: list, ws_path: str, ws_key: str
) -> list:
    """solve_subproblems(s) → reduce_problem(s) chains for scales
    0..n_scales-1, so the scale-``n_scales`` problem exists afterwards."""
    for scale in range(n_scales):
        solve = SolveSubproblemsTask(
            wf.tmp_folder, wf.config_dir, wf.max_jobs,
            dependencies=dep, scale=scale,
            input_path=ws_path, input_key=ws_key,
        )
        reduce_ = ReduceProblemTask(
            wf.tmp_folder, wf.config_dir,
            dependencies=[solve], scale=scale,
            input_path=ws_path, input_key=ws_key,
        )
        dep = [reduce_]
    return dep


class MulticutWorkflow(WorkflowBase):
    """Hierarchical multicut solve (reference multicut_workflow.py:45)."""

    task_name = "multicut_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, n_scales: int = 1,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.n_scales = n_scales

    def requires(self):
        dep = _hierarchical_solve_tasks(
            self, self.n_scales, list(self.dependencies),
            self.input_path, self.input_key,
        )
        solve_global = SolveGlobalTask(
            self.tmp_folder, self.config_dir, dependencies=dep,
            scale=self.n_scales,
        )
        return [solve_global]


class MulticutSegmentationWorkflow(WorkflowBase):
    """watershed → graph → features → costs → multicut → write
    (reference workflows.py:203-233)."""

    task_name = "multicut_segmentation_workflow"

    def __init__(
        self,
        tmp_folder,
        config_dir=None,
        max_jobs=None,
        target=None,
        input_path: str = None,       # boundary / affinity map
        input_key: str = None,
        ws_path: str = None,          # watershed volume (created if missing)
        ws_key: str = None,
        output_path: str = None,      # final segmentation
        output_key: str = None,
        mask_path: str = None,
        mask_key: str = None,
        n_scales: int = 1,
        skip_ws: bool = False,
        sharded_problem: bool = False,
        sharded_ws: bool = False,
        sanity_checks: bool = False,
        node_label_dict: Optional[dict] = None,
        dependencies=(),
    ):
        _check_sharded_ws_flags(sharded_ws, sharded_problem)
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.n_scales = n_scales
        self.skip_ws = skip_ws
        self.sanity_checks = sanity_checks
        self.node_label_dict = dict(node_label_dict or {})

    def requires(self):
        dep = list(self.dependencies)
        if not self.skip_ws:
            ws = WatershedTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=dep,
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.ws_path, output_key=self.ws_key,
                mask_path=self.mask_path, mask_key=self.mask_key,
            )
            dep = [ws]
        problem = ProblemWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            ws_path=self.ws_path, ws_key=self.ws_key,
            sanity_checks=self.sanity_checks,
            node_label_dict=self.node_label_dict,
            dependencies=dep,
        )
        mc = MulticutWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.ws_path, input_key=self.ws_key,
            n_scales=self.n_scales, dependencies=[problem],
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[mc],
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, ASSIGNMENTS_NAME),
            identifier="multicut",
        )
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["watershed"] = WatershedTask.default_task_config()
        conf["block_edge_features"] = BlockEdgeFeaturesTask.default_task_config()
        conf["probs_to_costs"] = ProbsToCostsTask.default_task_config()
        return conf


class SubSolutionsWorkflow(WorkflowBase):
    """Hierarchical solve to scale ``n_scales``, then write each block's
    standalone sub-solution for inspection (reference
    multicut_workflow.py:70-100)."""

    task_name = "sub_solutions_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 ws_path=None, ws_key=None,
                 output_path=None, output_key=None,
                 n_scales: int = 0, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_scales = n_scales

    def requires(self):
        dep = _hierarchical_solve_tasks(
            self, self.n_scales, list(self.dependencies),
            self.ws_path, self.ws_key,
        )
        sub = SubSolutionsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=dep, scale=self.n_scales,
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
        )
        return [sub]


class ReducedSolutionWorkflow(WorkflowBase):
    """Hierarchical solve to scale ``n_scales``, then write the *reduced*
    labeling — merged through the reduces but not globally solved — as a
    segmentation (reference multicut_workflow.py:103-128).  At
    ``n_scales=0`` this reproduces the fragments."""

    task_name = "reduced_solution_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 ws_path=None, ws_key=None,
                 output_path=None, output_key=None,
                 n_scales: int = 0, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_scales = n_scales

    def requires(self):
        dep = _hierarchical_solve_tasks(
            self, self.n_scales, list(self.dependencies),
            self.ws_path, self.ws_key,
        )
        assign = ReducedAssignmentsTask(
            self.tmp_folder, self.config_dir,
            dependencies=dep, scale=self.n_scales,
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[assign],
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(
                self.tmp_folder, reduced_assignments_name(self.n_scales)
            ),
            identifier=f"reduced_s{self.n_scales}",
        )
        return [write]
