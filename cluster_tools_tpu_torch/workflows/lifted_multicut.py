"""Lifted multicut workflows (port of
``cluster_tools_tpu/workflows/lifted_multicut.py``).

Reference lifted_features/lifted_feature_workflow.py:80 and
lifted_multicut/lifted_multicut_workflow.py:11, composed into
LiftedMulticutSegmentationWorkflow (reference workflows.py:235-324):
watershed → graph → features → costs → node labels → lifted neighborhood →
lifted costs → [solve_lifted_subproblems(s) → reduce_lifted_problem(s)]×scales
→ solve_lifted_global → write.

The watershed is the port's ``WatershedTask`` (kernels 1 and 2 on the card in
the default 2d mode); the rest is host numpy, scipy and the native solvers,
as in the JAX package.
"""

from __future__ import annotations

import os

from ..runtime.workflow import WorkflowBase
from ..tasks.costs import ProbsToCostsTask
from ..tasks.lifted_features import (
    ClearLiftedEdgesFromLabelsTask,
    LiftedCostsFromNodeLabelsTask,
    SparseLiftedNeighborhoodTask,
)
from ..tasks.lifted_multicut import (
    LIFTED_ASSIGNMENTS_NAME,
    ReduceLiftedProblemTask,
    SolveLiftedGlobalTask,
    SolveLiftedSubproblemsTask,
)
from ..tasks.node_labels import BlockNodeLabelsTask, MergeNodeLabelsTask
from ..tasks.watershed import WatershedTask
from ..tasks.write import WriteTask
from .multicut import EdgeFeaturesWorkflow, GraphWorkflow


class LiftedFeaturesFromNodeLabelsWorkflow(WorkflowBase):
    """Node-label votes over a prior volume → sparse lifted neighborhood →
    ± lifted costs (reference lifted_feature_workflow.py:80).

    ``ws_path/ws_key`` is the fragment volume (graph nodes), ``labels_path/key``
    the semantic prior volume.
    """

    task_name = "lifted_features_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 ws_path=None, ws_key=None, labels_path=None, labels_key=None,
                 prefix: str = "lifted", ignore_label=None,
                 clear_labels=None, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.prefix = prefix
        self.ignore_label = ignore_label
        self.clear_labels = clear_labels

    def requires(self):
        block_labels = BlockNodeLabelsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.ws_path, input_key=self.ws_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            ignore_label=self.ignore_label,
        )
        merge_labels = MergeNodeLabelsTask(
            self.tmp_folder, self.config_dir, dependencies=[block_labels],
            input_path=self.ws_path, input_key=self.ws_key,
        )
        nh = SparseLiftedNeighborhoodTask(
            self.tmp_folder, self.config_dir, dependencies=[merge_labels],
            prefix=self.prefix,
        )
        costs = LiftedCostsFromNodeLabelsTask(
            self.tmp_folder, self.config_dir, dependencies=[nh],
            prefix=self.prefix,
        )
        if self.clear_labels:
            clear = ClearLiftedEdgesFromLabelsTask(
                self.tmp_folder, self.config_dir, dependencies=[costs],
                prefix=self.prefix, clear_labels=self.clear_labels,
            )
            return [clear]
        return [costs]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["sparse_lifted_neighborhood"] = (
            SparseLiftedNeighborhoodTask.default_task_config()
        )
        conf["costs_from_node_labels"] = (
            LiftedCostsFromNodeLabelsTask.default_task_config()
        )
        return conf


class LiftedMulticutWorkflow(WorkflowBase):
    """Hierarchical lifted multicut solve
    (reference lifted_multicut_workflow.py:11)."""

    task_name = "lifted_multicut_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, n_scales: int = 1,
                 prefix: str = "lifted", dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.n_scales = n_scales
        self.prefix = prefix

    def requires(self):
        dep = list(self.dependencies)
        for scale in range(self.n_scales):
            solve = SolveLiftedSubproblemsTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=dep, scale=scale, prefix=self.prefix,
                input_path=self.input_path, input_key=self.input_key,
            )
            reduce_ = ReduceLiftedProblemTask(
                self.tmp_folder, self.config_dir,
                dependencies=[solve], scale=scale, prefix=self.prefix,
                input_path=self.input_path, input_key=self.input_key,
            )
            dep = [reduce_]
        solve_global = SolveLiftedGlobalTask(
            self.tmp_folder, self.config_dir, dependencies=dep,
            scale=self.n_scales, prefix=self.prefix,
        )
        return [solve_global]


class LiftedMulticutSegmentationWorkflow(WorkflowBase):
    """watershed → problem → lifted features → lifted multicut → write
    (reference workflows.py:235-324)."""

    task_name = "lifted_multicut_segmentation_workflow"

    def __init__(
        self,
        tmp_folder,
        config_dir=None,
        max_jobs=None,
        target=None,
        input_path: str = None,       # boundary / affinity map
        input_key: str = None,
        ws_path: str = None,
        ws_key: str = None,
        labels_path: str = None,      # semantic prior volume for lifted edges
        labels_key: str = None,
        output_path: str = None,
        output_key: str = None,
        mask_path: str = None,
        mask_key: str = None,
        n_scales: int = 1,
        skip_ws: bool = False,
        clear_labels=None,
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.n_scales = n_scales
        self.skip_ws = skip_ws
        self.clear_labels = clear_labels

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
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.ws_path, input_key=self.ws_key,
            dependencies=dep,
        )
        feats = EdgeFeaturesWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.ws_path, labels_key=self.ws_key,
            dependencies=[graph],
        )
        costs = ProbsToCostsTask(
            self.tmp_folder, self.config_dir, dependencies=[feats]
        )
        lifted = LiftedFeaturesFromNodeLabelsWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            ws_path=self.ws_path, ws_key=self.ws_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            clear_labels=self.clear_labels,
            dependencies=[costs],
        )
        lmc = LiftedMulticutWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.ws_path, input_key=self.ws_key,
            n_scales=self.n_scales, dependencies=[lifted],
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[lmc],
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, LIFTED_ASSIGNMENTS_NAME),
            identifier="lifted_multicut",
        )
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["watershed"] = WatershedTask.default_task_config()
        conf["probs_to_costs"] = ProbsToCostsTask.default_task_config()
        conf.update(LiftedFeaturesFromNodeLabelsWorkflow.get_config())
        return conf
