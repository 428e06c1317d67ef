"""Sanity-check workflows (port of ``cluster_tools_tpu/workflows/debugging.py``;
reference debugging/check_sub_graphs_workflow.py:10, check_ws_workflow.py:13)."""

from __future__ import annotations

from ..runtime.workflow import WorkflowBase
from ..tasks.debugging import CheckComponentsTask, CheckSubGraphsTask
from .multicut import GraphWorkflow


class CheckSubGraphsWorkflow(WorkflowBase):
    """Extract the graph, then verify every block's serialized node set
    against a recompute."""

    task_name = "check_sub_graphs_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 ws_path=None, ws_key=None, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.ws_path = ws_path
        self.ws_key = ws_key

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.ws_path, input_key=self.ws_key,
            dependencies=list(self.dependencies),
        )
        check = CheckSubGraphsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[graph],
            input_path=self.ws_path, input_key=self.ws_key,
        )
        return [check]


class CheckComponentsWorkflow(WorkflowBase):
    """Fragmentation sanity check over a segmentation."""

    task_name = "check_components_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None,
                 max_blocks_per_label: int = 8, dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.max_blocks_per_label = max_blocks_per_label

    def requires(self):
        check = CheckComponentsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            max_blocks_per_label=self.max_blocks_per_label,
        )
        return [check]
