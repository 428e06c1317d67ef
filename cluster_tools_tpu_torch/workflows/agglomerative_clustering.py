"""Agglomerative clustering segmentation workflow (port of
``cluster_tools_tpu/workflows/agglomerative_clustering.py``): graph → edge
features → global threshold clustering → write, over an existing
watershed.  Run in the tmp folder of an earlier multicut workflow over the
same watershed, its graph and feature tasks are complete and skipped."""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask
from ..tasks.write import WriteTask
from .multicut import EdgeFeaturesWorkflow, GraphWorkflow


class AgglomerativeClusteringWorkflow(WorkflowBase):
    task_name = "agglomerative_clustering_workflow"

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        target: Optional[str] = None,
        input_path: str = None,  # boundary map
        input_key: str = None,
        ws_path: str = None,  # the watershed fragments
        ws_key: str = None,
        output_path: str = None,
        output_key: str = None,
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.ws_path, input_key=self.ws_key,
            dependencies=list(self.dependencies),
        )
        feats = EdgeFeaturesWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.ws_path, labels_key=self.ws_key,
            dependencies=[graph],
        )
        cluster = AgglomerativeClusteringTask(self.tmp_folder, self.config_dir, dependencies=[feats])
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[cluster],
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, AGGLO_ASSIGNMENTS_NAME),
            identifier="agglomerative_clustering",
        )
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["agglomerative_clustering"] = AgglomerativeClusteringTask.default_task_config()
        return conf
