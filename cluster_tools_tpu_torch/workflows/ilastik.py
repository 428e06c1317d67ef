"""ilastik workflows: block-parallel headless prediction and the carving
project export (port of ``cluster_tools_tpu/workflows/ilastik.py``; reference
ilastik/ilastik_workflow.py:16,73).  The carving export runs over the port's
graph and edge-feature workflows."""

from __future__ import annotations

from typing import Sequence

from ..tasks.ilastik import (
    IlastikPredictionTask,
    MergePredictionsTask,
    WriteCarvingTask,
)
from ..runtime.workflow import WorkflowBase
from .multicut import EdgeFeaturesWorkflow, GraphWorkflow


class IlastikPredictionWorkflow(WorkflowBase):
    """prediction → merge (reference ilastik_workflow.py:16-70)."""

    task_name = "ilastik_prediction_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, output_path=None,
                 output_key=None, ilastik_folder=None, ilastik_project=None,
                 halo: Sequence[int] = (0, 0, 0), n_channels: int = 1,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.ilastik_folder = ilastik_folder
        self.ilastik_project = ilastik_project
        self.halo = list(halo)
        self.n_channels = int(n_channels)

    def requires(self):
        predict = IlastikPredictionTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            ilastik_folder=self.ilastik_folder,
            ilastik_project=self.ilastik_project, halo=self.halo,
        )
        merge = MergePredictionsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[predict],
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            tmp_prefix=predict.output_prefix, halo=self.halo,
            n_channels=self.n_channels,
        )
        return [merge]


class IlastikCarvingWorkflow(WorkflowBase):
    """watershed RAG + features → carving .ilp
    (reference ilastik_workflow.py:73-142)."""

    task_name = "ilastik_carving_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, watershed_path=None,
                 watershed_key=None, output_path=None, copy_inputs=False,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.watershed_path = watershed_path
        self.watershed_key = watershed_key
        self.output_path = output_path
        self.copy_inputs = copy_inputs

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.watershed_path, input_key=self.watershed_key,
            dependencies=list(self.dependencies),
        )
        feats = EdgeFeaturesWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.watershed_path, labels_key=self.watershed_key,
            dependencies=[graph],
        )
        carving = WriteCarvingTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[feats],
            output_path=self.output_path,
            raw_path=self.input_path, raw_key=self.input_key,
            copy_inputs=self.copy_inputs,
        )
        return [carving]
