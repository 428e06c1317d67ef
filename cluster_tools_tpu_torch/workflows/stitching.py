"""Stitching workflows for block-wise segmentations (port of
``cluster_tools_tpu/workflows/stitching.py``; reference workflows.py:360 SimpleStitchingWorkflow, :388
MulticutStitchingWorkflow, stitching/stitching_workflows.py)."""

from __future__ import annotations

import os

from ..runtime.workflow import WorkflowBase
from ..tasks.stitching import (
    SIMPLE_STITCH_NAME,
    STITCH_MC_NAME,
    SimpleStitchAssignmentsTask,
    SimpleStitchEdgesTask,
    StitchingMulticutTask,
)
from ..tasks.write import WriteTask
from .multicut import EdgeFeaturesWorkflow, GraphWorkflow


class _StitchingBase(WorkflowBase):
    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, labels_path=None,
                 labels_key=None, output_path=None, output_key=None,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        # input = boundary/affinity map (multicut variant); labels = the
        # block-wise segmentation to stitch
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key

    def _graph(self):
        return GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.labels_path, input_key=self.labels_key,
            dependencies=list(self.dependencies),
        )

    def _edges(self, dep):
        return SimpleStitchEdgesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[dep],
            input_path=self.labels_path, input_key=self.labels_key,
        )

    def _write(self, dep, assignment_name):
        return WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[dep],
            input_path=self.labels_path, input_key=self.labels_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, assignment_name),
            identifier="stitching",
        )


class SimpleStitchingWorkflow(_StitchingBase):
    """Merge every boundary-crossing edge (reference workflows.py:360)."""

    task_name = "simple_stitching_workflow"

    def __init__(self, *args, edge_size_threshold: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.edge_size_threshold = edge_size_threshold

    def requires(self):
        graph = self._graph()
        edges = self._edges(graph)
        assignments = SimpleStitchAssignmentsTask(
            self.tmp_folder, self.config_dir,
            dependencies=[edges],
            input_path=self.labels_path, input_key=self.labels_key,
            edge_size_threshold=self.edge_size_threshold,
        )
        write = self._write(assignments, SIMPLE_STITCH_NAME)
        return [write]


class MulticutStitchingWorkflow(_StitchingBase):
    """Two-beta multicut over boundary vs inner edges
    (reference workflows.py:388)."""

    task_name = "multicut_stitching_workflow"

    def requires(self):
        graph = self._graph()
        feats = EdgeFeaturesWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            dependencies=[graph],
        )
        edges = self._edges(feats)
        mc = StitchingMulticutTask(
            self.tmp_folder, self.config_dir,
            dependencies=[edges],
            input_path=self.labels_path, input_key=self.labels_key,
        )
        write = self._write(mc, STITCH_MC_NAME)
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["stitching_multicut"] = StitchingMulticutTask.default_task_config()
        return conf
