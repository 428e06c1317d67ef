"""Morphology workflows (port of ``cluster_tools_tpu/workflows/morphology.py``):
per-block morphology partials → merged per-segment table, and the
region-centres table built on top of it."""

from __future__ import annotations

from ..runtime.workflow import WorkflowBase
from ..tasks.morphology import (
    BlockMorphologyTask,
    MergeMorphologyTask,
    RegionCentersTask,
)


class MorphologyWorkflow(WorkflowBase):
    task_name = "morphology_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key

    def requires(self):
        block = BlockMorphologyTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
        )
        merge = MergeMorphologyTask(
            self.tmp_folder, self.config_dir, dependencies=[block],
            input_path=self.input_path, input_key=self.input_key,
        )
        return [merge]


class RegionCentersWorkflow(WorkflowBase):
    """morphology → region_centers (reference morphology_workflow.py:59-95):
    per-segment representative interior points as a (n_labels, 3) table."""

    task_name = "region_centers_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 ignore_label=None, resolution=(1, 1, 1), dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.ignore_label = ignore_label
        self.resolution = list(resolution)

    def requires(self):
        morpho = MorphologyWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
            dependencies=list(self.dependencies),
        )
        centers = RegionCentersTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[morpho],
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            ignore_label=self.ignore_label, resolution=self.resolution,
        )
        return [centers]
