"""Intensity-transformation workflow composite (port of
``cluster_tools_tpu/workflows/transformations.py``; reference
transformations/transformation_workflows.py:7-44)."""

from __future__ import annotations

from ..runtime.workflow import WorkflowBase
from ..tasks.transformations import LinearTransformationTask


class LinearTransformationWorkflow(WorkflowBase):
    """Apply an ``a*x + b`` intensity transform (global or per-z-slice spec
    file).  Omitting ``output_path/output_key`` applies it in place, like the
    reference (transformation_workflows.py:21-24)."""

    task_name = "linear_transformation_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None,
                 transformation=None,
                 output_path=None, output_key=None,
                 mask_path=None, mask_key=None,
                 dependencies=()):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.transformation = transformation
        self.output_path = output_path or input_path
        self.output_key = output_key or input_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    def requires(self):
        linear = LinearTransformationTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            transformation=self.transformation,
            mask_path=self.mask_path, mask_key=self.mask_key,
        )
        return [linear]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["linear"] = LinearTransformationTask.default_task_config()
        return conf
