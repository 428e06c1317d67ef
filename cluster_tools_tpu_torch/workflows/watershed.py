"""Watershed workflow (port of ``cluster_tools_tpu/workflows/watershed.py``):
the default branch, one ``WatershedTask`` — blockwise DT-watershed with
block-id offsets.  The two-pass, agglomeration and sharded branches are not
ported yet and raise."""

from __future__ import annotations

from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.watershed import WatershedTask


class WatershedWorkflow(WorkflowBase):
    task_name = "watershed_workflow"

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        target: Optional[str] = None,
        input_path: str = None,
        input_key: str = None,
        output_path: str = None,
        output_key: str = None,
        mask_path: str = None,
        mask_key: str = None,
        two_pass: bool = False,
        agglomeration: bool = False,
        sharded: bool = False,
        dependencies=(),
    ):
        if two_pass or agglomeration:
            raise NotImplementedError(
                "two_pass / agglomeration watershed are not ported yet "
                "(ROADMAP Queue A 5)"
            )
        if sharded:
            raise NotImplementedError(
                "sharded watershed is not ported yet (ROADMAP Queue A 11)"
            )
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    def requires(self):
        return [WatershedTask(
            self.tmp_folder,
            self.config_dir,
            self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path,
            input_key=self.input_key,
            output_path=self.output_path,
            output_key=self.output_key,
            mask_path=self.mask_path,
            mask_key=self.mask_key,
        )]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["watershed"] = WatershedTask.default_task_config()
        return conf
