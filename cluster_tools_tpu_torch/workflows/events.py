"""Event building over a frame stream (port of
``cluster_tools_tpu/workflows/events.py``): one ``EventBuildingTask`` run,
an ``(n_frames, h, w)`` stack in, a per-frame labels volume and ragged
per-block event tables out."""

from __future__ import annotations

from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.events import EventBuildingTask


class EventBuildingWorkflow(WorkflowBase):
    task_name = "events_workflow"

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
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key

    def requires(self):
        return [
            EventBuildingTask(
                self.tmp_folder,
                self.config_dir,
                self.max_jobs,
                input_path=self.input_path,
                input_key=self.input_key,
                output_path=self.output_path,
                output_key=self.output_key,
            )
        ]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["events"] = EventBuildingTask.default_task_config()
        return conf
