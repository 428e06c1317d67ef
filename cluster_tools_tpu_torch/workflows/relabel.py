"""Relabel workflows (port of ``cluster_tools_tpu/workflows/relabel.py``):
find_uniques → find_labeling → write, and find_uniques → merge_uniques."""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.relabel import (
    LABELING_NAME,
    FindLabelingTask,
    FindUniquesTask,
    MergeUniquesTask,
)
from ..tasks.write import WriteTask


class UniqueWorkflow(WorkflowBase):
    """find_uniques → merge_uniques: materialize the sorted unique-id set of a
    label volume (reference relabel_workflow.py:76)."""

    task_name = "unique_workflow"

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
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key

    def requires(self):
        uniques = FindUniquesTask(
            self.tmp_folder,
            self.config_dir,
            self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path,
            input_key=self.input_key,
        )
        merge = MergeUniquesTask(
            self.tmp_folder,
            self.config_dir,
            dependencies=[uniques],
            input_path=self.input_path,
            input_key=self.input_key,
            output_path=self.output_path,
            output_key=self.output_key,
        )
        return [merge]


class RelabelWorkflow(WorkflowBase):
    task_name = "relabel_workflow"

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
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key

    def requires(self):
        uniques = FindUniquesTask(
            self.tmp_folder,
            self.config_dir,
            self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path,
            input_key=self.input_key,
        )
        labeling = FindLabelingTask(
            self.tmp_folder,
            self.config_dir,
            dependencies=[uniques],
            input_path=self.input_path,
            input_key=self.input_key,
        )
        write = WriteTask(
            self.tmp_folder,
            self.config_dir,
            self.max_jobs,
            dependencies=[labeling],
            input_path=self.input_path,
            input_key=self.input_key,
            output_path=self.output_path,
            output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, LABELING_NAME),
            identifier="relabel",
        )
        return [write]
