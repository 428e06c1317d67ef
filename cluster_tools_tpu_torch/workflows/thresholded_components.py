"""Distributed thresholded connected components workflows (port of
``cluster_tools_tpu/workflows/thresholded_components.py``):
``ThresholdedComponentsWorkflow`` (default branch: block CC → offsets →
faces → union-find → write; the sharded branch, one collective task over
several cards, is not ported yet and raises) and
``ThresholdAndWatershedWorkflow`` (those components as global seeds of a
watershed over the boundary map)."""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.thresholded_components import (
    ASSIGNMENTS_NAME,
    OFFSETS_NAME,
    BlockComponentsTask,
    BlockFacesTask,
    MergeAssignmentsTask,
    MergeOffsetsTask,
)
from ..tasks.write import WriteTask


class ThresholdedComponentsWorkflow(WorkflowBase):
    """threshold → block CC → offsets → faces → union-find → write."""

    task_name = "thresholded_components_workflow"

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
        sharded: bool = False,
    ):
        if sharded:
            raise NotImplementedError(
                "sharded thresholded components are not ported yet (ROADMAP Queue A 11)"
            )
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    def requires(self):
        blocks_key = self.output_key + "_blocks"
        components = BlockComponentsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=blocks_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
        )
        offsets = MergeOffsetsTask(
            self.tmp_folder, self.config_dir, dependencies=[components],
            input_path=self.input_path, input_key=self.input_key,
        )
        faces = BlockFacesTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[offsets],
            input_path=self.output_path, input_key=blocks_key,
        )
        assignments = MergeAssignmentsTask(
            self.tmp_folder, self.config_dir, dependencies=[faces],
            input_path=self.input_path, input_key=self.input_key,
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[assignments],
            input_path=self.output_path, input_key=blocks_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, ASSIGNMENTS_NAME),
            offsets_path=os.path.join(self.tmp_folder, OFFSETS_NAME),
            identifier="thresholded_components",
        )
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["block_components"] = BlockComponentsTask.default_task_config()
        conf["write"] = WriteTask.default_task_config()
        return conf


class ThresholdAndWatershedWorkflow(WorkflowBase):
    """Thresholded components written to ``output_key + "_seeds"``, used as
    global seeds of a watershed over the full boundary map
    (``WatershedFromSeedsTask``)."""

    task_name = "threshold_and_watershed_workflow"

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
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    def requires(self):
        from ..tasks.watershed import WatershedFromSeedsTask

        seeds_key = self.output_key + "_seeds"
        components = ThresholdedComponentsWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=seeds_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
        )
        ws = WatershedFromSeedsTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[components],
            input_path=self.input_path, input_key=self.input_key,
            seeds_path=self.output_path, seeds_key=seeds_key,
            output_path=self.output_path, output_key=self.output_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
        )
        return [ws]

    @classmethod
    def get_config(cls):
        from ..tasks.watershed import WatershedFromSeedsTask

        conf = ThresholdedComponentsWorkflow.get_config()
        conf["watershed_from_seeds"] = WatershedFromSeedsTask.default_task_config()
        return conf
