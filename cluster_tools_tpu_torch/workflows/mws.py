"""Mutex watershed workflows (port of ``cluster_tools_tpu/workflows/mws.py``):
blockwise MWS → face stitching → write, and the two-pass MWS."""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.mws import MwsBlocksTask, TwoPassMwsTask
from ..tasks.stitching import STITCH_ASSIGNMENTS_NAME, StitchAssignmentsTask, StitchFacesTask
from ..tasks.write import WriteTask


class MwsWorkflow(WorkflowBase):
    """``MwsBlocksTask`` into ``<output_key>_blocks``, then the face votes,
    their union-find table and the write of the table into
    ``output_key`` (ids in no vote pass through).  ``stitch=False`` writes
    the blocks' labels into ``output_key`` and stops there."""

    task_name = "mws_workflow"

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        target: Optional[str] = None,
        input_path: str = None,  # affinities [C, z, y, x]
        input_key: str = None,
        output_path: str = None,
        output_key: str = None,
        mask_path: str = None,
        mask_key: str = None,
        stitch: bool = True,
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.stitch = stitch

    def requires(self):
        blocks_key = self.output_key + ("_blocks" if self.stitch else "")
        mws = MwsBlocksTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=blocks_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
        )
        if not self.stitch:
            return [mws]
        faces = StitchFacesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[mws],
            input_path=self.output_path, input_key=blocks_key,
        )
        assignments = StitchAssignmentsTask(
            self.tmp_folder, self.config_dir,
            dependencies=[faces],
            input_path=self.output_path, input_key=blocks_key,
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[assignments],
            input_path=self.output_path, input_key=blocks_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, STITCH_ASSIGNMENTS_NAME),
            identifier="mws_stitch",
            table_default="identity",
        )
        return [write]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["mws_blocks"] = MwsBlocksTask.default_task_config()
        conf["stitch_faces"] = StitchFacesTask.default_task_config()
        conf["write"] = WriteTask.default_task_config()
        return conf


class TwoPassMwsWorkflow(WorkflowBase):
    """Two-pass mutex watershed: checkerboard pass 0, then pass 1 seeded by
    the labels its face neighbours wrote — consistent ids without a
    stitching step."""

    task_name = "two_pass_mws_workflow"

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
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    def requires(self):
        pass0 = TwoPassMwsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
            pass_id=0,
        )
        pass1 = TwoPassMwsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[pass0],
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.output_key,
            mask_path=self.mask_path, mask_key=self.mask_key,
            pass_id=1,
        )
        return [pass1]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["two_pass_mws"] = TwoPassMwsTask.default_task_config()
        return conf
