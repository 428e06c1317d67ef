"""The merge hierarchy and its re-cuts (port of
``cluster_tools_tpu/workflows/hier.py``).

``HierarchyWorkflow``: a boundary map in, watershed labels in global ids at
``output_key`` and the hierarchy artifact (``hierarchy_path``, by default
``<output_key>_hierarchy.npz`` beside the labels) out, through blocks →
offsets → faces → build → write.  The blocks task runs as a one-member
fused chain (``hier_blocks``, ``runtime/stream.py``) that covers offsets
and faces: its carry stitches the block faces, and the labels volume is
never read back.  With ``stream_fusion: false`` the five tasks run one
after another, with the same outputs.  ``ResegmentWorkflow``: one re-cut
of a built hierarchy at the ``resegment`` config's threshold.
"""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.stream import FusedChain
from ..runtime.workflow import WorkflowBase
from ..tasks.hier import (
    HIER_ASSIGNMENTS_NAME,
    HIER_OFFSETS_NAME,
    BuildHierarchyTask,
    HierarchyBlocksTask,
    HierarchyFacesTask,
    HierarchyOffsetsTask,
    ResegmentTask,
    default_hierarchy_path,
)
from ..tasks.write import WriteTask


class HierarchyWorkflow(WorkflowBase):
    task_name = "hierarchy_workflow"

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
        hierarchy_path: Optional[str] = None,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.hierarchy_path = hierarchy_path or (
            default_hierarchy_path(output_path, output_key)
            if output_path and output_key else None
        )

    def _tasks(self):
        """The member tasks, one definition for ``requires()`` and
        ``fused_chains()``: the chain must satisfy the status files the
        build runs."""
        blocks_key = self.output_key + "_blocks"
        blocks = HierarchyBlocksTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=blocks_key,
        )
        offsets = HierarchyOffsetsTask(
            self.tmp_folder, self.config_dir, dependencies=[blocks],
            input_path=self.output_path, input_key=blocks_key,
        )
        faces = HierarchyFacesTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[offsets],
            input_path=self.output_path, input_key=blocks_key,
            heights_path=self.input_path, heights_key=self.input_key,
        )
        build = BuildHierarchyTask(
            self.tmp_folder, self.config_dir, dependencies=[faces],
            input_path=self.output_path, input_key=blocks_key,
            hierarchy_path=self.hierarchy_path,
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[build],
            input_path=self.output_path, input_key=blocks_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=os.path.join(self.tmp_folder, HIER_ASSIGNMENTS_NAME),
            offsets_path=os.path.join(self.tmp_folder, HIER_OFFSETS_NAME),
            identifier="hierarchy",
        )
        return blocks, offsets, faces, build, write

    def requires(self):
        return [self._tasks()[-1]]

    def fused_chains(self):
        blocks, offsets, faces, _, _ = self._tasks()
        return [FusedChain(name="hier_blocks", members=[blocks], covers=[offsets, faces])]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["hierarchy_blocks"] = HierarchyBlocksTask.default_task_config()
        conf["hierarchy_faces"] = HierarchyFacesTask.default_task_config()
        conf["write"] = WriteTask.default_task_config()
        return conf


class ResegmentWorkflow(WorkflowBase):
    task_name = "resegment_workflow"

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        target: Optional[str] = None,
        labels_path: str = None,
        labels_key: str = None,
        output_path: str = None,
        output_key: str = None,
        hierarchy_path: Optional[str] = None,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.hierarchy_path = hierarchy_path or (
            default_hierarchy_path(labels_path, labels_key)
            if labels_path and labels_key else None
        )

    def requires(self):
        return [
            ResegmentTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                input_path=self.labels_path, input_key=self.labels_key,
                output_path=self.output_path, output_key=self.output_key,
                hierarchy_path=self.hierarchy_path,
            )
        ]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["resegment"] = ResegmentTask.default_task_config()
        return conf
