"""One streaming pass over the raw volume (port of
``cluster_tools_tpu/workflows/streaming.py``).

``StreamingSegmentationWorkflow`` wires threshold → block CC → merge
offsets → block faces → union-find → write, and the DT-watershed of the
same raw volume, and declares a fused chain over the split-protocol
members (``runtime/stream.py``):

  * the raw volume is read once per batch, at the watershed's halo; the
    threshold's and the components' reads are crops of that host buffer;
  * the threshold mask is elided: it goes from threshold to components as
    a tensor on the device and never exists in the store;
  * the components' labels are written (the write step reads them), but
    their re-reads are covered by carried state: the per-block max ids
    become the offsets npz and the face pairs the block-faces chunks, so
    ``MergeOffsetsTask`` and ``BlockFacesTask`` are stamped complete
    without reading a voxel.

With ``stream_fusion: false`` (or ``CTT_STREAM_FUSION=0``) the same tasks
run one at a time, every intermediate written; the outputs are the same
bytes either way.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..runtime.stream import FusedChain
from ..runtime.workflow import WorkflowBase
from ..tasks.threshold import ThresholdTask
from ..tasks.thresholded_components import (
    ASSIGNMENTS_NAME,
    OFFSETS_NAME,
    BlockComponentsTask,
    BlockFacesTask,
    MergeAssignmentsTask,
    MergeOffsetsTask,
)
from ..tasks.watershed import WatershedTask
from ..tasks.write import WriteTask


class StreamingSegmentationWorkflow(WorkflowBase):
    """Fused threshold → components → watershed.  Outputs: the merged
    components at ``output_key`` and, with ``watershed=True``, the
    watershed fragments at ``ws_key`` (default ``output_key + "_ws"``)."""

    task_name = "streaming_segmentation_workflow"

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
        ws_key: Optional[str] = None,
        mask_path: str = None,
        mask_key: str = None,
        watershed: bool = True,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.ws_key = ws_key or (output_key + "_ws" if output_key else None)
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.watershed = watershed

    def _tasks(self):
        """The member tasks, one definition for ``requires()`` and
        ``fused_chains()``: the chain must satisfy the status files the
        build runs."""
        mask_key = self.output_key + "_mask"
        blocks_key = self.output_key + "_blocks"
        threshold = ThresholdTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=mask_key,
        )
        components = BlockComponentsTask(
            self.tmp_folder, self.config_dir, self.max_jobs, dependencies=[threshold],
            input_path=self.output_path, input_key=mask_key,
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
            identifier="streaming_components",
        )
        ws = None
        if self.watershed:
            ws = WatershedTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.ws_key,
                mask_path=self.mask_path, mask_key=self.mask_key,
            )
        return threshold, components, offsets, faces, write, ws

    def requires(self):
        *_, write, ws = self._tasks()
        roots: List = [write]
        if ws is not None:
            roots.append(ws)
        return roots

    def fused_chains(self):
        threshold, components, offsets, faces, _, ws = self._tasks()
        members = [threshold, components] + ([ws] if ws is not None else [])
        return [FusedChain(name="stream_tcw", members=members, elide={threshold.identifier},
                           covers=[offsets, faces])]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["threshold"] = ThresholdTask.default_task_config()
        conf["block_components"] = BlockComponentsTask.default_task_config()
        conf["watershed"] = WatershedTask.default_task_config()
        conf["write"] = WriteTask.default_task_config()
        return conf
