"""Watershed workflow (port of ``cluster_tools_tpu/workflows/watershed.py``):
blockwise DT-watershed with block-id offsets (``WatershedTask``); or the
checkerboard two-pass watershed, whose labels continue across block faces
(``two_pass``: ``TwoPassWatershedTask`` pass 0, then pass 1); or the
blockwise watershed into ``<output_key>_frag`` followed by a per-block
agglomeration of its fragments (``agglomeration``: ``AgglomerateTask``).
The sharded branch is not ported yet and raises."""

from __future__ import annotations

from typing import Optional

from ..runtime.workflow import WorkflowBase
from ..tasks.watershed import AgglomerateTask, TwoPassWatershedTask, WatershedTask


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
        self.two_pass = two_pass
        self.agglomeration = agglomeration

    def requires(self):
        kwargs = dict(
            input_path=self.input_path,
            input_key=self.input_key,
            output_path=self.output_path,
            output_key=self.output_key,
            mask_path=self.mask_path,
            mask_key=self.mask_key,
        )
        common = (self.tmp_folder, self.config_dir, self.max_jobs)
        if self.two_pass:
            pass0 = TwoPassWatershedTask(
                *common, dependencies=list(self.dependencies), pass_id=0, **kwargs
            )
            return [TwoPassWatershedTask(*common, dependencies=[pass0], pass_id=1, **kwargs)]
        if self.agglomeration:
            # the fragments live under their own key, so a resumed
            # agglomeration never reads blocks it already merged
            frag_key = self.output_key + "_frag"
            ws = WatershedTask(
                *common, dependencies=list(self.dependencies),
                **{**kwargs, "output_key": frag_key},
            )
            return [AgglomerateTask(
                *common, dependencies=[ws],
                input_path=self.input_path, input_key=self.input_key,
                labels_path=self.output_path, labels_key=frag_key,
                output_path=self.output_path, output_key=self.output_key,
            )]
        return [WatershedTask(*common, dependencies=list(self.dependencies), **kwargs)]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["watershed"] = WatershedTask.default_task_config()
        conf["two_pass_watershed"] = TwoPassWatershedTask.default_task_config()
        conf["agglomerate"] = AgglomerateTask.default_task_config()
        return conf
