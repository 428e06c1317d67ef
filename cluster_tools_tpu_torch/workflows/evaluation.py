"""Evaluation workflow (port of ``cluster_tools_tpu/workflows/evaluation.py``;
reference evaluation_workflow.py:10-47):
per-block overlaps between segmentation and ground truth → merged contingency
→ Rand/VoI measures JSON."""

from __future__ import annotations

from ..runtime.workflow import WorkflowBase
from ..tasks.evaluation import MeasuresTask
from ..tasks.node_labels import BlockNodeLabelsTask, MergeNodeLabelsTask


class EvaluationWorkflow(WorkflowBase):
    task_name = "evaluation_workflow"

    def __init__(
        self,
        tmp_folder,
        config_dir=None,
        max_jobs=None,
        target=None,
        seg_path: str = None,
        seg_key: str = None,
        gt_path: str = None,
        gt_key: str = None,
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.seg_path = seg_path
        self.seg_key = seg_key
        self.gt_path = gt_path
        self.gt_key = gt_key

    def requires(self):
        overlaps = BlockNodeLabelsTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=list(self.dependencies),
            input_path=self.seg_path, input_key=self.seg_key,
            labels_path=self.gt_path, labels_key=self.gt_key,
        )
        merge = MergeNodeLabelsTask(
            self.tmp_folder, self.config_dir,
            dependencies=[overlaps],
            input_path=self.seg_path, input_key=self.seg_key,
        )
        measures = MeasuresTask(
            self.tmp_folder, self.config_dir, dependencies=[merge]
        )
        return [measures]
