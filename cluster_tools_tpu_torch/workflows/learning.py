"""Random-forest learning workflow (port of
``cluster_tools_tpu/workflows/learning.py``; reference
learning/learning_workflow.py:13).

Per training dataset: RAG extraction → edge features → GT node overlap votes →
edge labels; then one RF trained over all datasets' (features, labels)."""

from __future__ import annotations

import os
from typing import Dict, Tuple

from ..runtime.workflow import WorkflowBase
from ..tasks.learning import EdgeLabelsTask, LearnRFTask
from ..tasks.node_labels import BlockNodeLabelsTask, MergeNodeLabelsTask
from .multicut import EdgeFeaturesWorkflow, GraphWorkflow


class LearningWorkflow(WorkflowBase):
    task_name = "learning_workflow"

    def __init__(
        self,
        tmp_folder,
        config_dir=None,
        max_jobs=None,
        target=None,
        input_dict: Dict[str, Tuple[str, str]] = None,
        labels_dict: Dict[str, Tuple[str, str]] = None,
        groundtruth_dict: Dict[str, Tuple[str, str]] = None,
        output_path: str = None,
        ignore_label_gt: bool = False,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_dict = dict(input_dict or {})        # boundary maps
        self.labels_dict = dict(labels_dict or {})      # watershed labels
        self.groundtruth_dict = dict(groundtruth_dict or {})
        if not (
            self.input_dict.keys()
            == self.labels_dict.keys()
            == self.groundtruth_dict.keys()
        ):
            raise ValueError("input/labels/groundtruth keys must match")
        self.output_path = output_path
        self.ignore_label_gt = ignore_label_gt

    def requires(self):
        tasks = []
        folders = []
        for key, (input_path, input_key) in self.input_dict.items():
            labels_path, labels_key = self.labels_dict[key]
            gt_path, gt_key = self.groundtruth_dict[key]
            tmp_folder = os.path.join(self.tmp_folder, key)
            folders.append(tmp_folder)

            graph = GraphWorkflow(
                tmp_folder, self.config_dir, self.max_jobs, self.target,
                input_path=labels_path, input_key=labels_key,
            )
            feats = EdgeFeaturesWorkflow(
                tmp_folder, self.config_dir, self.max_jobs, self.target,
                input_path=input_path, input_key=input_key,
                labels_path=labels_path, labels_key=labels_key,
                dependencies=[graph],
            )
            overlaps = BlockNodeLabelsTask(
                tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[graph],
                input_path=labels_path, input_key=labels_key,
                labels_path=gt_path, labels_key=gt_key,
            )
            merge_labels = MergeNodeLabelsTask(
                tmp_folder, self.config_dir,
                dependencies=[overlaps],
                input_path=labels_path, input_key=labels_key,
            )
            edge_labels = EdgeLabelsTask(
                tmp_folder, self.config_dir,
                dependencies=[feats, merge_labels],
                ignore_label_gt=self.ignore_label_gt,
            )
            tasks.append(edge_labels)
        learn = LearnRFTask(
            self.tmp_folder, self.config_dir,
            dependencies=tasks,
            tmp_folders=folders,
            output_path=self.output_path,
        )
        return [learn]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["learn_rf"] = LearnRFTask.default_task_config()
        conf["edge_labels"] = EdgeLabelsTask.default_task_config()
        return conf
