"""Skeleton / mesh / distance workflows, all gated on the morphology table
(port of ``cluster_tools_tpu/workflows/skeletons.py``; reference
skeletons/skeleton_workflow.py:10, distances/distance_workflow.py:35,
meshes are task-only in the reference but get the same morphology chaining)."""

from __future__ import annotations

from ..runtime.workflow import WorkflowBase
from ..tasks.distances import MergeObjectDistancesTask, ObjectDistancesTask
from ..tasks.meshes import ComputeMeshesTask
from ..tasks.morphology import BlockMorphologyTask, MergeMorphologyTask
from ..tasks.skeletons import SkeletonEvaluationTask, SkeletonizeTask


class _MorphologyGated(WorkflowBase):
    """Shared head: compute the morphology table of the segmentation."""

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, **kwargs):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _morphology_tasks(self):
        block = BlockMorphologyTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
        )
        merge = MergeMorphologyTask(
            self.tmp_folder, self.config_dir, dependencies=[block],
            input_path=self.input_path, input_key=self.input_key,
        )
        return merge


class SkeletonWorkflow(_MorphologyGated):
    task_name = "skeleton_workflow"

    def requires(self):
        morpho = self._morphology_tasks()
        skel = SkeletonizeTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[morpho],
            input_path=self.input_path, input_key=self.input_key,
        )
        return [skel]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["skeletonize"] = SkeletonizeTask.default_task_config()
        return conf


class SkeletonEvaluationWorkflow(_MorphologyGated):
    """Skeletonize + evaluate against a segmentation
    (reference skeleton_workflow.py + skeleton_evaluation.py chain)."""

    task_name = "skeleton_evaluation_workflow"

    def __init__(self, *args, seg_path=None, seg_key=None, **kwargs):
        super().__init__(*args, seg_path=seg_path, seg_key=seg_key, **kwargs)

    def requires(self):
        morpho = self._morphology_tasks()
        skel = SkeletonizeTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[morpho],
            input_path=self.input_path, input_key=self.input_key,
        )
        ev = SkeletonEvaluationTask(
            self.tmp_folder, self.config_dir, dependencies=[skel],
            seg_path=self.seg_path, seg_key=self.seg_key,
        )
        return [ev]


class DistanceWorkflow(_MorphologyGated):
    task_name = "distance_workflow"

    def requires(self):
        morpho = self._morphology_tasks()
        dist = ObjectDistancesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[morpho],
            input_path=self.input_path, input_key=self.input_key,
        )
        merge = MergeObjectDistancesTask(
            self.tmp_folder, self.config_dir, dependencies=[dist],
        )
        return [merge]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["object_distances"] = ObjectDistancesTask.default_task_config()
        return conf


class MeshWorkflow(_MorphologyGated):
    task_name = "mesh_workflow"

    def __init__(self, *args, output_dir=None, **kwargs):
        super().__init__(*args, output_dir=output_dir, **kwargs)

    def requires(self):
        morpho = self._morphology_tasks()
        meshes = ComputeMeshesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[morpho],
            input_path=self.input_path, input_key=self.input_key,
            output_dir=self.output_dir,
        )
        return [meshes]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["compute_meshes"] = ComputeMeshesTask.default_task_config()
        return conf
