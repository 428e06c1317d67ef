"""Postprocessing workflow composites (port of
``cluster_tools_tpu/workflows/postprocessing.py``; reference
postprocess/postprocess_workflow.py:24-412).

Each composite chains the postprocess tasks: derive WHICH segments to
change (size/intensity/orphan/graph criteria) → an assignment or discard
table → apply block-wise (zero out, re-flood, or rewrite with the table).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..runtime.task import SimpleTask
from ..runtime.workflow import WorkflowBase
from ..tasks.postprocess import (
    GRAPH_CC_NAME,
    GRAPH_WS_NAME,
    ORPHANS_NAME,
    SIZE_FILTER_DISCARD_NAME,
    BackgroundSizeFilterTask,
    FillingSizeFilterTask,
    FilterBlocksTask,
    GraphConnectedComponentsTask,
    GraphWatershedAssignmentsTask,
    OrphanAssignmentsTask,
    SizeFilterTask,
)
from ..tasks.region_features import (
    FEATURE_COLUMNS,
    REGION_FEATURES_NAME,
    MergeRegionFeaturesTask,
    RegionFeaturesTask,
)
from ..tasks.write import WriteTask
from .morphology import MorphologyWorkflow
from .multicut import GraphWorkflow
from .relabel import RelabelWorkflow


class SizeFilterWorkflow(WorkflowBase):
    """Remove segments outside [min_size, max_size]
    (reference SizeFilterWorkflow, postprocess_workflow.py:24-105).

    Without a height map the discarded segments map to background
    (``background_size_filter``); with ``hmap_path/key`` their voxels
    re-flood from the surviving neighbors (``filling_size_filter``).
    ``relabel`` appends a consecutive relabeling of the output.
    """

    task_name = "size_filter_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 min_size: int = 0, max_size: Optional[int] = None,
                 hmap_path: str = None, hmap_key: str = None,
                 relabel: bool = False):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.min_size = min_size
        self.max_size = max_size
        self.hmap_path = hmap_path
        self.hmap_key = hmap_key
        self.relabel = relabel

    def requires(self):
        morpho = MorphologyWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
        )
        size_filter = SizeFilterTask(
            self.tmp_folder, self.config_dir, dependencies=[morpho],
            min_size=self.min_size, max_size=self.max_size, relabel=False,
        )
        discard_path = os.path.join(self.tmp_folder, SIZE_FILTER_DISCARD_NAME)
        apply_key = (
            self.output_key + "_unrelabeled" if self.relabel else self.output_key
        )
        if self.hmap_path:
            apply = FillingSizeFilterTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[size_filter],
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=apply_key,
                hmap_path=self.hmap_path, hmap_key=self.hmap_key,
                res_path=discard_path,
            )
        else:
            apply = BackgroundSizeFilterTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[size_filter],
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=apply_key,
                filter_path=discard_path,
            )
        if not self.relabel:
            return [apply]
        return [
            RelabelWorkflow(
                self.tmp_folder, self.config_dir, self.max_jobs, self.target,
                input_path=self.output_path, input_key=apply_key,
                output_path=self.output_path, output_key=self.output_key,
                dependencies=[apply],
            )
        ]

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf.update(MorphologyWorkflow.get_config())
        conf.update(RelabelWorkflow.get_config())
        conf["size_filter"] = SizeFilterTask.default_task_config()
        # both apply variants (hmap selects filling at run time)
        conf["background_size_filter"] = (
            BackgroundSizeFilterTask.default_task_config()
        )
        conf["filling_size_filter"] = FillingSizeFilterTask.default_task_config()
        return conf


class FilterLabelsWorkflow(WorkflowBase):
    """Zero an explicit id list block-wise
    (reference FilterLabelsWorkflow, postprocess_workflow.py:111-158)."""

    task_name = "filter_labels_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 filter_labels: Sequence[int] = ()):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.filter_labels = list(filter_labels)

    def requires(self):
        filter_path = os.path.join(self.tmp_folder, "filter_label_ids.npy")
        save_ids = SaveFilterIdsTask(
            self.tmp_folder, self.config_dir,
            filter_labels=self.filter_labels, out_path=filter_path,
        )
        return [
            FilterBlocksTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[save_ids],
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                filter_path=filter_path,
            )
        ]


class SaveFilterIdsTask(SimpleTask):
    """Materialize an explicit id list for the block-wise filter (kept out of
    ``requires()`` so DAG inspection never mutates disk)."""

    task_name = "save_filter_ids"

    def __init__(self, *args, filter_labels=(), out_path: str = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_labels = list(filter_labels)
        self.out_path = out_path

    def run_impl(self) -> None:
        np.save(self.out_path, np.asarray(self.filter_labels, dtype="uint64"))


class ApplyFeatureThresholdTask(SimpleTask):
    """Ids whose merged region feature crosses a threshold → discard list
    (reference ApplyThreshold, postprocess_workflow.py:160-191)."""

    task_name = "apply_feature_threshold"

    def __init__(self, *args, threshold: float = 0.5,
                 threshold_mode: str = "less", feature: str = "mean",
                 out_path: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        if threshold_mode not in ("less", "greater", "equal"):
            raise ValueError(f"unsupported threshold_mode {threshold_mode!r}")
        if feature not in FEATURE_COLUMNS:
            raise ValueError(f"unknown feature {feature!r}: {FEATURE_COLUMNS}")
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.feature = feature
        self.out_path = out_path

    def run_impl(self) -> None:
        feats = np.load(os.path.join(self.tmp_folder, REGION_FEATURES_NAME))
        col = feats[:, FEATURE_COLUMNS.index(self.feature)]
        present = feats[:, 0] > 0  # count > 0 = id exists
        if self.threshold_mode == "less":
            sel = col < self.threshold
        elif self.threshold_mode == "greater":
            sel = col > self.threshold
        else:
            sel = col == self.threshold
        ids = np.nonzero(sel & present)[0].astype("uint64")
        ids = ids[ids != 0]
        np.save(self.out_path, ids)
        self.log(
            f"feature threshold ({self.feature} {self.threshold_mode} "
            f"{self.threshold}): {ids.size} ids filtered"
        )


class FilterByThresholdWorkflow(WorkflowBase):
    """Filter segments by a region-feature threshold on an intensity map
    (reference FilterByThresholdWorkflow, postprocess_workflow.py:194-245):
    region features → threshold → filter blocks."""

    task_name = "filter_by_threshold_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 seg_path: str = None, seg_key: str = None,
                 output_path: str = None, output_key: str = None,
                 threshold: float = 0.5, threshold_mode: str = "less",
                 feature: str = "mean"):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.seg_path = seg_path
        self.seg_key = seg_key
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.feature = feature

    def requires(self):
        feats = RegionFeaturesTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.seg_path, labels_key=self.seg_key,
        )
        merge = MergeRegionFeaturesTask(
            self.tmp_folder, self.config_dir, dependencies=[feats],
            input_path=self.seg_path, input_key=self.seg_key,
        )
        filter_path = os.path.join(self.tmp_folder, "feature_filter_ids.npy")
        apply_threshold = ApplyFeatureThresholdTask(
            self.tmp_folder, self.config_dir, dependencies=[merge],
            threshold=self.threshold, threshold_mode=self.threshold_mode,
            feature=self.feature, out_path=filter_path,
        )
        return [
            FilterBlocksTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[apply_threshold],
                input_path=self.seg_path, input_key=self.seg_key,
                output_path=self.output_path, output_key=self.output_key,
                filter_path=filter_path,
            )
        ]


class FilterOrphansWorkflow(WorkflowBase):
    """Merge orphaned segments (single graph neighbor) into that neighbor
    (reference FilterOrphansWorkflow, postprocess_workflow.py:248-289):
    graph → orphan assignments → write."""

    task_name = "filter_orphans_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 assignment_path: str = None, relabel: bool = False):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.assignment_path = assignment_path
        self.relabel = relabel

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
        )
        orphans = OrphanAssignmentsTask(
            self.tmp_folder, self.config_dir, dependencies=[graph],
            # None = identity: orphans judged on the raw fragment graph
            assignment_path=self.assignment_path, relabel=self.relabel,
        )
        return [
            WriteTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[orphans],
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                assignment_path=os.path.join(self.tmp_folder, ORPHANS_NAME),
                identifier="orphans",
                table_default="identity",
            )
        ]


class ConnectedComponentsWorkflow(WorkflowBase):
    """Connected components over the segment graph
    (reference ConnectedComponentsWorkflow, postprocess_workflow.py:292-336):
    graph → union-find over (optionally cost-thresholded) edges → write.

    ``threshold`` restricts the merge to edges whose COST exceeds it, which
    requires edge costs in this ``tmp_folder``'s scratch store — run the
    problem pipeline (features → probs_to_costs) there first, like
    ``SizeFilterAndGraphWatershedWorkflow``.  ``threshold=None`` (default)
    needs only the graph."""

    task_name = "connected_components_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 threshold: Optional[float] = None):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.threshold = threshold

    def requires(self):
        graph = GraphWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
        )
        cc = GraphConnectedComponentsTask(
            self.tmp_folder, self.config_dir, dependencies=[graph],
            threshold=self.threshold,
        )
        return [
            WriteTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[cc],
                input_path=self.input_path, input_key=self.input_key,
                output_path=self.output_path, output_key=self.output_key,
                assignment_path=os.path.join(self.tmp_folder, GRAPH_CC_NAME),
                identifier="graph_cc",
                table_default="identity",
            )
        ]


class SizeFilterAndGraphWatershedWorkflow(WorkflowBase):
    """Size filter where discarded fragments re-attach to their
    strongest-connected kept neighbor by edge-weighted graph watershed
    (reference SizeFilterAndGraphWatershedWorkflow,
    postprocess_workflow.py:339-412).

    Must run in the ``tmp_folder`` of a completed problem pipeline (graph +
    edge costs in the scratch store — the reference's ``problem_path``).
    """

    task_name = "size_filter_graph_watershed_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path: str = None, input_key: str = None,
                 output_path: str = None, output_key: str = None,
                 min_size: int = 0, max_size: Optional[int] = None,
                 relabel: bool = False):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.min_size = min_size
        self.max_size = max_size
        self.relabel = relabel

    def requires(self):
        morpho = MorphologyWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
        )
        size_filter = SizeFilterTask(
            self.tmp_folder, self.config_dir, dependencies=[morpho],
            min_size=self.min_size, max_size=self.max_size, relabel=False,
        )
        graph_ws = GraphWatershedAssignmentsTask(
            self.tmp_folder, self.config_dir, dependencies=[size_filter],
            filter_path=os.path.join(self.tmp_folder, SIZE_FILTER_DISCARD_NAME),
        )
        apply_key = (
            self.output_key + "_unrelabeled" if self.relabel else self.output_key
        )
        write = WriteTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            dependencies=[graph_ws],
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=apply_key,
            assignment_path=os.path.join(self.tmp_folder, GRAPH_WS_NAME),
            identifier="graph_ws_filter",
            table_default="identity",
        )
        if not self.relabel:
            return [write]
        return [
            RelabelWorkflow(
                self.tmp_folder, self.config_dir, self.max_jobs, self.target,
                input_path=self.output_path, input_key=apply_key,
                output_path=self.output_path, output_key=self.output_key,
                dependencies=[write],
            )
        ]
