"""Edge-classifier learning: edge ground truth + random-forest training and
prediction (port of ``cluster_tools_tpu/tasks/learning.py``; reference
learning/{edge_labels,learn_rf}.py + costs/predict.py).

The RF itself stays on the host (scikit-learn, as in the JAX package and the
reference): a small sequential model over per-edge feature rows, with JAX's
settings.  The features it reads come from the edge-feature tasks.  Where
scikit-learn is not installed, ``LearnRFTask`` and
``PredictEdgeProbabilitiesTask`` raise ``ImportError``.

Scratch layout (per dataset tmp_folder; the JAX package's):
  edge_labels.npy   int8 per edge: 1 = GT boundary, 0 = merged, -1 = ignore
  edge_probs.npy    float32 per edge: RF boundary probability
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .base import VolumeSimpleTask, scratch_store_path
from .features import FEATURES_KEY
from .graph import load_graph
from .lifted_features import dense_node_labels
from ..runtime.task import SimpleTask
from ..utils import store

EDGE_LABELS_NAME = "edge_labels.npy"
EDGE_PROBS_NAME = "edge_probs.npy"


class EdgeLabelsTask(VolumeSimpleTask):
    """GT edge labels from node-overlap ground truth: an edge is a true
    boundary iff its endpoint nodes carry different GT labels
    (reference edge_labels.py:19,100-125)."""

    task_name = "edge_labels"

    def __init__(self, *args, node_labels_path: Optional[str] = None,
                 ignore_label_gt: bool = False, **kwargs):
        super().__init__(*args, node_labels_path=node_labels_path,
                         ignore_label_gt=ignore_label_gt, **kwargs)

    def run_impl(self) -> None:
        nodes, edges = load_graph(self.tmp_store())
        gt = dense_node_labels(self, nodes, self.node_labels_path)
        lu = gt[edges[:, 0]]
        lv = gt[edges[:, 1]]
        edge_labels = (lu != lv).astype(np.int8)
        if self.ignore_label_gt:
            edge_labels[(lu == 0) | (lv == 0)] = -1
        np.save(os.path.join(self.tmp_folder, EDGE_LABELS_NAME), edge_labels)
        n_pos = int((edge_labels == 1).sum())
        self.log(
            f"edge labels: {edge_labels.size} edges, {n_pos} boundary, "
            f"{int((edge_labels == -1).sum())} ignored"
        )


class LearnRFTask(SimpleTask):
    """Random-forest training over one or more datasets' edge features
    (reference learn_rf.py:25,100-147)."""

    task_name = "learn_rf"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None,
                 dependencies=(), tmp_folders: Sequence[str] = (),
                 output_path: str = None):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        # one scratch folder per training dataset (each holds its own graph,
        # features and edge labels — the analog of features_dict/labels_dict)
        self.tmp_folders = list(tmp_folders) or [tmp_folder]
        self.output_path = output_path

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"n_trees": 100})
        return conf

    def run_impl(self) -> None:
        from sklearn.ensemble import RandomForestClassifier

        conf = self.get_task_config()
        features, labels = [], []
        for folder in self.tmp_folders:
            feats = store.file_reader(
                scratch_store_path(folder), "r"
            )[FEATURES_KEY][:]
            labs = np.load(os.path.join(folder, EDGE_LABELS_NAME))
            if len(labs) != len(feats):
                raise ValueError(
                    f"{folder}: {len(labs)} labels vs {len(feats)} feature rows"
                )
            keep = labs != -1
            features.append(feats[keep])
            labels.append(labs[keep])
        X = np.concatenate(features, axis=0)
        y = np.concatenate(labels, axis=0)
        self.log(f"learning RF on {X.shape[0]} edges x {X.shape[1]} features")
        rf = RandomForestClassifier(
            n_estimators=int(conf.get("n_trees", 100)),
            n_jobs=int(conf.get("threads_per_job", 1)),
        )
        rf.fit(X, y)
        os.makedirs(os.path.dirname(os.path.abspath(self.output_path)),
                    exist_ok=True)
        with open(self.output_path, "wb") as f:
            pickle.dump(rf, f)


class PredictEdgeProbabilitiesTask(VolumeSimpleTask):
    """RF boundary probability per edge (reference costs/predict.py:23)."""

    task_name = "predict_edge_probabilities"

    def __init__(self, *args, rf_path: str = None, **kwargs):
        super().__init__(*args, rf_path=rf_path, **kwargs)

    def run_impl(self) -> None:
        conf = self.get_task_config()
        with open(self.rf_path, "rb") as f:
            rf = pickle.load(f)
        rf.n_jobs = int(conf.get("threads_per_job", 1))
        feats = self.tmp_store()[FEATURES_KEY][:]
        proba = rf.predict_proba(feats)
        if proba.shape[1] == 1:
            # degenerate RF trained on a single class — constant probability
            p = float(rf.classes_[0])
            self.log(f"WARNING: RF saw a single class ({p}); constant output")
            probs = np.full(feats.shape[0], p, dtype="float32")
        else:
            probs = proba[:, 1].astype("float32")
        np.save(os.path.join(self.tmp_folder, EDGE_PROBS_NAME), probs)
        self.log(f"predicted boundary probabilities for {probs.size} edges")
