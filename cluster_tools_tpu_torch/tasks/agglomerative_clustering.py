"""Global agglomerative clustering of the extracted graph problem (port of
``cluster_tools_tpu/tasks/agglomerative_clustering.py``): one host task
that loads the merged graph and edge features from the scratch store and
merges nodes below a threshold on their mean boundary evidence (mala
clustering semantics, the native solver), writing the node → segment table
the write task applies."""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np

from ..ops.multicut import agglomerative_clustering
from .base import VolumeSimpleTask
from .features import FEATURES_KEY
from .graph import load_graph

AGGLO_ASSIGNMENTS_NAME = "agglomerative_clustering_assignments.npy"


class AgglomerativeClusteringTask(VolumeSimpleTask):
    task_name = "agglomerative_clustering"

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"threshold": 0.9})
        return conf

    def run_impl(self) -> None:
        config = self.get_task_config()
        t0 = time.perf_counter()
        scratch = self.tmp_store()
        nodes, edges = load_graph(scratch)
        feats = scratch[FEATURES_KEY][:]
        t1 = time.perf_counter()
        self.record_timing("load", 0, t1 - t0)
        clusters = agglomerative_clustering(
            int(nodes.size),
            edges,
            feats[:, 0],  # mean boundary evidence per edge
            float(config.get("threshold", 0.9)),
            edge_sizes=feats[:, -1],  # face size, the last column
        )
        self.record_timing("cluster", 0, time.perf_counter() - t1)
        # segments 1-based; the background node 0 stays 0
        table = np.stack([nodes, (clusters + 1).astype(np.uint64)], axis=1).astype(np.uint64)
        if nodes.size and nodes[0] == 0:
            table[0, 1] = 0
        np.save(os.path.join(self.tmp_folder, AGGLO_ASSIGNMENTS_NAME), table)
        self.log(
            f"clustered {nodes.size} nodes / {edges.shape[0]} edges → "
            f"{int(clusters.max()) + 1 if clusters.size else 0} segments"
        )
