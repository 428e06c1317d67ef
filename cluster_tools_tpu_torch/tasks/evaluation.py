"""Distributed evaluation: Rand / VoI vs ground truth (port of
``cluster_tools_tpu/tasks/evaluation.py``, host numpy as there).

Reference evaluation/{measures,object_vi}.py (SURVEY.md §2.7) — the parity
metric of BASELINE.md.  Pipeline: per-block contingency (block_node_labels
machinery) → merged table → metric computation.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from ..ops.evaluation import object_vi_from_contingency, rand_scores, vi_scores
from .base import VolumeSimpleTask
from .node_labels import OVERLAPS_MERGED_NAME

MEASURES_NAME = "evaluation_measures.json"
OBJECT_VI_NAME = "object_vi.json"


class MeasuresTask(VolumeSimpleTask):
    """RI / adapted-Rand / VoI from the merged overlap table
    (reference measures.py:27)."""

    task_name = "measures"

    def run_impl(self) -> None:
        with np.load(os.path.join(self.tmp_folder, OVERLAPS_MERGED_NAME)) as f:
            ia, ib, counts = f["ids_a"], f["ids_b"], f["counts"]
        # ignore gt label 0 (unlabeled), the reference convention
        keep = ib != 0
        ia, ib, counts = ia[keep], ib[keep], counts[keep]
        out = rand_scores(ia, ib, counts)
        out.update(vi_scores(ia, ib, counts))
        path = os.path.join(self.tmp_folder, MEASURES_NAME)
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        self.log(f"measures: {out}")


def load_measures(tmp_folder: str) -> Dict[str, float]:
    with open(os.path.join(tmp_folder, MEASURES_NAME)) as f:
        return json.load(f)


class ObjectViTask(VolumeSimpleTask):
    """Per-ground-truth-object VI scores from the merged overlap table
    (reference object_vi.py:26)."""

    task_name = "object_vi"

    def run_impl(self) -> None:
        with np.load(os.path.join(self.tmp_folder, OVERLAPS_MERGED_NAME)) as f:
            ia, ib, counts = f["ids_a"], f["ids_b"], f["counts"]
        keep = ib != 0
        scores = object_vi_from_contingency(ia[keep], ib[keep], counts[keep])
        path = os.path.join(self.tmp_folder, OBJECT_VI_NAME)
        with open(path, "w") as f:
            json.dump(
                {int(k): [float(v[0]), float(v[1])] for k, v in scores.items()},
                f, indent=2,
            )
        self.log(f"object VI scores for {len(scores)} gt objects")


def load_object_vi(tmp_folder: str) -> Dict[int, Any]:
    with open(os.path.join(tmp_folder, OBJECT_VI_NAME)) as f:
        return {int(k): v for k, v in json.load(f).items()}
