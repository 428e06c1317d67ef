"""Edge probabilities → multicut costs (port of
``cluster_tools_tpu/tasks/costs.py``; reference costs/probs_to_costs.py:22).

The probabilities are the mean boundary response of each edge (feature
column 0), or a random forest's predictions from a ``.npy`` file
(``probs_path``), which both packages read the same way.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

import numpy as np

from ..ops.multicut import (
    NODE_LABEL_MODES,
    apply_node_label_costs,
    transform_probabilities_to_costs,
)
from ..utils import store
from .base import VolumeSimpleTask
from .features import FEATURES_KEY

COSTS_NAME = "costs.npy"


def _load_node_label_array(path: str, key=None) -> np.ndarray:
    """Per-node label table from a .npy file or a chunked-store dataset."""
    if path.endswith(".npy"):
        return np.load(path)
    if key is None:
        raise ValueError(
            f"node-label source {path!r} is not a .npy file — chunked-store "
            "sources must be given as a (path, key) pair"
        )
    with store.file_reader(path, "r") as f:
        return f[key][:]


class ProbsToCostsTask(VolumeSimpleTask):
    """Log-odds cost transform with optional node-label overrides.

    ``node_label_dict`` maps an override mode (``ignore`` / ``isolate`` /
    ``ignore_transition``, reference probs_to_costs.py:25-31) to the location
    of a per-node label table: either a ``.npy`` path or ``(path, key)`` into
    a chunked store. Overrides are applied after the cost transform with
    maximally repulsive = 5×min(cost), maximally attractive = 5×max(cost)
    (reference probs_to_costs.py:216-235).
    """

    task_name = "probs_to_costs"

    def __init__(self, *args, **params):
        super().__init__(*args, **params)
        bad = [
            m for m in (getattr(self, "node_label_dict", None) or {})
            if m not in NODE_LABEL_MODES
        ]
        if bad:
            raise ValueError(
                f"invalid node-label modes {bad}, pick from {NODE_LABEL_MODES}"
            )

    @property
    def identifier(self) -> str:
        # RF-probability / node-label-override runs must not be satisfied by
        # a completed plain run in the same tmp_folder — and two override
        # runs with different dicts must not satisfy each other, so the
        # suffix hashes the dict contents
        name = self.task_name
        if getattr(self, "probs_path", None):
            name += "_rf"
        nld = getattr(self, "node_label_dict", None)
        if nld:
            digest = hashlib.sha1(
                json.dumps(
                    {k: list(v) if not isinstance(v, str) else v
                     for k, v in sorted(nld.items())}
                ).encode()
            ).hexdigest()[:10]
            name += f"_nl{digest}"
        return name

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {
                "beta": 0.5,
                "weight_edges": False,
                "weighting_exponent": 1.0,
                "invert_inputs": False,
            }
        )
        return conf

    def run_impl(self) -> None:
        conf = self.get_task_config()
        feats = self.tmp_store()[FEATURES_KEY][:]
        # probabilities: RF predictions when present (costs/predict.py path in
        # the reference EdgeCostsWorkflow), else the mean boundary response
        probs_path = getattr(self, "probs_path", None)
        if probs_path:
            probs = np.load(probs_path)
            if probs.size != feats.shape[0]:
                raise ValueError(
                    f"{probs.size} probabilities vs {feats.shape[0]} edges"
                )
        else:
            probs = feats[:, 0]
        if conf.get("invert_inputs", False):
            probs = 1.0 - probs
        # count is always the LAST column (10-col default layout or the
        # filter bank's 9*G+1 layout — tasks/features.py)
        sizes = feats[:, -1] if conf["weight_edges"] else None
        costs = transform_probabilities_to_costs(
            probs,
            beta=float(conf.get("beta", 0.5)),
            edge_sizes=sizes,
            weighting_exponent=float(conf.get("weighting_exponent", 1.0)),
        )
        node_label_dict = getattr(self, "node_label_dict", None) or {}
        if node_label_dict:
            from .graph import load_graph

            nodes, edges = load_graph(self.tmp_store())
            # bounds fixed once, before any override moves them
            # (reference probs_to_costs.py:219-220).  The reference's bare
            # 5*min / 5*max silently inverts when all costs share a sign
            # (e.g. min > 0 makes "maximally repulsive" attractive) — guard
            # with a magnitude-based bound in the degenerate case.
            scale = 5.0 * max(float(np.abs(costs).max()), 1e-6)
            cmin, cmax = float(costs.min()), float(costs.max())
            max_repulsive = 5.0 * cmin if cmin < 0 else -scale
            max_attractive = 5.0 * cmax if cmax > 0 else scale
            # edges are dense node indices; label tables are indexed by
            # original fragment id
            frag_uv = nodes[edges]
            max_frag_id = int(nodes.max())
            # sorted: application order must match the sorted-items
            # identifier hash, or dicts differing only in insertion order
            # would share a done-marker while behaving differently
            for mode, where in sorted(node_label_dict.items()):
                if isinstance(where, str):
                    labels = _load_node_label_array(where)
                else:
                    labels = _load_node_label_array(*where)
                if labels.size <= max_frag_id:
                    raise ValueError(
                        f"node-label table from {where} has {labels.size} "
                        f"entries but must be indexable by the max fragment "
                        f"id {max_frag_id} (mode={mode})"
                    )
                costs = apply_node_label_costs(
                    costs, labels[frag_uv], mode, max_repulsive, max_attractive
                )
                self.log(f"applied node-label override mode={mode}")
        np.save(os.path.join(self.tmp_folder, COSTS_NAME), costs)
        self.log(f"computed {costs.size} edge costs (beta={conf.get('beta')})")
