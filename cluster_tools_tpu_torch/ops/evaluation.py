"""Partition bookkeeping on sparse contingency tables (port of the part of
``cluster_tools_tpu/ops/evaluation.py`` that the node-label tasks use:
``merge_contingency_tables`` and ``same_partition``).  Host numpy, as in the
JAX package; the Rand and VoI metrics follow with the evaluation workflows.
"""

from __future__ import annotations

import numpy as np


def merge_contingency_tables(tables):
    """Sum sparse (ids_a, ids_b, counts) tables from several blocks."""
    ia = np.concatenate([t[0] for t in tables])
    ib = np.concatenate([t[1] for t in tables])
    c = np.concatenate([t[2] for t in tables])
    pairs = np.stack([ia, ib], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    counts = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(counts, inv.reshape(-1), c)
    return uniq[:, 0], uniq[:, 1], counts


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two label volumes induce the same partition of the
    foreground (ids may differ; the grouping and the foreground mask must
    not): the distinct co-occurring (a, b) pairs are as many as the distinct
    ids on each side."""
    if a.shape != b.shape:
        return False
    if not ((a > 0) == (b > 0)).all():
        return False
    fg = b > 0
    if not fg.any():
        return True
    pairs = np.unique(np.stack([a[fg], b[fg]], axis=1), axis=0)
    return len(pairs) == len(np.unique(a[fg])) == len(np.unique(b[fg]))
