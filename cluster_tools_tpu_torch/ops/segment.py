"""Segment overlaps on the host (port of ``contingency_table`` from
``cluster_tools_tpu/ops/segment.py``, the part that stitching needs)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def contingency_table(
    seg_a: np.ndarray, seg_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse contingency table between two labelings of the same voxels:
    (ids_a, ids_b, counts) for every co-occurring label pair, in the
    lexicographic order of the pairs — the basis of overlap votes and
    Rand/VoI.

    Non-negative integer labels whose pairs fit one int64 key ``a * (max(b)
    + 1) + b`` are counted by a 1d unique of that key (same rows, order and
    dtypes as the row unique, and numpy's 1d sort runs outside the
    interpreter lock, so stitching threads overlap); other inputs take
    ``np.unique(axis=0)`` of the stacked pairs."""
    a = np.asarray(seg_a).reshape(-1)
    b = np.asarray(seg_b).reshape(-1)
    dtype = np.result_type(a, b)
    if a.size and dtype.kind in "iu" and min(int(a.min()), int(b.min())) >= 0:
        base = int(b.max()) + 1
        if int(a.max()) < (np.iinfo(np.int64).max - base) // base:
            key = a.astype(np.int64) * base + b.astype(np.int64)
            uniq, counts = np.unique(key, return_counts=True)
            ua, ub = np.divmod(uniq, base)
            return ua.astype(dtype), ub.astype(dtype), counts
    pairs = np.stack([a, b], axis=1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    return uniq[:, 0], uniq[:, 1], counts
