"""Segment reductions (port of ``cluster_tools_tpu/ops/segment.py``: the
per-segment count, sum, mean, min and max, and ``contingency_table``).

The reductions run on the tensors' device over flat int64 labels in
``[0, num_segments)``: counts by ``torch.bincount`` and minima and maxima by
``scatter_reduce`` (exact whatever the order), sums by ``index_add_`` in
float32 as the JAX package's ``segment_sum`` — on the card its order is not
fixed, so sums and means hold a float32 tolerance, not bits.  Empty segments
give 0 (count, sum, mean), +inf (min) and -inf (max), as in JAX.  The
contingency table is host numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import count_on_card


def segment_count(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    count_on_card(segment_count, labels)
    return torch.bincount(labels.reshape(-1), minlength=num_segments)[:num_segments]


def segment_sum(labels: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    count_on_card(segment_sum, labels)
    vals = values.reshape(-1)
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, labels.reshape(-1), vals)


def segment_mean(labels: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(labels, values, num_segments)
    c = segment_count(labels, num_segments)
    return s / torch.clamp(c, min=1).to(s.dtype)


def _segment_extreme(labels, values, num_segments: int, reduce: str, fill: float):
    vals = values.reshape(-1)
    out = torch.full((num_segments,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, labels.reshape(-1), vals, reduce, include_self=False)


def segment_min(labels: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    count_on_card(segment_min, labels)
    return _segment_extreme(labels, values, num_segments, "amin", float("inf"))


def segment_max(labels: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    count_on_card(segment_max, labels)
    return _segment_extreme(labels, values, num_segments, "amax", float("-inf"))


for _fn in (segment_count, segment_sum, segment_min, segment_max):
    _fn.launches = 0


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
