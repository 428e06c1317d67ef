"""Segmentation evaluation on sparse contingency tables: Rand index,
adapted Rand error and variation of information, per-object VI, and the
partition bookkeeping of the node-label tasks (port of
``cluster_tools_tpu/ops/evaluation.py``; reference evaluation/measures.py:
90-158).  Host numpy, as in the JAX package.  Every metric takes the sparse
table (ids_a, ids_b, counts), so per-block tables merged by summation give
the volume's scores.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .segment import contingency_table


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


def _marginals(ids_a, ids_b, counts):
    """Vectorized marginal sums (contingency tables can have millions of rows)."""
    ua, inv_a = np.unique(ids_a, return_inverse=True)
    ub, inv_b = np.unique(ids_b, return_inverse=True)
    a_sum = np.bincount(inv_a, weights=counts, minlength=ua.size)
    b_sum = np.bincount(inv_b, weights=counts, minlength=ub.size)
    return a_sum.astype(np.float64), b_sum.astype(np.float64)


def rand_scores(
    ids_a: np.ndarray, ids_b: np.ndarray, counts: np.ndarray
) -> Dict[str, float]:
    """Rand index, precision/recall over pairs, adapted Rand error.

    a = segmentation, b = ground truth (reference measures.py convention).
    """
    counts = counts.astype(np.float64)
    n = counts.sum()
    sum_ab = (counts**2).sum()
    sum_a, sum_b = _marginals(ids_a, ids_b, counts)
    sum_a2 = (sum_a**2).sum()
    sum_b2 = (sum_b**2).sum()

    # pair counts
    pairs_joint = (sum_ab - n) / 2.0
    pairs_a = (sum_a2 - n) / 2.0
    pairs_b = (sum_b2 - n) / 2.0
    total = n * (n - 1) / 2.0

    precision = pairs_joint / pairs_a if pairs_a > 0 else 1.0
    recall = pairs_joint / pairs_b if pairs_b > 0 else 1.0
    f_score = (
        2.0 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    # Rand index over all pairs
    agree = pairs_joint + (total - pairs_a - pairs_b + pairs_joint)
    rand_index = agree / total if total > 0 else 1.0
    return {
        "rand_index": float(rand_index),
        "rand_precision": float(precision),
        "rand_recall": float(recall),
        "adapted_rand_error": float(1.0 - f_score),
    }


def vi_scores(
    ids_a: np.ndarray, ids_b: np.ndarray, counts: np.ndarray
) -> Dict[str, float]:
    """Variation of information: split (H(A|B)) and merge (H(B|A)) terms.

    vi-split penalizes over-segmentation of a w.r.t. b; vi-merge penalizes
    merges (reference measures.py:154-156 conventions: a = seg, b = gt →
    vi-split = H(seg|gt), vi-merge = H(gt|seg)).
    """
    counts = counts.astype(np.float64)
    n = counts.sum()
    p = counts / n
    sum_a, sum_b = _marginals(ids_a, ids_b, counts)
    pa = sum_a / n
    pb = sum_b / n
    h_ab = -(p * np.log(p)).sum() if p.size else 0.0  # joint entropy
    h_a = -(pa * np.log(pa)).sum() if pa.size else 0.0
    h_b = -(pb * np.log(pb)).sum() if pb.size else 0.0
    return {
        "vi_split": float(h_ab - h_b),  # H(A|B)
        "vi_merge": float(h_ab - h_a),  # H(B|A)
        "vi": float(2 * h_ab - h_a - h_b),
    }


def evaluate_segmentation(
    seg: np.ndarray, gt: np.ndarray, ignore_gt_zero: bool = True
) -> Dict[str, float]:
    """Single-volume convenience wrapper: full metric dict."""
    ia, ib, counts = contingency_table(seg, gt)
    if ignore_gt_zero:
        keep = ib != 0
        ia, ib, counts = ia[keep], ib[keep], counts[keep]
    out = rand_scores(ia, ib, counts)
    out.update(vi_scores(ia, ib, counts))
    return out


def object_vi(
    seg: np.ndarray, gt: np.ndarray, ignore_gt_zero: bool = True
) -> Dict[int, Tuple[float, float]]:
    """Per-ground-truth-object (vi_split, vi_merge) scores
    (reference object_vi.py:26 via elf)."""
    ia, ib, counts = contingency_table(seg, gt)
    if ignore_gt_zero:
        keep = ib != 0
        ia, ib, counts = ia[keep], ib[keep], counts[keep]
    return object_vi_from_contingency(ia, ib, counts)


def object_vi_from_contingency(
    ia: np.ndarray, ib: np.ndarray, counts: np.ndarray
) -> Dict[int, Tuple[float, float]]:
    """Per-gt-object VI from a merged (seg id, gt id, count) table — the
    distributed path (reference object_vi.py:100-118)."""
    counts = counts.astype(np.float64)
    # seg marginals (global)
    seg_sizes: Dict[int, float] = {}
    for a, c in zip(ia, counts):
        seg_sizes[int(a)] = seg_sizes.get(int(a), 0.0) + c
    scores: Dict[int, Tuple[float, float]] = {}
    for b in np.unique(ib):
        sel = ib == b
        c = counts[sel]
        size_b = c.sum()
        p = c / size_b
        # split: entropy of seg labels within this gt object
        split = float(-(p * np.log(p)).sum())
        # merge: how much of each intersecting seg segment lies outside b
        merge = 0.0
        for a, cc in zip(ia[sel], c):
            frac = cc / seg_sizes[int(a)]
            if frac < 1.0:
                merge -= (cc / size_b) * np.log(frac)
        scores[int(b)] = (split, float(merge))
    return scores


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
